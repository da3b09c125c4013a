"""Command-line entry points of the port.

- ``python -m adunet_torch.cli.serve``    ← ``adunet/cli/serve.py``
- ``python -m adunet_torch.cli.train_sr`` ← ``adunet/cli/train_sr.py``
"""
