"""Command-line entry points of the port.

- ``python -m adunet_torch.cli.serve``             ← ``adunet/cli/serve.py``
- ``python -m adunet_torch.cli.train_sr``          ← ``adunet/cli/train_sr.py``
- ``python -m adunet_torch.cli.train_seg``         ← ``adunet/cli/train_seg.py``
- ``python -m adunet_torch.cli.train_seg_vanilla`` ← ``adunet/cli/train_seg_vanilla.py``
"""
