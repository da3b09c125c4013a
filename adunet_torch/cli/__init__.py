"""Command-line entry points of the port.

- ``python -m adunet_torch.cli.serve``             ← ``adunet/cli/serve.py``
- ``python -m adunet_torch.cli.train_sr``          ← ``adunet/cli/train_sr.py``
- ``python -m adunet_torch.cli.train_seg``         ← ``adunet/cli/train_seg.py``
- ``python -m adunet_torch.cli.train_seg_vanilla`` ← ``adunet/cli/train_seg_vanilla.py``
- ``python -m adunet_torch.cli.run_experiment``    ← ``adunet/cli/run_experiment.py``
- ``python -m adunet_torch.cli.inspect``           ← ``adunet/cli/inspect.py``
- ``export_log_metrics``, ``analyse_experiment_metrics``, ``plot_experiment_metrics``:
  copies of ``adunet/cli``'s (no JAX in them; the port imports nothing of ``adunet``)

and the rest of ``adunet/cli``'s trainers, ``evaluate``, ``restore``,
``export_model`` and ``tune``, each under its own name.
"""
