"""The benchmark of ``adunet_torch``, the PyTorch and CUDA port: one run of
one cell (a model configuration under a traffic mix) on the card, its
end-to-end metrics (``--trace 0``) or its per-layer metrics (``--trace 1``),
and a comparison of what the timed path produced with a plain reference.

Run from the checkout's root:
``python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>``.
Every configuration, model, driver, traffic mix, per-layer metric and limit
lives in a file of its own (``configs/``, ``models/``, ``<driver>_cell.py``,
``traffic/``, ``metrics/``, ``limits/``), found by the name
``BENCHMARK.json`` or a configuration gives it (``catalog.py``)."""
