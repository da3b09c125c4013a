"""One module a model, named by its configuration's ``"model"`` key: the one
place where the benchmark reaches that model in the program
(``adunet_torch``), beside the plain reference it is held to
(``portbench/reference/``). ``portbench.catalog.model`` finds it; the
recipe for a new one is in ``portbench/catalog.py``."""
