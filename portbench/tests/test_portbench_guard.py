"""The import guard compares the top-level module name whole: the port
``adunet_torch`` passes, the JAX package ``adunet`` and the JAX stack do
not; a run's imports load none of them; and only ``program.py`` and the
model modules import the program."""

from __future__ import annotations

import ast
import subprocess
import sys

from portbench import catalog
from portbench.lib import guard


def test_top_level_names_compared_whole():
    names = ["adunet_torch", "adunet_torch.kernels.conv64", "adunetx", "jaxtyping", "flaxen",
             "adunet", "adunet.models.sr_adaptive", "jax", "jax.numpy", "jaxlib.xla_client",
             "flax.linen", "optax"]
    assert guard.forbidden(names) == ["adunet", "adunet.models.sr_adaptive", "flax.linen", "jax",
                                      "jax.numpy", "jaxlib.xla_client", "optax"]


def test_a_run_loads_no_jax():
    code = ("import portbench.run, portbench.train_cell, portbench.serve_cell, portbench.clients, "
            "portbench.calibrate, portbench.probe_kernels, portbench.sweep, "
            "portbench.models.adaptive_sr_unet\n"
            "import adunet_torch.train, adunet_torch.export, adunet_torch.cli.serve, "
            "adunet_torch.models, adunet_torch.losses\n"
            "from portbench.lib import guard\n"
            "print(','.join(guard.loaded_forbidden()))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=catalog.ROOT, capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip() == ""


def test_only_program_and_model_modules_import_the_program():
    importers = set()
    for path in catalog.HERE.rglob("*.py"):
        rel = path.relative_to(catalog.HERE)
        if rel.parts[0] == "tests":
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            if any(n.split(".", 1)[0] == "adunet_torch" for n in names):
                importers.add(rel.as_posix())
    assert "program.py" in importers and "models/adaptive_sr_unet.py" in importers
    assert [p for p in importers if p != "program.py" and not p.startswith("models/")] == []
