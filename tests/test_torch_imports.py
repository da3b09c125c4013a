"""Import hygiene of the port: ``adunet_torch`` and ``chip_smoke.py`` run on a
GPU host that has no JAX, so they import no ``jax``, ``flax``, ``optax`` or
``adunet`` (not even its JAX-free modules), and import no CUDA toolchain
or GPU at import time."""

import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_BLOCKED = ("jax", "jaxlib", "flax", "optax", "adunet")
# the training slice's modules, named so that the walk below provably covers them
_TRAINING_MODULES = (
    "adunet_torch.train.sr", "adunet_torch.train.loop", "adunet_torch.train.checkpoint",
    "adunet_torch.data.device_cache", "adunet_torch.data.sr_pipeline",
    "adunet_torch.evaluate.evaluator", "adunet_torch.cli.train_sr",
    # the segmentation slice
    "adunet_torch.models.seg_adaptive", "adunet_torch.models.seg_vanilla",
    "adunet_torch.metrics.seg", "adunet_torch.losses.seg", "adunet_torch.data.augment",
    "adunet_torch.data.seg_pipeline", "adunet_torch.train.seg", "adunet_torch.cli.train_seg",
    "adunet_torch.cli.train_seg_vanilla",
    # the SR remainder: streamed feed, paired data, remat, vanilla SR, the
    # combined loss, async checkpoints, reports and the SR entry points
    "adunet_torch.data.patches", "adunet_torch.data.io", "adunet_torch.data.discovery",
    "adunet_torch.data.array_dataset", "adunet_torch.models.sr_adaptive",
    "adunet_torch.models.sr_vanilla", "adunet_torch.losses.perceptual", "adunet_torch.losses.sr",
    "adunet_torch.cli.train_sr_depth3", "adunet_torch.cli.train_sr_vanilla",
    "adunet_torch.cli.evaluate", "adunet_torch.cli.restore",
    # the joint model, its trainer, and the export half
    "adunet_torch.models.joint", "adunet_torch.train.joint", "adunet_torch.cli.train_joint",
    "adunet_torch.export.aot", "adunet_torch.cli.export_model", "adunet_torch.cli.serve",
    # serving programs
    "adunet_torch.export.program", "adunet_torch.kernels.ops",
    # the tuner
    "adunet_torch.tune", "adunet_torch.tune.search", "adunet_torch.tune.parallel",
    "adunet_torch.cli.tune",
    # multi-process training
    "adunet_torch.parallel", "adunet_torch.parallel.distributed", "adunet_torch.parallel.mesh",
    "adunet_torch.parallel.partition", "adunet_torch.parallel.data_parallel",
)
_FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|adunet)(\.|\s|$)", re.MULTILINE
)


def _port_sources():
    return sorted((ROOT / "adunet_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_sources_never_import_the_reference():
    offenders = [
        f"{p.relative_to(ROOT)}: {m.group(0).strip()}"
        for p in _port_sources()
        for m in _FORBIDDEN.finditer(p.read_text())
    ]
    assert not offenders, offenders


def test_every_module_imports_with_jax_and_adunet_blocked():
    code = "\n".join([
        "import importlib, pkgutil, sys",
        f"for name in {_BLOCKED!r}:",
        "    sys.modules[name] = None  # any import of these now raises",
        "import adunet_torch",
        "names = [mod.name for mod in pkgutil.walk_packages(adunet_torch.__path__, 'adunet_torch.')]",
        "for name in names:",
        "    importlib.import_module(name)",
        f"missing = set({_TRAINING_MODULES!r}) - set(names)",
        "assert not missing, missing",
        "import chip_smoke",
        f"leaked = [m for m in sys.modules if m.split('.')[0] in {_BLOCKED!r} and sys.modules[m] is not None]",
        "assert not leaked, leaked",
        "print('ok')",
    ])
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip().endswith("ok"), proc.stderr[-3000:]
