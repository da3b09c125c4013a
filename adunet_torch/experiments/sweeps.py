"""Sweep definitions and run-plan generation.

Port of ``adunet/experiments/sweeps.py``, itself a rebuild of the reference's bash sweep drivers
(/root/reference/Super_resolution/sbatch_scripts/run_experiment_fixed_depth.sh:45-87
and run_experiment_adaptive_depth.sh:47-101): per-scale batch-size and depth
tables, metadata emission, and one job per scale. The reference's seg sweep
scripts were byte-identical copies of the SR ones (SURVEY.md §2.4) — here
segmentation gets a real sweep (protocols x seeds).

The reference batch tables were sized for an 11GB 2080 Ti; they are kept
(``h100_batches=False``, ``run_experiment --reference_batches``), and then the
plans equal the JAX package's argument for argument. By default the batches
come from ``H100_BATCH_SIZES``, measured on one H100 80GB by
``scripts/torch_sweep_batches.py``: for each scale it starts from the JAX
package's v5e batch (``TPU_BATCH_SIZES``, sized for a 16GB chip) and doubles it
only where the bf16 step (remat at depth >= 4, as the plans ask) stays under
64 GB of device memory and gains over 10 % img/s in every configuration the
two sweeps run at that scale (PERF.md).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from datetime import datetime
from pathlib import Path
from typing import Dict, List, Optional, Sequence

__all__ = [
    "EXPERIMENT1_SCALES",
    "EXPERIMENT1_BATCH_SIZES",
    "EXPERIMENT2_DEPTHS",
    "EXPERIMENT2_BATCH_SIZES",
    "H100_BATCH_SIZES",
    "RunPlan",
    "sweep_runs",
    "write_metadata",
]

# Experiment 1 (fixed depth 3) — run_experiment_fixed_depth.sh:45-55
EXPERIMENT1_SCALES = (0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9)
EXPERIMENT1_BATCH_SIZES: Dict[float, int] = {
    0.2: 8, 0.3: 8, 0.4: 8, 0.5: 6, 0.6: 4, 0.7: 2, 0.8: 1, 0.9: 1,
}

# Experiment 2 (adaptive depth, design table) — run_experiment_adaptive_depth.sh:47-65
EXPERIMENT2_DEPTHS: Dict[float, int] = {
    0.2: 1, 0.3: 2, 0.4: 3, 0.5: 3, 0.6: 4, 0.7: 5, 0.8: 5,
}
EXPERIMENT2_BATCH_SIZES: Dict[float, int] = {
    0.2: 8, 0.3: 8, 0.4: 6, 0.5: 4, 0.6: 3, 0.7: 2, 0.8: 1,
}

# H100 80GB sizing (bf16 compute + remat on depth>=4), per process; measured
# by scripts/torch_sweep_batches.py from the v5e table's batches.
H100_BATCH_SIZES: Dict[float, int] = {
    0.2: 64, 0.3: 64, 0.4: 32, 0.5: 32, 0.6: 16, 0.7: 8, 0.8: 8, 0.9: 32,
}


@dataclass
class RunPlan:
    name: str
    argv: List[str]
    metadata: Dict[str, object] = field(default_factory=dict)


def sweep_runs(
    experiment: str,
    *,
    high_res_dir: Optional[str] = None,
    model_dir: str = "runs/models",
    log_dir: str = "runs/logs",
    # None: SR sweeps use the reference default (100); seg sweeps keep each
    # PROTOCOL's epoch budget (A:100, B:200) — a blanket 100 would silently
    # halve protocol B's specified budget
    epochs: Optional[int] = None,
    seed: int = 1234,
    scales: Optional[Sequence[float]] = None,
    h100_batches: bool = True,
    mixed_precision: bool = True,
    extra_args: Optional[Sequence[str]] = None,
    # seg sweep options
    seg_dirs: Optional[Dict[str, str]] = None,
    protocols: Sequence[str] = ("A", "B"),
    seeds: Sequence[int] = (42,),
) -> List[RunPlan]:
    """Build the run plans for an experiment sweep."""
    extra = list(extra_args or [])
    plans: List[RunPlan] = []

    if experiment in ("fixed_depth", "adaptive_depth"):
        if high_res_dir is None:
            raise ValueError("high_res_dir is required for SR sweeps.")
        if scales is not None and len(scales) == 0:
            # `--scales` with no values must not silently expand to the full
            # 8-scale sweep
            raise ValueError("scales was given but empty; omit it for the full sweep.")
        chosen_scales = list(scales if scales is not None else (
            EXPERIMENT1_SCALES if experiment == "fixed_depth" else sorted(EXPERIMENT2_DEPTHS)
        ))
        for scale in chosen_scales:
            if experiment == "fixed_depth":
                depth = 3
                batch = EXPERIMENT1_BATCH_SIZES.get(scale, 4)
            else:
                depth = EXPERIMENT2_DEPTHS.get(scale)
                if depth is None:
                    raise ValueError(f"scale {scale} not in the adaptive design table.")
                batch = EXPERIMENT2_BATCH_SIZES.get(scale, 4)
            if h100_batches:
                batch = H100_BATCH_SIZES.get(scale, batch)
            run_name = f"exp_{experiment}_scale{scale:.2f}_depth{depth}"
            sr_epochs = epochs if epochs else 100  # reference EPOCHS default
            argv = [
                "--scale", f"{scale}",
                "--depth_override", str(depth),
                "--max_depth", str(depth),
                "--batch_size", str(batch),
                "--epochs", str(sr_epochs),
                "--seed", str(seed),
                "--high_res_dir", str(high_res_dir),
                "--model_dir", str(model_dir),
                "--log_dir", str(log_dir),
                "--run_name", run_name,
            ]
            if mixed_precision:
                argv.append("--mixed_precision")
            if depth >= 4:
                argv.append("--remat")
            argv += extra
            plans.append(RunPlan(
                name=run_name,
                argv=argv,
                metadata={
                    "experiment": experiment,
                    "scale": scale,
                    "depth": depth,
                    "batch_size": batch,
                    "epochs": sr_epochs,
                    "seed": seed,
                },
            ))
        return plans

    if experiment == "seg_protocols":
        if not seg_dirs:
            raise ValueError("seg_dirs (train/val image+mask dirs) required for seg sweeps.")
        for protocol in protocols:
            for s in seeds:
                run_name = f"exp_seg_protocol{protocol}_seed{s}"
                argv = [
                    "--protocol", protocol,
                    "--seed", str(s),
                    "--train_images", seg_dirs["train_images"],
                    "--train_masks", seg_dirs["train_masks"],
                    "--val_images", seg_dirs["val_images"],
                    "--val_masks", seg_dirs["val_masks"],
                    "--model_dir", str(model_dir),
                    "--log_dir", str(log_dir),
                    "--run_name", run_name,
                ]
                if epochs:
                    argv += ["--epochs", str(epochs)]
                if mixed_precision:
                    argv.append("--mixed_precision")
                argv += extra
                plans.append(RunPlan(
                    name=run_name,
                    argv=argv,
                    metadata={"experiment": experiment, "protocol": protocol, "seed": s},
                ))
        return plans

    raise ValueError(
        f"Unknown experiment '{experiment}' "
        "(expected fixed_depth | adaptive_depth | seg_protocols)."
    )


def write_metadata(plan: RunPlan, metadata_dir: Path) -> Path:
    """Per-run metadata txt, like run_experiment_*.sh's metadata emission."""
    metadata_dir.mkdir(parents=True, exist_ok=True)
    path = metadata_dir / f"{plan.name}.txt"
    lines = [f"run_name: {plan.name}", f"created_at: {datetime.now().isoformat()}"]
    lines += [f"{k}: {v}" for k, v in plan.metadata.items()]
    lines.append("argv: " + " ".join(plan.argv))
    path.write_text("\n".join(lines) + "\n")
    return path
