"""Experiment sweep drivers (fixed-depth, adaptive-depth, seg protocols)."""

from adunet_torch.experiments.sweeps import (
    EXPERIMENT1_BATCH_SIZES,
    EXPERIMENT1_SCALES,
    EXPERIMENT2_BATCH_SIZES,
    EXPERIMENT2_DEPTHS,
    H100_BATCH_SIZES,
    RunPlan,
    sweep_runs,
    write_metadata,
)

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
