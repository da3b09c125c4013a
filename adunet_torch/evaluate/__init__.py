"""Evaluation: the grid-tiled Y-channel SR evaluator and its report files."""

from adunet_torch.evaluate.evaluator import (
    EvalResults,
    attach_filenames,
    evaluate_sr,
    infer_eval_shave,
    write_outputs,
)

__all__ = ["EvalResults", "evaluate_sr", "infer_eval_shave", "attach_filenames", "write_outputs"]
