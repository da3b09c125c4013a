"""Evaluation: the grid-tiled Y-channel SR evaluator."""

from adunet_torch.evaluate.evaluator import EvalResults, evaluate_sr, infer_eval_shave

__all__ = ["EvalResults", "evaluate_sr", "infer_eval_shave"]
