"""Evaluation helpers."""

from adunet_torch.evaluate.evaluator import infer_eval_shave

__all__ = ["infer_eval_shave"]
