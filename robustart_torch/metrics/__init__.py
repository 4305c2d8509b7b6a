"""Metrics/evaluators (counterpart of ``robustart_tpu.metrics``, the
ImageNet, ImageNet-C and adversarial-robustness subset)."""

from robustart_torch.metrics.base import Evaluator, Metric
from robustart_torch.metrics.evaluators import (
    ALEXNET_ERR,
    AdvRobustEvaluator,
    ClsMetric,
    ImageNetCEvaluator,
    ImageNetEvaluator,
    WorstCaseAdvRobustEvaluator,
    mean_corruption_error,
    topk_accuracy,
)

__all__ = [
    "Evaluator",
    "Metric",
    "ClsMetric",
    "ImageNetEvaluator",
    "ImageNetCEvaluator",
    "AdvRobustEvaluator",
    "WorstCaseAdvRobustEvaluator",
    "topk_accuracy",
    "mean_corruption_error",
    "ALEXNET_ERR",
]
