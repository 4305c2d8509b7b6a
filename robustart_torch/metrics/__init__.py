"""Metrics/evaluators (counterpart of ``robustart_tpu.metrics``, the
ImageNet / ImageNet-C subset)."""

from robustart_torch.metrics.base import Evaluator, Metric
from robustart_torch.metrics.evaluators import (
    ALEXNET_ERR,
    ClsMetric,
    ImageNetCEvaluator,
    ImageNetEvaluator,
    mean_corruption_error,
    topk_accuracy,
)

__all__ = [
    "Evaluator",
    "Metric",
    "ClsMetric",
    "ImageNetEvaluator",
    "ImageNetCEvaluator",
    "topk_accuracy",
    "mean_corruption_error",
    "ALEXNET_ERR",
]
