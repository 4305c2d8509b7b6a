"""Metrics/evaluators (counterpart of ``robustart_tpu.metrics``): every
evaluator, the calibration tools and the offline CLI
(``python -m robustart_torch.metrics``)."""

from robustart_torch.metrics import calibration as calibration_tools
from robustart_torch.metrics.base import Evaluator, Metric
from robustart_torch.metrics.evaluators import (
    ALEXNET_ERR,
    AdvRobustEvaluator,
    ClsMetric,
    ImageNetAEvaluator,
    ImageNetCEvaluator,
    ImageNetEvaluator,
    ImageNetOEvaluator,
    ImageNetPEvaluator,
    ImageNetSEvaluator,
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
    "ImageNetAEvaluator",
    "ImageNetOEvaluator",
    "ImageNetPEvaluator",
    "ImageNetSEvaluator",
    "AdvRobustEvaluator",
    "WorstCaseAdvRobustEvaluator",
    "calibration_tools",
    "topk_accuracy",
    "mean_corruption_error",
    "ALEXNET_ERR",
]
