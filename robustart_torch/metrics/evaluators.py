"""ImageNet / ImageNet-C evaluators over JSON-lines result files
(counterpart of ``robustart_tpu/metrics/evaluators.py``, the subset the
ImageNet-C solver uses):

- ``topk_accuracy``       — top-k accuracy in percent
- ``ImageNetEvaluator``   — top-1/top-5 from {'score','label'} lines
- ``ImageNetCEvaluator``  — idem, and writes a ``metric`` JSON beside the file
- ``mean_corruption_error`` — mCE, AlexNet-normalized
"""

from __future__ import annotations

import json

import numpy as np

from robustart_torch.metrics.base import Evaluator, Metric, load_res_columns


def topk_accuracy(scores, labels, topk=(1, 5)) -> dict[str, float]:
    """Top-k accuracy in percent."""
    scores = np.asarray(scores, dtype=np.float64)
    labels = np.asarray(labels).reshape(-1)
    num = scores.shape[0]
    maxk = max(topk)
    # argsort descending, take top maxk
    pred = np.argsort(-scores, axis=1, kind="stable")[:, :maxk]
    correct = pred == labels[:, None]
    return {
        f"top{k}": float(correct[:, :k].any(axis=1).sum() * 100.0 / num)
        for k in topk
    }


class ClsMetric(Metric):
    """Classification metric."""


class ImageNetEvaluator(Evaluator):
    """Plain top-1/top-5 evaluator over {'score','label'} JSON lines."""

    def __init__(self, topk=(1, 5)):
        self.topk = tuple(topk)

    def eval(self, res_file) -> ClsMetric:
        res = load_res_columns(res_file)
        metric = ClsMetric(topk_accuracy(res["score"], res["label"], self.topk))
        metric.set_cmp_key(f"top{self.topk[0]}")
        return metric


class ImageNetCEvaluator(ImageNetEvaluator):
    """ImageNet-C evaluator: top-1/5 per corruption result file, and writes
    the ``metric`` JSON beside it."""

    def eval(self, res_file) -> ClsMetric:
        metric = super().eval(res_file)
        metric_name = res_file.replace("results.txt.all", "metric")
        if metric_name != res_file:
            with open(metric_name, "w") as f:
                json.dump(metric.metric, f)
        return metric


# ImageNet-C mCE needs AlexNet normalization constants: published per-
# corruption AlexNet top-1 error rates (Hendrycks & Dietterich 2019)
ALEXNET_ERR = {
    "gaussian_noise": 0.886428, "shot_noise": 0.894468,
    "impulse_noise": 0.922640, "defocus_blur": 0.819880,
    "glass_blur": 0.826268, "motion_blur": 0.785948, "zoom_blur": 0.798360,
    "snow": 0.866816, "frost": 0.826572, "fog": 0.819324,
    "brightness": 0.564592, "contrast": 0.853204,
    "elastic_transform": 0.646056, "pixelate": 0.717840,
    "jpeg_compression": 0.606500,
    "speckle_noise": 0.845388, "gaussian_blur": 0.787108,
    "spatter": 0.717512, "saturate": 0.658248,
}


def mean_corruption_error(
    per_corruption_top1: dict[str, float], normalize_alexnet: bool = True
) -> float:
    """mCE over corruptions from mean top-1 accuracies (percent).

    CE_c = err_model_c / err_alexnet_c (Hendrycks protocol); the
    unnormalized variant is the plain mean error.
    """
    ces = []
    for name, top1 in per_corruption_top1.items():
        err = 1.0 - top1 / 100.0
        if normalize_alexnet:
            err = err / ALEXNET_ERR[name]
        ces.append(err)
    return float(np.mean(ces) * 100.0)
