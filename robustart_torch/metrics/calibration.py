"""Calibration and OOD measurement tools (counterpart of
``robustart_tpu/metrics/calibration.py``), in numpy alone.

The JAX package takes AUROC and AUPR from ``sklearn.metrics``; here
:func:`roc_auc_score` and :func:`average_precision_score` compute them with
sklearn's semantics, ties included:

- both rank the scores in decreasing order (a stable sort) and cut only
  between distinct scores, so tied samples enter a curve together;
- AUROC is the trapezoid under the ROC points from (0, 0), after the points
  collinear with their neighbours are dropped (sklearn's
  ``drop_intermediate``, which moves the area by rounding at most);
- AP is Σ (Rₙ − Rₙ₋₁)·Pₙ over those cuts, recall decreasing from the
  highest threshold, clipped at 0 as sklearn clips a ``-0.0``.

The rest is the JAX package's code: binned RMS/MAD calibration error,
AURRA, soft-F1, temperature tuning by bisection, FPR at a recall level and
``get_measures``.
"""

from __future__ import annotations

import numpy as np

recall_level_default = 0.95


def stable_cumsum(arr, rtol=1e-05, atol=1e-08):
    out = np.cumsum(arr, dtype=np.float64)
    expected = np.sum(arr, dtype=np.float64)
    if not np.allclose(out[-1], expected, rtol=rtol, atol=atol):
        raise RuntimeError(
            "cumsum was found to be unstable: its last element does not "
            "correspond to sum"
        )
    return out


def binary_clf_curve(y_true, y_score):
    """(fps, tps, thresholds) at each distinct score, highest first:
    the false and true positives among the samples scored at or above it."""
    y_true = np.asarray(y_true).reshape(-1) == 1
    y_score = np.asarray(y_score).reshape(-1)
    desc = np.argsort(y_score, kind="mergesort")[::-1]
    y_score = y_score[desc]
    y_true = y_true[desc]
    distinct = np.where(np.diff(y_score))[0]
    threshold_idxs = np.r_[distinct, y_true.size - 1]
    tps = stable_cumsum(y_true)[threshold_idxs]
    fps = 1 + threshold_idxs - tps
    return fps, tps, y_score[threshold_idxs]


def _check_binary(y_true) -> None:
    classes = np.unique(np.asarray(y_true))
    if len(classes) != 2 or 1 not in classes:
        raise ValueError(f"y_true must hold two classes, 1 the positive one; got {classes}")


def roc_auc_score(y_true, y_score) -> float:
    """Area under the ROC curve of binary labels (1 positive), as
    ``sklearn.metrics.roc_auc_score``."""
    _check_binary(y_true)
    fps, tps, _ = binary_clf_curve(y_true, y_score)
    if fps.shape[0] > 2:
        keep = np.where(np.r_[True, np.logical_or(np.diff(fps, 2), np.diff(tps, 2)), True])[0]
        fps, tps = fps[keep], tps[keep]
    fpr = np.r_[0.0, fps] / fps[-1]
    tpr = np.r_[0.0, tps] / tps[-1]
    return float((np.diff(fpr) * (tpr[1:] + tpr[:-1]) / 2.0).sum())


def average_precision_score(y_true, y_score) -> float:
    """Average precision of binary labels (1 positive), as
    ``sklearn.metrics.average_precision_score``."""
    _check_binary(y_true)
    fps, tps, _ = binary_clf_curve(y_true, y_score)
    precision = np.r_[(tps / (tps + fps))[::-1], 1.0]
    recall = np.r_[(tps / tps[-1])[::-1], 0.0]
    return float(max(0.0, -np.sum(np.diff(recall) * precision[:-1])))


def calib_err(confidence, correct, p="2", beta=100):
    """Binned calibration error with target bin size ``beta``."""
    confidence = np.asarray(confidence, dtype=np.float64)
    correct = np.asarray(correct, dtype=np.float64)
    idxs = np.argsort(confidence)
    confidence = confidence[idxs]
    correct = correct[idxs]
    bins = [[i * beta, (i + 1) * beta] for i in range(len(confidence) // beta)]
    if not bins:
        return 0.0
    bins[-1] = [bins[-1][0], len(confidence)]

    cerr = 0.0
    total = len(confidence)
    for i in range(len(bins) - 1):
        lo, hi = bins[i]
        bin_conf = confidence[lo:hi]
        bin_corr = correct[lo:hi]
        n = len(bin_conf)
        if n > 0:
            diff = abs(np.nanmean(bin_conf) - np.nanmean(bin_corr))
            if p == "2":
                cerr += n / total * diff**2
            elif p == "1":
                cerr += n / total * diff
            elif p in ("infty", "infinity", "max"):
                cerr = max(cerr, diff)
            else:
                raise AssertionError("p must be '1', '2', or 'infty'")
    if p == "2":
        cerr = float(np.sqrt(cerr))
    return float(cerr)


def aurra(confidence, correct):
    """Area under the response-rate / accuracy curve."""
    conf_ranks = np.argsort(confidence)[::-1]
    rra = np.cumsum(np.asarray(correct)[conf_ranks])
    rra = rra / np.arange(1, len(rra) + 1)
    return float(np.mean(rra))


def soft_f1(confidence, correct):
    confidence = np.asarray(confidence, dtype=np.float64)
    correct = np.asarray(correct, dtype=np.float64)
    wrong = 1 - correct
    return float(
        2 * ((1 - confidence) * wrong).sum() / (1 - confidence + wrong).sum()
    )


def tune_temp(logits, labels, binary_search=True, lower=0.2, upper=5.0, eps=0.0001):
    """Temperature scaling by bisection on d(CE)/dT, the derivative of the
    mean cross-entropy taken by central differences. ``binary_search=False``
    (the reference's convex solver) bisects as well."""
    logits = np.asarray(logits, dtype=np.float64)
    labels = np.asarray(labels, dtype=np.int64)

    def ce(t):
        z = logits / t
        z = z - z.max(axis=1, keepdims=True)
        logp = z - np.log(np.exp(z).sum(axis=1, keepdims=True))
        return -logp[np.arange(len(labels)), labels].mean()

    def dce_dt(t, h=1e-4):
        return (ce(t + h) - ce(t - h)) / (2 * h)

    lo, hi = lower, upper
    while hi - lo > eps:
        mid = 0.5 * (lo + hi)
        if dce_dt(mid) > 0:
            hi = mid
        else:
            lo = mid
    return min([lo, 0.5 * (lo + hi), hi], key=ce)


def fpr_and_fdr_at_recall(y_true, y_score, recall_level=recall_level_default,
                          pos_label=None):
    """FPR at the threshold whose TPR is nearest ``recall_level``."""
    y_true = np.asarray(y_true)
    y_score = np.asarray(y_score)
    classes = np.unique(y_true)
    if pos_label is None and not (
        np.array_equal(classes, [0, 1])
        or np.array_equal(classes, [-1, 1])
        or np.array_equal(classes, [0])
        or np.array_equal(classes, [-1])
        or np.array_equal(classes, [1])
    ):
        raise ValueError("Data is not binary and pos_label is not specified")
    if pos_label is None:
        pos_label = 1.0

    y_true = y_true == pos_label
    desc = np.argsort(y_score, kind="mergesort")[::-1]
    y_score = y_score[desc]
    y_true = y_true[desc]

    distinct = np.where(np.diff(y_score))[0]
    threshold_idxs = np.r_[distinct, y_true.size - 1]

    tps = stable_cumsum(y_true)[threshold_idxs]
    fps = 1 + threshold_idxs - tps

    recall = tps / tps[-1]
    last_ind = tps.searchsorted(tps[-1])
    sl = slice(last_ind, None, -1)
    recall = np.r_[recall[sl], 1]
    fps = np.r_[fps[sl], 0]

    cutoff = np.argmin(np.abs(recall - recall_level))
    return float(fps[cutoff] / np.sum(np.logical_not(y_true)))


def get_measures(_pos, _neg, recall_level=recall_level_default):
    """(AUROC, AUPR, FPR@recall) with ``_pos`` the positive class."""
    pos = np.asarray(_pos).reshape((-1, 1))
    neg = np.asarray(_neg).reshape((-1, 1))
    examples = np.squeeze(np.vstack((pos, neg)))
    labels = np.zeros(len(examples), dtype=np.int32)
    labels[: len(pos)] += 1

    auroc = roc_auc_score(labels, examples)
    aupr = average_precision_score(labels, examples)
    fpr = fpr_and_fdr_at_recall(labels, examples, recall_level)
    return auroc, aupr, fpr


def show_calibration_results(confidence, correct, method_name="Baseline"):
    from robustart_torch.core.logging import get_logger

    logger = get_logger(__name__)
    logger.info("\t\t%s", method_name)
    logger.info("RMS Calib Error (%%): \t\t%.2f",
                100 * calib_err(confidence, correct, p="2"))
    logger.info("AURRA (%%): \t\t\t%.2f", 100 * aurra(confidence, correct))
