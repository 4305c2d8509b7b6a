"""Evaluators over JSON-lines result files (counterpart of
``robustart_tpu/metrics/evaluators.py``):

- ``topk_accuracy``       — top-k accuracy in percent
- ``ImageNetEvaluator``   — top-1/top-5 from {'score','label'} lines
- ``ImageNetCEvaluator``  — idem, and writes a ``metric`` JSON beside the file
- ``ImageNetAEvaluator``  — top-1 on ImageNet-A result files
- ``ImageNetOEvaluator``  — OOD AUPR from in/out confidence files
- ``ImageNetPEvaluator``  — flip probability over perturbation videos, mFR
- ``ImageNetSEvaluator``  — top-1 per (decoder, resize) combination, mean/std
- ``mean_corruption_error`` — mCE, AlexNet-normalized
- ``AdvRobustEvaluator``  — AR: correct after attack / correct before, in
  percent, from {'prediction','label'} lines
- ``WorstCaseAdvRobustEvaluator`` — WCAR: correct under every attack file

Each has the hooks of the offline CLI (``add_subparser``, ``from_args``,
``run_from_args``; ``python -m robustart_torch.metrics``).
"""

from __future__ import annotations

import json

import numpy as np

from robustart_torch.metrics import calibration as calibration_tools
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


class ImageNetAEvaluator(Evaluator):
    """Accuracy on the ImageNet-A naturally-adversarial subset (the
    reference's body copies the -P flip loop; like the JAX package, this
    computes the documented accuracy)."""

    def __init__(self, topk=(1,)):
        self.topk = tuple(topk)
        self.metric = Metric()

    def eval(self, res_file, perturbation=None) -> dict:
        res = load_res_columns(res_file)
        acc = topk_accuracy(res["score"], res["label"], self.topk)
        result = {f"top{k}": acc[f"top{k}"] for k in self.topk}
        self.metric.update(result)
        return result

    def get_mean(self) -> dict:
        vals = list(self.metric.metric.values())
        mean = float(np.mean(vals)) if vals else 0.0
        self.metric.update({"Mean": mean})
        self.metric.set_cmp_key("Mean")
        return {"Mean": mean}

    def clear(self):
        self.metric.metric = {}

    def run_from_args(self, args) -> dict:
        out = {}
        for res_file in args.res_file or []:
            out[res_file] = self.eval(res_file)
        out.update(self.get_mean())
        return out


class ImageNetOEvaluator(Evaluator):
    """OOD detection AUPR from in-dist/out-dist confidence dumps (reference
    imageneto_evaluator.py:27-63). Result lines carry {'confidence': [...],
    'correct': [...], 'num_correct': n}."""

    def __init__(self):
        self.metric = Metric()

    @staticmethod
    def _gather(res_file):
        confidence, correct, num_correct = [], [], 0
        with open(res_file) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                obj = json.loads(line)
                confidence += obj["confidence"]
                correct += obj["correct"]
                num_correct += obj["num_correct"]
        return confidence, correct, num_correct

    def eval(self, res_file_in=None, res_file_out=None) -> dict:
        if res_file_in is None or res_file_out is None:
            raise ValueError("ImageNetOEvaluator needs an in-dist and an out-dist file")
        confidence_in, _, _ = self._gather(res_file_in)
        confidence_out, _, _ = self._gather(res_file_out)

        in_score = -np.array(confidence_in)
        out_score = -np.array(confidence_out)
        # out-dist scores are the positive class
        _, aupr, _ = calibration_tools.get_measures(out_score, in_score)
        result = {"AUPR": 100 * aupr}
        self.metric.update(result)
        return result

    def clear(self):
        self.metric.metric = {}

    @staticmethod
    def add_subparser(name, subparsers):
        subparser = Evaluator.add_subparser(name, subparsers)
        subparser.add_argument(
            "--res_file_in", default=None,
            help="in-distribution confidence result file",
        )
        subparser.add_argument(
            "--res_file_out", default=None,
            help="out-of-distribution confidence result file",
        )
        return subparser

    def run_from_args(self, args) -> dict:
        res_in = args.res_file_in
        res_out = args.res_file_out
        if res_in is None or res_out is None:
            # the reference's vocabulary: two --res_file entries, in then out
            res_in, res_out = (args.res_file or [None, None])[:2]
        return self.eval(res_file_in=res_in, res_file_out=res_out)


class ImageNetPEvaluator(Evaluator):
    """Flip rate over perturbation videos (reference
    imagenetp_evaluator.py:27-54). Result lines: {'predictions': [...]}.
    A noise perturbation compares every frame with the first, any other
    each frame with the one before."""

    def __init__(self):
        self.metric = Metric()

    def load_res(self, res_file):
        preds = []
        with open(res_file) as f:
            for line in f:
                line = line.strip()
                if line:
                    preds.append(np.array(json.loads(line)["predictions"]))
        return preds

    def eval(self, res_file, perturbation=None) -> dict:
        predictions = self.load_res(res_file)
        noise_perturbation = "noise" in (perturbation or "")
        result = 0.0
        step_size = 1
        for vid_preds in predictions:
            flips = []
            for i in range(step_size):
                prev = vid_preds[i]
                for pred in vid_preds[i::step_size][1:]:
                    flips.append(int(prev != pred))
                    if not noise_perturbation:
                        prev = pred
            result += np.mean(flips) / len(predictions)
        result_dict = {perturbation: float(result)}
        self.metric.update(result_dict)
        return result_dict

    def get_mean(self) -> dict:
        vals = list(self.metric.metric.values())
        return {"Mean": float(np.mean(vals)) if vals else 0.0}

    def clear(self):
        self.metric.metric = {}

    @staticmethod
    def add_subparser(name, subparsers):
        subparser = Evaluator.add_subparser(name, subparsers)
        subparser.add_argument(
            "--perturbation", action="append", default=None,
            help="perturbation name per --res_file (paired by order)",
        )
        return subparser

    def run_from_args(self, args) -> dict:
        perts = args.perturbation or [None] * len(args.res_file or [])
        out = {}
        for res_file, pert in zip(args.res_file or [], perts):
            out.update(self.eval(res_file, perturbation=pert or res_file))
        out.update(self.get_mean())
        return out


class ImageNetSEvaluator(Evaluator):
    """Top-1 per (decoder, resize) combination; stability is the mean and
    std across combinations (reference imagenets_evaluator.py:30-63, keyed
    by the tuple the reference meant where it keys by a list)."""

    def __init__(self):
        self.metric = Metric()

    def eval(self, res_file, decoder_type="pil", resize_type="pil-bilinear") -> dict:
        res = load_res_columns(res_file)
        acc = topk_accuracy(res["score"], res["label"], (1,))["top1"]
        result = {(decoder_type, resize_type): acc}
        self.metric.update(result)
        return result

    def get_mean(self) -> dict:
        vals = list(self.metric.metric.values())
        return {"Mean": float(np.mean(vals)) if vals else 0.0}

    def get_std(self) -> dict:
        vals = list(self.metric.metric.values())
        return {"Std.": float(np.std(vals)) if vals else 0.0}

    def clear(self):
        self.metric.metric = {}

    @staticmethod
    def add_subparser(name, subparsers):
        subparser = Evaluator.add_subparser(name, subparsers)
        subparser.add_argument(
            "--decoder_type", action="append", default=None,
            help="decoder per --res_file (paired by order)",
        )
        subparser.add_argument(
            "--resize_type", action="append", default=None,
            help="resize mode per --res_file (paired by order)",
        )
        return subparser

    def run_from_args(self, args) -> dict:
        files = args.res_file or []
        decs = args.decoder_type or ["pil"] * len(files)
        sizes = args.resize_type or ["pil-bilinear"] * len(files)
        out = {}
        for res_file, dec, rez in zip(files, decs, sizes):
            res = self.eval(res_file, decoder_type=dec, resize_type=rez)
            out.update({f"{d}/{r}": acc for (d, r), acc in res.items()})
        out.update(self.get_mean())
        out.update(self.get_std())
        return out


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


def _parse_line(line: str) -> tuple[str, str]:
    """Char-level result-line parser (reference AR_evaluator.py:13-21): the
    first two ':'-delimited values of a JSON-ish line."""
    res = []
    for i in range(len(line)):
        if line[i] == ":":
            for j in range(i + 2, len(line)):
                if line[j] == "," or line[j] == "}":
                    res.append(line[i + 2:j])
                    break
    return res[0], res[1]


class AdvRobustEvaluator(Evaluator):
    """AR: correct-after-attack / correct-before-attack, in percent
    (reference AR_evaluator.py:23-39). As in the JAX package, a run with no
    correct clean prediction divides by zero."""

    parse_line = staticmethod(_parse_line)

    def eval(self, clean_path, adv_path, num_samples: int | None = None) -> float:
        with open(adv_path) as f_att, open(clean_path) as f_clean:
            lines_att = f_att.readlines()
            lines_clean = f_clean.readlines()
        n = num_samples if num_samples is not None else len(lines_clean)
        cnt_before = cnt_after = 0
        for ind in range(n):
            res1_clean, res2_clean = _parse_line(lines_clean[ind])
            res1_att, res2_att = _parse_line(lines_att[ind])
            if res1_clean == res2_clean:
                cnt_before += 1
                if res1_att == res2_att:
                    cnt_after += 1
        ar = cnt_after / cnt_before * 100
        print("Clean Acc: {}, Adversarial Robustness: {}".format(cnt_before / n * 100, ar))
        return ar

    @staticmethod
    def add_subparser(name, subparsers):
        subparser = Evaluator.add_subparser(name, subparsers)
        subparser.add_argument(
            "--clean_path", default=None, help="clean result file"
        )
        subparser.add_argument(
            "--adv_path", action="append", default=None,
            help="attacked result file",
        )
        subparser.add_argument(
            "--num_samples", type=int, default=None,
            help="limit the number of result lines compared",
        )
        return subparser

    def run_from_args(self, args) -> dict:
        adv = (args.adv_path or [None])[0]
        return {"AR": self.eval(args.clean_path, adv, num_samples=args.num_samples)}


class WorstCaseAdvRobustEvaluator(Evaluator):
    """WCAR: a sample counts only if it is correct under ALL attack result
    files (reference WCAR_evaluator.py:23-44)."""

    parse_line = staticmethod(_parse_line)

    def eval(self, clean_path, multi_adv_result_paths, num_samples: int | None = None) -> float:
        with open(clean_path) as f:
            lines_clean = f.readlines()
        n = num_samples if num_samples is not None else len(lines_clean)
        all_att_lines = []
        for path in multi_adv_result_paths:
            with open(path) as f:
                all_att_lines.append(f.readlines())
        cnt_before = cnt_after = 0
        for ind in range(n):
            res1_clean, res2_clean = _parse_line(lines_clean[ind])
            if res1_clean == res2_clean:
                cnt_before += 1
                if all(_parse_line(lines[ind])[0] == _parse_line(lines[ind])[1]
                       for lines in all_att_lines):
                    cnt_after += 1
        wcar = cnt_after / cnt_before * 100
        print("Worst-Case Adversarial Robustness: {}".format(wcar))
        return wcar

    add_subparser = staticmethod(AdvRobustEvaluator.add_subparser)

    def run_from_args(self, args) -> dict:
        return {"WCAR": self.eval(args.clean_path, args.adv_path or [],
                                  num_samples=args.num_samples)}
