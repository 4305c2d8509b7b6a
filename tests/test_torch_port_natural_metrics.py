"""The port's calibration tools, natural-noise evaluators and metric CLI
against the JAX package's, on the CPU.

- Every function of ``metrics/calibration.py`` on scores with ties and
  without, within 1e-12: the JAX package takes AUROC and AUPR from
  sklearn, the port computes them in numpy (its ``roc_auc_score`` and
  ``average_precision_score`` also against sklearn's own).
- Every subcommand of ``python -m robustart_torch.metrics`` in process on
  the same result files as ``python -m robustart_tpu.metrics``: the same
  JSON, and the ImageNet-C evaluator's ``metric`` file; the module run as
  a program once.

Numpy only: no JAX program is compiled.
"""

import tests.torch_port_threads  # noqa: F401  (before any torch work)
import json
import logging
import subprocess
import sys

import numpy as np
import pytest
import sklearn.metrics as sk
import yaml

from robustart_torch.metrics import calibration as pcal
from robustart_torch.metrics.__main__ import main as port_main
from robustart_tpu.metrics import calibration as jcal
from robustart_tpu.metrics.__main__ import main as jax_main

TOL = 1e-12


def _scores(ties: bool, n: int = 300, seed: int = 0):
    """Binary labels, scores (rounded to a few levels where ``ties``),
    confidences in (0, 1) and 5-class logits."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 2, n)
    scores = rng.normal(size=n) + labels
    if ties:
        scores = np.round(scores * 2) / 2
    conf = 1 / (1 + np.exp(-scores))
    logits = rng.normal(size=(n, 5)) * 2
    classes = rng.integers(0, 5, n)
    return labels, scores, conf, logits, classes


CASES = {
    "stable_cumsum": lambda m, d: m.stable_cumsum(d[1]),
    "calib_err_p2": lambda m, d: m.calib_err(d[2], d[0], p="2", beta=40),
    "calib_err_p1": lambda m, d: m.calib_err(d[2], d[0], p="1", beta=40),
    "calib_err_infty": lambda m, d: m.calib_err(d[2], d[0], p="infty", beta=40),
    "calib_err_one_bin": lambda m, d: m.calib_err(d[2][:30], d[0][:30], beta=40),
    "aurra": lambda m, d: m.aurra(d[2], d[0]),
    "soft_f1": lambda m, d: m.soft_f1(d[2], d[0]),
    "tune_temp": lambda m, d: m.tune_temp(d[3], d[4]),
    "tune_temp_no_binary_search": lambda m, d: m.tune_temp(d[3], d[4], binary_search=False),
    "fpr_at_recall": lambda m, d: m.fpr_and_fdr_at_recall(d[0], d[1]),
    "fpr_at_recall_0.5": lambda m, d: m.fpr_and_fdr_at_recall(d[0], d[1], 0.5),
    "get_measures": lambda m, d: m.get_measures(d[1][d[0] == 1], d[1][d[0] == 0]),
    "get_measures_out_positive": lambda m, d: m.get_measures(-d[2][:100], -d[2][100:]),
}


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
@pytest.mark.parametrize("case", list(CASES))
def test_calibration_matches_jax(case, ties):
    data = _scores(ties)
    want = np.asarray(CASES[case](jcal, data), np.float64)
    got = np.asarray(CASES[case](pcal, data), np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
def test_auroc_and_ap_match_sklearn(ties):
    """sklearn's semantics on many draws: all-tied, two-level and distinct
    scores, few and many samples, unbalanced classes."""
    rng = np.random.default_rng(1)
    for trial in range(60):
        n = int(rng.integers(2, 200))
        labels = (rng.uniform(size=n) < rng.uniform(0.05, 0.95)).astype(int)
        labels[0], labels[-1] = 0, 1
        scores = rng.normal(size=n)
        if ties:
            scores = rng.integers(0, 1 + trial % 4, n).astype(float)
        assert abs(pcal.roc_auc_score(labels, scores)
                   - sk.roc_auc_score(labels, scores)) <= TOL
        assert abs(pcal.average_precision_score(labels, scores)
                   - sk.average_precision_score(labels, scores)) <= TOL


def test_auroc_refuses_one_class():
    with pytest.raises(ValueError, match="two classes"):
        pcal.roc_auc_score(np.ones(4, int), np.arange(4.0))


def test_show_calibration_results_logs_as_jax():
    _, _, conf, _, _ = _scores(True)
    correct = (conf > 0.5).astype(int)
    lines = {}
    for mod in (jcal, pcal):
        grab = logging.Handler()
        grab.emit = lambda record, out=lines.setdefault(mod, []): out.append(record.getMessage())
        logger = logging.getLogger(mod.__name__)
        logger.addHandler(grab)
        try:
            mod.show_calibration_results(conf, correct, "Baseline")
        finally:
            logger.removeHandler(grab)
    assert lines[pcal] == lines[jcal] and len(lines[pcal]) == 3


# ---------------------------------------------------------------------------
# the evaluators through the CLI
# ---------------------------------------------------------------------------


def _write_lines(path, records):
    with open(path, "w") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")
    return str(path)


@pytest.fixture
def result_files(tmp_path):
    """One result file of each kind the evaluators read, in the form the
    solvers write."""
    rng = np.random.default_rng(2)
    files = {}
    for i in range(2):
        scores = rng.normal(size=(40, 10))
        labels = rng.integers(0, 10, 40)
        files[f"cls{i}"] = _write_lines(tmp_path / f"cls{i}.txt", [
            {"score": s.tolist(), "label": int(lab)} for s, lab in zip(scores, labels)])
    for split, shift in (("in", 0.3), ("out", 0.0)):
        conf = np.clip(rng.uniform(size=50) + shift, 0.01, 1.0)
        conf[:10] = 0.5  # ties across the two files
        files[split] = _write_lines(tmp_path / f"{split}.txt", [
            {"confidence": conf[j:j + 10].tolist(),
             "correct": [int(c > 0.6) for c in conf[j:j + 10]],
             "num_correct": int((conf[j:j + 10] > 0.6).sum())} for j in range(0, 50, 10)])
    for pert in ("gaussian_noise", "rotate"):
        files[pert] = _write_lines(tmp_path / f"{pert}.txt", [
            {"predictions": rng.integers(0, 3, 5).tolist()} for _ in range(7)])
    labels = rng.integers(0, 5, 30)
    for name, hit in (("clean", 0.8), ("adv1", 0.5), ("adv2", 0.4)):
        preds = np.where(rng.uniform(size=30) < hit, labels, (labels + 1) % 5)
        files[name] = _write_lines(tmp_path / f"{name}.txt", [
            {"prediction": int(p), "label": int(lab)} for p, lab in zip(preds, labels)])
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(yaml.safe_dump({"data": {"test": {"evaluator": {
        "type": "imagenet", "kwargs": {"topk": [1, 3], "unused": 1}}}}}))
    files["config"] = str(cfg)
    return files


SUBCOMMANDS = {
    "imagenet": lambda f: ["imagenet", "--res_file", f["cls0"], "--res_file", f["cls1"]],
    "imagenet_config": lambda f: ["imagenet", "--config", f["config"], "--res_file", f["cls0"]],
    "imagenet-c": lambda f: ["imagenet-c", "--res_file", f["cls0"]],
    "imagenet-a": lambda f: ["imagenet-a", "--res_file", f["cls0"], "--res_file", f["cls1"]],
    "imagenet-o": lambda f: ["imagenet-o", "--res_file_in", f["in"], "--res_file_out", f["out"]],
    "imagenet-o_res_files": lambda f: ["imagenet-o", "--res_file", f["in"], "--res_file",
                                       f["out"]],
    "imagenet-p": lambda f: ["imagenet-p", "--res_file", f["gaussian_noise"], "--perturbation",
                             "gaussian_noise", "--res_file", f["rotate"], "--perturbation",
                             "rotate"],
    "imagenet-s": lambda f: ["imagenet-s", "--res_file", f["cls0"], "--decoder_type", "pil",
                             "--resize_type", "pil-bilinear", "--res_file", f["cls1"],
                             "--decoder_type", "opencv", "--resize_type", "opencv-bicubic"],
    "ar": lambda f: ["ar", "--clean_path", f["clean"], "--adv_path", f["adv1"]],
    "ar_num_samples": lambda f: ["ar", "--clean_path", f["clean"], "--adv_path", f["adv2"],
                                 "--num_samples", "12"],
    "wcar": lambda f: ["wcar", "--clean_path", f["clean"], "--adv_path", f["adv1"],
                       "--adv_path", f["adv2"]],
}


@pytest.mark.parametrize("sub", list(SUBCOMMANDS))
def test_cli_subcommand_matches_jax(sub, result_files, tmp_path, capsys):
    argv = SUBCOMMANDS[sub](result_files)
    want = jax_main(argv)
    jax_out = capsys.readouterr().out.strip().splitlines()[-1]
    metric = tmp_path / "metric"
    jax_metric = metric.read_text() if metric.exists() else None
    metric.unlink(missing_ok=True)
    got = port_main(argv)
    port_out = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.dumps(got) == json.dumps(want)
    assert port_out == jax_out
    assert (metric.read_text() if metric.exists() else None) == jax_metric


def test_cli_imagenet_c_writes_the_metric_file(tmp_path):
    """Beside a ``results.txt.all`` the ImageNet-C evaluator writes ``metric``."""
    for pkg, main in (("jax", jax_main), ("port", port_main)):
        d = tmp_path / pkg
        d.mkdir()
        rng = np.random.default_rng(3)
        res = _write_lines(d / "results.txt.all", [
            {"score": rng.normal(size=10).tolist(), "label": int(rng.integers(0, 10))}
            for _ in range(20)])
        main(["imagenet-c", "--res_file", res])
    assert (tmp_path / "port" / "metric").read_text() == (tmp_path / "jax" / "metric").read_text()


def test_cli_runs_as_a_program(result_files):
    out = subprocess.run(
        [sys.executable, "-m", "robustart_torch.metrics", "imagenet-p", "--res_file",
         result_files["rotate"], "--perturbation", "rotate"],
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    printed = json.loads(out.stdout.strip().splitlines()[-1])
    assert printed == jax_main(["imagenet-p", "--res_file", result_files["rotate"],
                                "--perturbation", "rotate"])
