"""The port's adversarial solver and evaluators against the JAX package.

- ``AdvRobustEvaluator`` and ``WorstCaseAdvRobustEvaluator`` of both
  packages on the same result files: equal AR and WCAR.
- ``BenchmarkEvalAdvSolver`` with ``fgsm`` at eps 8 on a ResNet-18 of 10
  classes, the fake backend at 32², in both packages: the JAX solver draws
  its variables from numpy (``numpy_init``), the port loads the same
  variables from a ``--src_path``/``--tgt_path`` checkpoint made by its
  weight bridge.
  Equal AR and at least 99% equal prediction lines (an FGSM step is the
  sign of a gradient that the two libraries sum in different orders, so a
  pixel whose gradient is near zero may step the other way).
- The CLI's attacks and refusals: ``autoattack_linf`` builds an
  ``AutoAttack`` from the config's ``autoattack_kwargs`` (its parity with
  the JAX solver is in ``tests/test_torch_port_autoattack_cascade.py``), a
  ``--eps`` of ``0.5/255`` is refused by the parser of both packages, and
  the CLI runs on the CPU only when asked.
"""

import json

import numpy as np
import pytest
import torch

from robustart_torch.metrics import AdvRobustEvaluator as PortAR
from robustart_torch.metrics import WorstCaseAdvRobustEvaluator as PortWCAR
from robustart_torch.models import convert
from robustart_torch.solvers import benchmark_eval_adv as port_adv
from robustart_tpu.metrics import AdvRobustEvaluator as JaxAR
from robustart_tpu.metrics import WorstCaseAdvRobustEvaluator as JaxWCAR
from robustart_tpu.models import create_classifier as jax_create_classifier
from robustart_tpu.models.torch_convert import flatten
from robustart_tpu.solvers import benchmark_eval_adv as jax_adv
from tests.test_torch_port_resnet import numpy_init


def _write(path, preds, labels):
    path.write_text("".join(json.dumps({"prediction": int(p), "label": int(l)}) + "\n"
                            for p, l in zip(preds, labels)))
    return str(path)


def test_evaluators_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    labels = rng.integers(0, 12, 200)
    clean = np.where(rng.uniform(size=200) < 0.7, labels, rng.integers(0, 12, 200))
    advs = [np.where(rng.uniform(size=200) < 0.5, labels, rng.integers(0, 12, 200))
            for _ in range(3)]
    cf = _write(tmp_path / "clean", clean, labels)
    afs = [_write(tmp_path / f"adv{i}", a, labels) for i, a in enumerate(advs)]
    for n in (None, 150):
        for af in afs:
            assert PortAR().eval(cf, af, num_samples=n) == JaxAR().eval(cf, af, num_samples=n)
        assert (PortWCAR().eval(cf, afs, num_samples=n)
                == JaxWCAR().eval(cf, afs, num_samples=n))
    line = '{"prediction": 3, "label": 17}'
    assert PortAR.parse_line(line) == JaxAR.parse_line(line) == ("3", "17")


def _cfg(results):
    return {
        "model": {"type": "resnet18", "kwargs": {"num_classes": 10}},
        "seed": 0,
        "data": {
            "batch_size": 8, "num_workers": 2, "input_size": 32, "test_resize": 36,
            "read_from": "fake", "fake_size": 24, "fake_num_classes": 10,
            "test": {"sampler": {"type": "distributed"}, "transforms": {"type": "JUSTNORM"}},
        },
        "saver": {"results_dir": str(results)},
    }


def _lines(path):
    return [json.loads(line) for line in open(path)]


def test_fgsm_solver_matches_jax(tmp_path, monkeypatch):
    from robustart_tpu.core.config import Config as JaxConfig

    from robustart_torch.core.config import Config as PortConfig

    numpy_init(monkeypatch)
    jax_solver = jax_adv.BenchmarkEvalAdvSolver(JaxConfig(_cfg(tmp_path / "jax")),
                                                attack="fgsm", eps=8.0)
    jax_res = jax_solver.evaluate()
    # the variables the JAX solver drew (create_classifier(name, rng=0)), as a
    # torchvision-named checkpoint for the port's --src_path
    clf = jax_create_classifier("resnet18", rng=0, num_classes=10)
    flat = {k: np.asarray(v) for k, v in flatten(clf.variables).items()}
    ckpt = tmp_path / "resnet18.pth"
    torch.save(convert.state_dict_from_flax(flat), ckpt)
    port = port_adv.BenchmarkEvalAdvSolver(PortConfig(_cfg(tmp_path / "port")),
                                           src_path=str(ckpt), tgt_path=str(ckpt),
                                           attack="fgsm", eps=8.0, device="cpu")
    port_res = port.evaluate()

    assert port_res["AR"] == jax_res["AR"]
    for key in ("clean_file", "adv_file"):
        assert port_res[key].replace("port", "jax") == jax_res[key]
        a, b = _lines(jax_res[key]), _lines(port_res[key])
        assert len(a) == len(b) == 24
        assert [x["label"] for x in a] == [x["label"] for x in b]
        same = np.mean([x == y for x, y in zip(a, b)])
        assert same >= 0.99, (key, same)


def test_attack_configs_match_jax():
    for attack, eps in (("fgsm", 8), ("fgsm", 0.5), ("pgd_linf", 2), ("pgd_l2", 0.5),
                        ("pgd_l1", 400), ("mim_linf", 8), ("autoattack_linf", 8)):
        assert port_adv.attack_config(attack, eps) == jax_adv.attack_config(attack, eps)
    assert list(port_adv.ATTACKS) == list(jax_adv.ATTACKS)


def test_autoattack_and_eps_refusals(tmp_path, monkeypatch):
    cfg = tmp_path / "cfg.yaml"
    aa_kw = {"attacks_to_run": ["apgd-ce"], "n_iter": 2, "seed": 5}
    cfg.write_text(json.dumps({**_cfg(tmp_path / "out"), "autoattack_kwargs": aa_kw}))
    built = []

    class Recording(port_adv.AutoAttack):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            built.append(self)

    monkeypatch.setattr(port_adv, "AutoAttack", Recording)
    res = port_adv.main(["--config", str(cfg), "--attack", "autoattack_linf", "--device", "cpu"])
    (aa,) = built
    assert (aa.attacks_to_run, aa.n_iter, aa.seed) == (["apgd-ce"], 2, 5)
    assert (aa.norm, aa.eps, aa.version, aa.device.type) == ("Linf", 8 / 255, "standard", "cpu")
    assert 0.0 <= res["AR"] <= 100.0
    for main in (port_adv.main, jax_adv.main):
        with pytest.raises(SystemExit):
            main(["--config", str(cfg), "--attack", "fgsm", "--eps", "0.5/255"])
    if not torch.cuda.is_available():  # the default device is the card, with no fallback
        with pytest.raises(RuntimeError, match="cuda"):
            port_adv.main(["--config", str(cfg), "--attack", "fgsm"])
