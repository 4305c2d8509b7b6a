"""The port's AutoAttack cascade and ``benchmark_eval_adv --attack
autoattack_linf`` against the JAX package, on the CPU.

- The version sets and budgets (standard, rand, plus in Linf, L2, L1)
  equal the JAX class's; a mesh is refused; the default device is the card.
- ``_ranked_targets`` equals JAX's at every rank (also past the last
  class).
- The cascade's logic: the same deterministic stand-in stages replace
  APGD, FAB and Square in both packages' ``core`` modules (each call a
  fixed numpy perturbation of each sample, drawn from the call's number,
  the sample's pixels and its target; some outside the eps ball, some NaN;
  a stand-in loss or norm beside it), so that the worklist, the chunks
  of ``bs``, the acceptance check, APGD-CE's best of restarts, APGD-T's
  first successful target and FAB-T's least norm run in both on the same
  values: the adversarial images are equal, bit for bit.
  ``run_standard_evaluation_individual`` is reentrant.
- The slice as a whole: ``attacks_to_run=["fab-t"]`` end to end on the
  tiny ViT of ``tests/test_torch_port_attacks.py`` (K6 and K7's plain
  versions on the CPU) against the JAX class on the same numpy variables:
  the images within 1e-6 on all but 0.5% of values, the same argmax.
- The solver: ``benchmark_eval_adv --attack autoattack_linf`` with
  ``autoattack_kwargs`` cutting it to FAB-T (5 iterations, 2 targets) in
  both packages, as ``tests/test_torch_port_adv_solver.py`` runs fgsm:
  equal AR and at least 99% equal result lines.

Time budget: 30 s in one process with no JAX compilation cache.
"""

import tests.torch_port_threads  # noqa: F401  (before any torch work)
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustart_torch.attacks.autoattack import AutoAttack as PortAA
from robustart_torch.attacks.autoattack import core as port_core
from robustart_torch.models import convert
from robustart_torch.solvers import benchmark_eval_adv as port_adv
from robustart_tpu.attacks.autoattack import AutoAttack as JaxAA
from robustart_tpu.attacks.autoattack import core as jax_core
from robustart_tpu.models import create_classifier as jax_create_classifier
from robustart_tpu.models.torch_convert import flatten
from robustart_tpu.solvers import benchmark_eval_adv as jax_adv
from tests.test_torch_port_adv_solver import _cfg, _lines
from tests.test_torch_port_attacks import _pair
from tests.test_torch_port_autoattack import SIZE, TorchMLP, jax_mlp, mlp_weights
from tests.test_torch_port_resnet import numpy_init

NORMS = ("Linf", "L2", "L1")


def _models():
    v = mlp_weights()
    jv = {k: jnp.asarray(a) for k, a in v.items()}
    jmodel = types.SimpleNamespace(apply_fn=lambda var, img, train=False: jax_mlp(var, img),
                                   variables=jv)
    return jmodel, TorchMLP(v)


@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("version", ["standard", "rand", "plus"])
def test_versions_and_budgets_match_jax(version, norm):
    jmodel, pmodel = _models()
    keys = ("attacks_to_run", "apgd_n_restarts", "eot_iter", "use_largereps", "n_iter",
            "n_target_classes", "square_n_queries", "eps", "seed", "norm", "version")
    for kw in ({}, {"n_target_classes": 7, "n_iter": 20, "seed": 3},
               {"attacks_to_run": ["square", "fab"]}):
        j = JaxAA(jmodel, norm=norm, eps=0.1, version=version, **kw)
        p = PortAA(pmodel, norm=norm, eps=0.1, version=version, device="cpu", **kw)
        assert {k: getattr(p, k) for k in keys} == {k: getattr(j, k) for k in keys}


def test_refusals():
    _, pmodel = _models()
    with pytest.raises(NotImplementedError, match="Facade, parallelism, CIFAR and tools"):
        PortAA(pmodel, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="version"):
        PortAA(pmodel, version="fast", device="cpu")
    if not torch.cuda.is_available():  # the default device is the card, with no fallback
        with pytest.raises(RuntimeError, match="cuda"):
            PortAA(pmodel)


def _batch(n=10, seed=4):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (n, SIZE, SIZE, 3)).astype(np.float32)
    jmodel, _ = _models()
    y = np.asarray(jax_mlp(jmodel.variables, x)).argmax(1).astype(np.int32)
    y[::4] = (y[::4] + 1) % 10  # some samples misclassified from the start
    return x, y


@pytest.mark.parametrize("n_targets", [3, 12])
def test_ranked_targets_match_jax(n_targets):
    jmodel, pmodel = _models()
    x, y = _batch()
    y[1] = 3  # a label below the top
    j = JaxAA(jmodel, n_target_classes=n_targets)
    p = PortAA(pmodel, n_target_classes=n_targets, device="cpu")
    got = p._ranked_targets(torch.from_numpy(x), torch.from_numpy(y).long()).numpy()
    want = np.stack([j._ranked_targets(x, y, rank) for rank in range(n_targets)])
    np.testing.assert_array_equal(got, want)


class StandIn:
    """Deterministic stand-in stages: each call perturbs each sample by a
    pattern drawn from (stage, call number, the sample's pixels, its
    target), at 0.6, 1.0 or 1.4 times eps in the attack's norm (or returns
    it unchanged, or with a NaN), beside a stand-in loss or norm."""

    def __init__(self, eps: float, norm: str):
        self.eps, self.norm, self.calls = eps, norm, {}

    def __call__(self, kind, x, y, targets=None):
        x, y = np.asarray(x, np.float32), np.asarray(y)
        targets = y if targets is None else np.asarray(targets)
        call = self.calls[kind] = self.calls.get(kind, -1) + 1
        out, value = x.copy(), np.zeros(len(x), np.float32)
        for i in range(len(x)):
            pixels = int(np.round(x[i].astype(np.float64).sum() * 1000))
            rng = np.random.default_rng([len(kind), sum(map(ord, kind)), call, pixels,
                                         int(targets[i])])
            u = rng.normal(size=x[i].shape)
            scale = self.eps * rng.choice([0.6, 1.0, 1.4, 0.0])
            if self.norm == "Linf":
                d = np.sign(u) * scale
            elif self.norm == "L2":
                d = u / np.sqrt((u**2).sum()) * scale
            else:
                d = np.where(np.abs(u) > 2.0, u, 0.0)
                d = d / np.abs(d).sum() * scale
            out[i] = np.clip(x[i] + d, 0.0, 1.0)
            if rng.uniform() < 0.15:
                out[i].flat[rng.integers(out[i].size)] = np.nan
            value[i] = rng.uniform(0, 2 * self.eps) if scale else np.inf
        return out, value

    def install(self, monkeypatch):
        """The stand-ins in place of both packages' stages."""
        def j_apgd(fn, v, x, y, key, *, loss, targets=None, **kw):
            a, f = self(f"apgd-{loss}", x, y, targets)
            return jnp.asarray(a), jnp.asarray(f)

        def j_fab(fn, v, x, y, targets, key, *, untargeted=False, **kw):
            a, n = self("fab" if untargeted else "fab-t", x, y, None if untargeted else targets)
            return jnp.asarray(a), jnp.asarray(n)

        def j_square(fn, v, x, y, key, **kw):
            return jnp.asarray(self("square", x, y)[0])

        def p_apgd(model, x, y, gen, *, loss, targets=None, **kw):
            a, f = self(f"apgd-{loss}", x.numpy(), y.numpy(),
                        None if targets is None else targets.numpy())
            return torch.from_numpy(a), torch.from_numpy(f)

        def p_fab(model, x, y, targets, *, untargeted=False, **kw):
            a, n = self("fab" if untargeted else "fab-t", x.numpy(), y.numpy(),
                        None if untargeted else targets.numpy())
            return torch.from_numpy(a), torch.from_numpy(n)

        def p_square(model, x, y, gen, **kw):
            return torch.from_numpy(self("square", x.numpy(), y.numpy())[0])

        for name in ("apgd_attack", "apgd_attack_largereps"):
            monkeypatch.setattr(jax_core, name, j_apgd)
            monkeypatch.setattr(port_core, name, p_apgd)
        monkeypatch.setattr(jax_core, "fab_attack_targeted", j_fab)
        monkeypatch.setattr(port_core, "fab_attack_targeted", p_fab)
        for norm in NORMS:
            monkeypatch.setattr(jax_core, f"square_attack_{norm.lower()}", j_square)
            monkeypatch.setitem(port_core.SQUARE, norm, p_square)


@pytest.mark.parametrize("norm,version,eps", [("Linf", "standard", 0.3), ("L2", "plus", 6.0),
                                              ("L1", "standard", 60.0), ("Linf", "rand", 0.3)])
def test_cascade_logic_matches_jax(norm, version, eps, monkeypatch):
    jmodel, pmodel = _models()
    x, y = _batch()
    outs = []
    for make in (lambda: JaxAA(jmodel, norm=norm, eps=eps, version=version, n_target_classes=3),
                 lambda: PortAA(pmodel, norm=norm, eps=eps, version=version, n_target_classes=3,
                                device="cpu")):
        StandIn(eps, norm).install(monkeypatch)
        outs.append(np.asarray(make().run_standard_evaluation(x, y, bs=4)))
    want, got = outs
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)
    changed = (got != x).reshape(len(x), -1).any(1)
    assert 0 < changed.sum() < len(x)  # some accepted, some refused or robust


def test_individual_is_reentrant(monkeypatch):
    _, pmodel = _models()
    x, y = _batch()
    StandIn(0.3, "Linf").install(monkeypatch)
    aa = PortAA(pmodel, eps=0.3, version="plus", device="cpu", n_target_classes=2)
    before = list(aa.attacks_to_run)
    first = aa.run_standard_evaluation_individual(x, y, bs=4)
    assert aa.attacks_to_run == before and list(first) == before
    StandIn(0.3, "Linf").install(monkeypatch)
    again = aa.run_standard_evaluation_individual(x, y, bs=4)
    for attack in before:
        assert torch.equal(first[attack], again[attack])
    assert [s[0] for s in aa.stages] == [before[-1]]


def test_fab_t_slice_matches_jax():
    jclf, pclf = _pair("vit")
    x = np.random.default_rng(6).uniform(0, 1, (4, 32, 32, 3)).astype(np.float32)
    y = np.asarray(jclf(jnp.asarray(x))).argmax(-1).astype(np.int32)
    kw = dict(norm="Linf", eps=8 / 255, attacks_to_run=["fab-t"], n_iter=10,
              n_target_classes=3)
    ref = np.asarray(JaxAA(jclf, **kw).run_standard_evaluation(x, y, bs=4))
    got = PortAA(pclf, device="cpu", **kw).run_standard_evaluation(x, y, bs=4).numpy()
    assert np.mean(np.abs(got - ref) > 1e-6) <= 0.005
    assert (ref != x).reshape(4, -1).any(1).sum() >= 1  # FAB-T broke a sample
    assert np.abs(got - x).max() <= 8 / 255 * 1.001 and 0 <= got.min() and got.max() <= 1
    with torch.no_grad():
        port_pred = pclf(torch.from_numpy(got)).argmax(-1).numpy()
    np.testing.assert_array_equal(port_pred, np.asarray(jclf(jnp.asarray(ref))).argmax(-1))


def test_autoattack_solver_matches_jax(tmp_path, monkeypatch):
    from robustart_torch.core.config import Config as PortConfig
    from robustart_tpu.core.config import Config as JaxConfig

    numpy_init(monkeypatch)
    aa_kw = {"attacks_to_run": ["fab-t"], "n_iter": 5, "n_target_classes": 2}

    def cfg(root):
        return {**_cfg(root), "autoattack_kwargs": aa_kw}

    jax_res = jax_adv.BenchmarkEvalAdvSolver(JaxConfig(cfg(tmp_path / "jax")),
                                             attack="autoattack_linf", eps=8.0).evaluate()
    clf = jax_create_classifier("resnet18", rng=0, num_classes=10)
    ckpt = tmp_path / "resnet18.pth"
    torch.save(convert.state_dict_from_flax({k: np.asarray(v) for k, v in
                                             flatten(clf.variables).items()}), ckpt)
    port = port_adv.BenchmarkEvalAdvSolver(PortConfig(cfg(tmp_path / "port")),
                                           src_path=str(ckpt), tgt_path=str(ckpt),
                                           attack="autoattack_linf", eps=8.0, device="cpu")
    port_res = port.evaluate()
    assert port.autoattack.attacks_to_run == ["fab-t"] and port.autoattack.n_iter == 5
    assert port_res["AR"] == jax_res["AR"]
    for key in ("clean_file", "adv_file"):
        assert port_res[key].replace("port", "jax") == jax_res[key]
        a, b = _lines(jax_res[key]), _lines(port_res[key])
        assert len(a) == len(b) == 24
        assert np.mean([u == v for u, v in zip(a, b)]) >= 0.99
    assert json.loads(open(port_res["adv_file"]).readline()).keys() == {"prediction", "label"}
