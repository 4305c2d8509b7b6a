"""The pieces of the port's training path against the JAX package's.

- the LR schedules at every step of short runs (1e-7 rel) against the
  jitted JAX schedules; SGD (± nesterov, ± ``no_wd``), AdamW (± ``no_wd``)
  and Adam, 3 updates on numpy trees against optax (1e-6 rel);
- the ``no_wd`` mask against ``_no_wd_mask`` for every parameter of
  resnet50_official, vit_base and convnextv2_base on ``jax.eval_shape``'s
  shapes (equal; ConvNeXt-V2's GRN is (C,) in Flax and (1, 1, 1, C) here);
- label smoothing and the soft cross-entropy against optax (1e-6 rel);
  mixup/cutmix fed the JAX function's draws (``fold_in`` → ``split(3)`` →
  ``split(5)``) against the jitted JAX function (≤ 1 ulp); the port's own
  draws by their statistics; the EMA (≤ 1 ulp);
- STANDARD and the train loader (epochs 0 and 1) bitwise against the JAX
  package's; the training step's normalization bitwise against the jitted
  JAX program's on all 256 levels; the eval input's normalization (uint8
  and a computed float) likewise;
- BatchNorm's running statistics after a train-mode forward (1e-6·max);
- the in-step PGD alone on a tiny ViT with JAX's start injected: the
  adversarial images agree except where a step's JAX gradient is below
  1e-5 of its largest (its sign may flip between programs);
- the msgpack reader bitwise against Flax's ``msgpack_restore`` on a
  JAX-written checkpoint (bf16 leaves included), the writer read back by
  Flax; checkpoint discovery.
"""

import tests.torch_port_threads  # noqa: F401  (before any torch work)
import os
import random
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from robustart_torch.attacks.gradient import pgd_linf as port_pgd
from robustart_torch.core.config import Config as PortConfig
from robustart_torch.data import build_dataloader as port_loader
from robustart_torch.data.transforms import standard_transform as port_standard
from robustart_torch.models import registry as port_registry
from robustart_torch.models.classifier import Classifier as PortClassifier
from robustart_torch.models.classifier import StepAttackView
from robustart_torch.models.layers import normalize_jit
from robustart_torch.models.resnet import BatchNorm
from robustart_torch.solvers import base as port_base
from robustart_torch.solvers import checkpointing as port_ckpt
from robustart_torch.solvers import msgpack_io
from robustart_torch.solvers import optim as port_optim
from robustart_tpu.attacks.gradient import _ce_grad as jax_ce_grad
from robustart_tpu.attacks.gradient import pgd_linf as jax_pgd
from robustart_tpu.core.config import Config
from robustart_tpu.data import build_dataloader as jax_loader
from robustart_tpu.data.transforms import standard_transform as jax_standard
from robustart_tpu.models import registry as jax_registry
from robustart_tpu.models.layers import normalize_01 as jax_normalize_01
from robustart_tpu.models.torch_convert import flatten, unflatten
from robustart_tpu.solvers import base as jax_base
from robustart_tpu.solvers import optim as jax_optim
from tests.test_torch_port_cnn_zoo_shapes import _jax_shapes
from tests.test_torch_port_resnet import numpy_variables
from tests.train_port_helpers import (TINY, as_mix_draws, encoded_flax, jax_draws, recipe,
                                      register_tiny, step_mix_key, torch_state)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _ulps(got, want):
    """The largest distance in float32 ulps of ``want``."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return (np.abs(got.astype(np.float64) - want) / np.spacing(np.abs(want))).max()


# -- schedules and optimizers ---------------------------------------------------


SCHEDULES = [
    {"type": "CosineEpoch", "kwargs": {"base_lr": 0.1, "warmup_lr": 0.4, "warmup_epoch": 2,
                                       "max_epoch": 7, "min_lr": 0.001}},
    {"type": "CosineEpoch", "kwargs": {"base_lr": 0.003, "max_epoch": 5}},
    {"type": "StepEpoch", "kwargs": {"base_lr": 0.2, "lr_epochs": [2, 4, 6],
                                     "lr_mults": [0.1, 0.5, 0.1], "warmup_lr": 0.8,
                                     "warmup_epoch": 1}},
    {"type": "Step", "kwargs": {"base_lr": 0.1, "warmup_lr": 0.4, "warmup_steps": 5,
                                "lr_steps": [9, 17], "lr_mults": [0.1, 0.1], "max_iter": 30}},
]


@pytest.mark.parametrize("cfg", SCHEDULES, ids=[c["type"] for c in SCHEDULES])
def test_schedules_match_jax(cfg):
    steps_per_epoch = 3
    want = np.asarray(jax.jit(jax_optim.build_schedule(Config(cfg), steps_per_epoch))(
        jnp.arange(30)))
    sched = port_optim.build_schedule(PortConfig(cfg), steps_per_epoch)
    got = np.array([sched(t) for t in range(30)], np.float32)
    assert _rel(got, want) <= 1e-7 or np.all(np.abs(got - want) <= 1e-7 * np.abs(want))


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"conv": {"kernel": rng.normal(size=(3, 3, 4, 5)).astype(np.float32)},
            "norm": {"scale": rng.normal(size=(5,)).astype(np.float32),
                     "bias": rng.normal(size=(5,)).astype(np.float32)},
            "head": {"kernel": rng.normal(size=(5, 7)).astype(np.float32)}}


OPTIMIZERS = [
    {"type": "SGD", "kwargs": {"momentum": 0.9, "nesterov": True, "weight_decay": 1e-4}},
    {"type": "SGD", "kwargs": {"momentum": 0.8, "weight_decay": 5e-2}, "no_wd": True},
    {"type": "AdamW", "kwargs": {"betas": [0.9, 0.999], "weight_decay": 0.05}, "no_wd": True},
    {"type": "AdamW", "kwargs": {"betas": [0.8, 0.99], "eps": 1e-6, "weight_decay": 0.1}},
    {"type": "Adam", "kwargs": {"betas": [0.9, 0.999]}},
]


class _Flat(torch.nn.Module):
    """Parameters named by the flat Flax paths, as the mask reads them."""

    def __init__(self, flat):
        super().__init__()
        self.names = list(flat)
        for i, v in enumerate(flat.values()):
            self.register_parameter(f"p{i}", torch.nn.Parameter(torch.from_numpy(v.copy())))


@pytest.mark.parametrize("cfg", OPTIMIZERS, ids=lambda c: f"{c['type']}-{c.get('no_wd', False)}")
def test_optimizers_match_optax(cfg):
    sched_cfg = {"type": "Step", "kwargs": {"base_lr": 0.05, "warmup_lr": 0.1,
                                            "warmup_steps": 1, "lr_steps": [2]}}
    params = _tree(0)
    tx = jax_optim.build_optimizer(Config(cfg), jax_optim.build_schedule(Config(sched_cfg), 1))
    opt_state = tx.init(params)
    update = jax.jit(tx.update)
    flat = flatten(params)
    index = {k: i for i, k in enumerate(flat)}
    model = _Flat(flat)
    port = port_optim.build_optimizer(PortConfig(cfg), port_optim.build_schedule(
        PortConfig(sched_cfg), 1), model)
    named = dict(model.named_parameters())
    state = port.init(named)
    for step in range(3):
        grads = _tree(10 + step)
        updates, opt_state = update(grads, opt_state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
        g = {f"p{index[k]}": torch.from_numpy(v) for k, v in flatten(grads).items()}
        port.step(named, g, state)
    for name, want in flatten(params).items():
        assert _rel(named[f"p{index[name]}"].detach().numpy(), want) <= 1e-6, name
    assert state["count"] == 3


@pytest.fixture(scope="module")
def mask_shapes():
    return {name: _jax_shapes(jax_registry.get_model(name, num_classes=10), 32)
            for name in ("resnet50_official", "vit_base", "convnextv2_base")}


@pytest.mark.parametrize("name", ["resnet50_official", "vit_base", "convnextv2_base"])
def test_no_wd_mask_follows_jax_shapes(name, mask_shapes):
    from robustart_torch.models import convert

    shapes = {k: s for k, s in mask_shapes[name].items() if k.startswith("params/")}
    # each leaf filled with its index: the bridge moves values, so a torch
    # tensor's value names the Flax leaf it came from
    flat = encoded_flax(shapes)
    with torch.device("meta"):
        model = port_registry.get_model(name, num_classes=10)
    head_dim = convert.model_head_dim(model)
    sd = convert.state_dict_from_flax(flat, head_dim=head_dim)
    want_flax = jax_optim._no_wd_mask(unflatten({k: np.zeros(s, np.float32)
                                                 for k, s in shapes.items()}))
    want_flax = {k: bool(v) for k, v in flatten(want_flax).items()}
    paths = list(shapes)
    mask = port_optim.no_wd_mask(model)
    assert set(mask) == {k for k in sd if not k.endswith(("running_mean", "running_var",
                                                          "num_batches_tracked"))}
    for key, decays in mask.items():
        src = paths[int(sd[key][(0,) * sd[key].dim()])]
        assert decays == want_flax[src], (key, src)
    if name == "convnextv2_base":
        assert mask["stages.0.0.grn.gamma"] is False
        assert model.stages[0][0].grn.gamma.dim() == 4


# -- losses, mixing, EMA --------------------------------------------------------


def test_label_smoothing_and_soft_ce_match_optax():
    rng = np.random.default_rng(0)
    labels = rng.integers(0, 10, 16)
    logits = rng.normal(size=(16, 10)).astype(np.float32) * 3
    for smoothing in (0.0, 0.1):
        want = np.asarray(jax_optim.one_hot_smooth(jnp.asarray(labels), 10, smoothing))
        got = port_optim.one_hot_smooth(torch.from_numpy(labels), 10, smoothing).numpy()
        assert _rel(got, want) <= 1e-6
        want_ce = float(jax_optim.smoothed_cross_entropy(jnp.asarray(logits), want))
        got_ce = float(port_optim.smoothed_cross_entropy(torch.from_numpy(logits),
                                                         torch.from_numpy(got)))
        assert got_ce == pytest.approx(want_ce, rel=1e-6)
    assert float(optax.softmax_cross_entropy(logits, want).mean()) == pytest.approx(want_ce)


@pytest.mark.parametrize("alphas", [(0.2, 1.0), (0.2, 0.0), (0.0, 1.0)])
def test_mixup_cutmix_matches_jax_on_its_draws(alphas):
    ma, ca = alphas
    rng = np.random.default_rng(1)
    images = rng.uniform(size=(8, 24, 20, 3)).astype(np.float32)
    soft = np.asarray(jax_optim.one_hot_smooth(jnp.arange(8) % 10, 10, 0.1))
    fn = jax.jit(lambda k, x, s: jax_optim.mixup_cutmix(k, x, s, ma, ca))
    draws_fn = jax.jit(lambda k: jax_draws(k, 8, 24, 20, ma, ca))
    seen = set()
    for step in range(6):
        key = step_mix_key(0, step)
        want_x, want_s = (np.asarray(v) for v in fn(key, images, soft))
        draws = as_mix_draws([np.asarray(v) for v in draws_fn(key)])
        seen.add(bool(draws.use_mix))
        got_x, got_s = port_optim.apply_mix(torch.from_numpy(images), torch.from_numpy(soft),
                                            draws, ma, ca)
        assert _ulps(got_x.numpy(), want_x) <= 1, step
        assert _ulps(got_s.numpy(), want_s) <= 1, step
    if ma > 0 and ca > 0:
        assert seen == {True, False}


def test_port_mix_draws_statistics():
    gen = torch.Generator().manual_seed(0)
    n, lam, cut, switch = 1500, [], [], []
    for _ in range(n):
        d = port_optim.draw_mix(gen, 8, 24, 20, 0.2, 1.0)
        assert sorted(d.perm.tolist()) == list(range(8))
        assert 0 <= int(d.cy) < 24 and 0 <= int(d.cx) < 20
        lam.append(float(d.lam_mix))
        cut.append(float(d.lam_cut))
        switch.append(bool(d.use_mix))
    for a, v in ((0.2, np.array(lam)), (1.0, np.array(cut))):
        # Beta(a, a): mean 1/2, variance 1/(4(2a+1)); 5 standard errors
        assert abs(v.mean() - 0.5) < 5 * np.sqrt(1 / (4 * (2 * a + 1)) / n)
        assert abs(v.var() - 1 / (4 * (2 * a + 1))) < 0.15 / (4 * (2 * a + 1))
        assert v.min() >= 0 and v.max() <= 1
    assert abs(np.mean(switch) - 0.5) < 5 * np.sqrt(0.25 / n)
    assert port_optim.draw_mix(gen, 8, 24, 20, 0.0, 0.0) is None


def test_ema_matches_jax():
    ema, params = _tree(3), _tree(4)
    want = jax.jit(lambda e, p: jax_optim.ema_update(e, p, 0.9999))(ema, params)
    got = {k: torch.from_numpy(v.copy()) for k, v in flatten(ema).items()}
    port_optim.ema_update(got, {k: torch.from_numpy(v) for k, v in flatten(params).items()},
                          0.9999)
    for k, v in flatten(want).items():
        assert _ulps(got[k].numpy(), v) <= 1, k


# -- data -----------------------------------------------------------------------


def test_standard_transform_bitwise():
    rng = np.random.default_rng(2)
    for i in range(12):
        h, w = rng.integers(40, 90, 2)
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        seed = (i * 1_000_003 + 7) & 0x7FFFFFFF
        want = jax_standard(img, 32, random.Random(seed))
        got = port_standard(img, 32, random.Random(seed))
        np.testing.assert_array_equal(got, want)


def test_train_loader_bitwise(tmp_path):
    cfg = recipe("sgd_mix", tmp_path)["data"]
    cfg.update(fake_size=20, batch_size=6)
    for epoch in (0, 1):
        want = list(jax_loader(Config(cfg), "train", 0, 1, epoch=epoch, seed=3))
        got = list(port_loader(PortConfig(cfg), "train", 0, 1, epoch=epoch, seed=3))
        assert len(got) == len(want) == 3  # drop_last
        for g, w in zip(got, want):
            for k in ("image", "label", "index", "mask"):
                np.testing.assert_array_equal(g[k], w[k])
    assert not np.array_equal(got[0]["index"], list(port_loader(
        PortConfig(cfg), "train", 0, 1, epoch=0, seed=3))[0]["index"])


def test_step_input_bitwise_on_all_levels():
    """The eval input (a uint8 batch through ``Solver.eval_fn`` and
    ``Classifier.forward``; a computed [0,1] float image, as an attack step
    makes) and the training step's normalization against the jitted JAX
    programs (``solvers/base.py``'s eval step: /255, then the classifier's
    ``normalize_01``) on every uint8 level."""
    levels = np.broadcast_to(np.arange(256, dtype=np.uint8)[None, :, None, None],
                             (1, 256, 1, 3)).copy()
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    wantn = np.asarray(jax.jit(
        lambda u: jax_normalize_01(u.astype(jnp.float32) / 255.0, mean, std))(levels))
    x01 = np.random.default_rng(8).uniform(0.0, 1.0, (1, 256, 1, 3)).astype(np.float32)
    wantf = np.asarray(jax.jit(lambda x: jax_normalize_01(x, mean, std))(x01))
    seen = {}

    class Probe(torch.nn.Module):
        def forward(self, x):
            seen["x"] = x
            return x

    solver = port_base.Solver.__new__(port_base.Solver)
    solver.quantized = None
    solver.classifier = PortClassifier("probe", Probe(), mean, std)
    solver.device = torch.device("cpu")
    solver.maybe_deploy = lambda: False
    port_base.Solver.eval_fn(solver, levels)
    np.testing.assert_array_equal(seen["x"].numpy(), wantn)
    solver.classifier(torch.from_numpy(x01))
    np.testing.assert_array_equal(seen["x"].numpy(), wantf)
    u = torch.from_numpy(levels).float()
    np.testing.assert_array_equal(normalize_jit(u / 255.0, mean, std, u).numpy(), wantn)
    # the eager quotients differ
    eager = (levels / np.float32(255.0) - np.float32(mean)) / np.float32(std)
    assert (wantn != eager).sum() > 0
    assert (wantf != (x01 - np.float32(mean)) / np.float32(std)).sum() > 0


def test_batchnorm_running_stats_match_jax():
    """Flax's train-mode BatchNorm (biased batch variance folded in with
    momentum 0.9) against the port's, from the same running statistics."""
    from flax import linen as nn

    rng = np.random.default_rng(6)
    x = (rng.normal(size=(4, 9, 7, 16)) * 3 + rng.normal(size=16)).astype(np.float32)
    stats = {"mean": rng.normal(size=16).astype(np.float32),
             "var": rng.uniform(0.5, 1.5, 16).astype(np.float32)}
    params = {"scale": rng.uniform(0.5, 1.5, 16).astype(np.float32),
              "bias": rng.normal(size=16).astype(np.float32)}
    bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    y, upd = jax.jit(lambda v, xx: bn.apply(v, xx, mutable=["batch_stats"]))(
        {"params": params, "batch_stats": stats}, x)
    port = BatchNorm(16)
    port.load_state_dict({"weight": torch.from_numpy(params["scale"]),
                          "bias": torch.from_numpy(params["bias"]),
                          "running_mean": torch.from_numpy(stats["mean"]),
                          "running_var": torch.from_numpy(stats["var"]),
                          "num_batches_tracked": torch.tensor(0)})
    port.train()
    got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert _rel(got.detach().numpy(), np.asarray(y)) <= 1e-6
    assert _rel(port.running_mean.numpy(), np.asarray(upd["batch_stats"]["mean"])) <= 1e-6
    assert _rel(port.running_var.numpy(), np.asarray(upd["batch_stats"]["var"])) <= 1e-6
    # nn.BatchNorm2d would fold the unbiased variance: n/(n−1) on the update
    n = x.size // 16
    assert abs(n / (n - 1) - 1) * 0.1 > 1e-4
    assert int(port.num_batches_tracked) == 1


# -- the in-step attack ---------------------------------------------------------


def test_in_step_pgd_matches_jax_where_the_gradient_is_not_roundoff(monkeypatch):
    register_tiny(monkeypatch)
    jm = TINY["tiny_vit"][0](num_classes=10)
    variables = unflatten(numpy_variables(jm, 32, 7))
    jclf = jax_registry.Classifier("tiny_vit", jm, variables, input_size=32, num_classes=10)
    clf = port_registry.create_classifier("tiny_vit", device="cpu", num_classes=10)
    clf.model.load_state_dict(torch_state(variables, "tiny_vit"))
    clf.eval()
    rng = np.random.default_rng(8)
    x = rng.uniform(size=(4, 32, 32, 3)).astype(np.float32)
    labels = np.arange(4) % 10
    eps, rel, steps = 0.01569, 0.333, 3
    key = jax.random.key(11)
    logits_fn = jclf.logits_fn()
    want = np.asarray(jax.jit(lambda v, xx, y, k: jax_pgd(
        logits_fn, v, xx, y, k, eps=eps, rel_stepsize=rel, steps=steps))(variables, x, labels, key))
    start = np.asarray(jax.random.uniform(key, x.shape, jnp.float32, -eps, eps))
    # JAX's steps one by one, for the pixels where a gradient is roundoff
    grad_fn = jax.jit(lambda v, xa, y: jax_ce_grad(logits_fn, v, xa, y))
    xa, near_zero = np.clip(x + start, 0, 1), np.zeros(x.shape, bool)
    for _ in range(steps):
        g = np.asarray(grad_fn(variables, xa, labels))
        near_zero |= np.abs(g) < 1e-5 * np.abs(g).max()
        xa = np.clip(np.clip(xa + np.float32(rel * eps) * np.sign(g), x - eps, x + eps), 0, 1)
    got = port_pgd(StepAttackView(clf), torch.from_numpy(x), torch.from_numpy(labels), None,
                   eps=eps, rel_stepsize=rel, steps=steps, start=torch.from_numpy(start)).numpy()
    far = ~near_zero
    assert np.abs(got - want)[far].max() <= 1e-6
    assert far.mean() > 0.9
    assert all(p.requires_grad is False for p in clf.parameters())  # frozen by the attack


# -- checkpoints ----------------------------------------------------------------


def test_msgpack_reader_matches_flax(tmp_path):
    rng = np.random.default_rng(9)
    big = rng.normal(size=(64, 48)).astype(np.float32)
    payload = {"params": {"conv": {"kernel": big}, "bn": {"scale": np.ones(5, np.float32)}},
               "batch_stats": {"bn": {"mean": rng.normal(size=5).astype(np.float32)}}}
    extra = {"state": {"step": np.int32(7), "bf16": jnp.asarray(big, jnp.bfloat16),
                       "opt_state": {"0": {}, "1": {"0": {"trace": {"k": big * 2}},
                                                    "1": {"count": np.int32(7)}}},
                       "ema_params": {}},
             "epoch": 3, "step": 7, "ints": np.arange(300, dtype=np.int64)}
    path = str(tmp_path / "ckpt.msgpack")
    jax_base.save_checkpoint(path, payload, extra=extra)
    want = flatten(jax_base.load_checkpoint(path))
    got = flatten(msgpack_io.load(path))
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(g, torch.Tensor):  # bfloat16, read as its 16-bit words
            assert g.dtype == torch.bfloat16 and str(w.dtype) == "bfloat16"
            np.testing.assert_array_equal(g.view(torch.int16).numpy(), w.view(np.int16))
        else:
            assert g.dtype == w.dtype and g.shape == w.shape, k
            np.testing.assert_array_equal(g, w)
    # the writer, read back by Flax
    tree = msgpack_io.load(path)
    again = serialization.msgpack_restore(msgpack_io.dumps(tree))
    assert set(flatten(again)) == set(want)
    for k, w in flatten(again).items():
        g = want[k]
        assert np.asarray(w).dtype == np.asarray(g).dtype and np.shape(w) == np.shape(g), k
        assert np.asarray(w).tobytes() == np.asarray(g).tobytes(), k
    plain = {"neg": -5, "big": 2**40, "f": 0.5, "b": b"x", "l": [1, None, True], "s": "x" * 40}
    assert msgpack_io.loads(msgpack_io.dumps(plain)) == plain
    assert serialization.msgpack_restore(msgpack_io.dumps(plain)) == plain


def test_checkpoint_discovery(tmp_path):
    for i, name in enumerate(("a.pth", "ckpt_e1.pth.tar", "ckpt_e2.msgpack", "old.msgpack")):
        (tmp_path / name).write_bytes(b"")
        t = time.time() + (i if name != "old.msgpack" else -10)
        os.utime(tmp_path / name, (t, t))
    assert port_base.newest_checkpoint(str(tmp_path)).endswith("ckpt_e2.msgpack")
    assert port_ckpt.latest_checkpoint(str(tmp_path)).endswith("ckpt_e2.msgpack")
    assert port_ckpt.latest_checkpoint(str(tmp_path / "none")) is None
    (tmp_path / "step_12").mkdir()
    (tmp_path / "step_3").mkdir()
    newest = port_ckpt.latest_checkpoint(str(tmp_path))
    assert newest.endswith("step_12")
    with pytest.raises(NotImplementedError, match="ROADMAP.md, modules to port: Training"):
        port_ckpt.load_any(newest)
