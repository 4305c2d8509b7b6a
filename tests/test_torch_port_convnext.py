"""The port's ConvNeXt, its weight bridge and its solver path against the
JAX package.

The JAX model's variables (LayerNorm parameters, biases and the layer-scale
``gamma`` randomized from numpy: at its 1e-6 init every block is all but
the identity and a K7 or K11 error would not show) go through
``robustart_torch.models.convert`` into the port's facebook-named model. The
JAX model runs K11 as its Pallas kernel in interpret mode
(``block_impl="pallas"``) and its MLP in XLA; on the CPU the port runs the
plain versions of K11 and K7. Tolerance at f32: max|Δlogit| ≤
2e-4·max|logit| and equal argmax.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import robustart_tpu.models.convnext as jax_convnext
from robustart_torch.core.config import Config as PortConfig
from robustart_torch.core.config import load_config
from robustart_torch.models import convert, create_classifier
from robustart_torch.models import convnext as port_convnext
from robustart_torch.models import registry as port_registry
from robustart_torch.solvers import MultiEvalSolver as PortSolver
from robustart_tpu.core.config import Config
from robustart_tpu.models import registry as jax_registry
from robustart_tpu.models.torch_convert import convert_state_dict, flatten, unflatten
from robustart_tpu.noise.corruptions import jax_kernels as jk
from robustart_tpu.solvers import MultiEvalSolver as JaxSolver
from tests.test_torch_port_resnet import numpy_init

TINY = dict(depths=(1, 1), dims=(32, 64), num_classes=10)
SIZE = 32


# the tiny ConvNeXt's initial variables, from one jitted init of its XLA
# form: every form and dtype has the same f32 parameters, and tracing the
# Pallas form in interpret mode only to draw them costs seconds
_INIT = jax.jit(lambda k: jax_convnext.ConvNeXt(**TINY, block_impl="xla", mlp_impl="xla").init(
    k, jnp.zeros((1, SIZE, SIZE, 3)), train=False))


@functools.lru_cache(maxsize=None)
def _init_vars(seed):
    return _INIT(jax.random.key(seed))


def _flax_vars(seed):
    """Flat numpy variables with every LayerNorm parameter, bias and gamma
    drawn from numpy."""
    v = _init_vars(seed)
    rng = np.random.default_rng(seed)
    flat = {}
    for name, a in flatten(v).items():
        a = np.asarray(a, np.float32)
        leaf = name.rsplit("/", 1)[-1]
        if leaf in ("scale", "gamma"):
            a = rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        elif leaf == "bias":
            a = rng.normal(0.0, 0.1, a.shape).astype(np.float32)
        flat[name] = a
    return flat


@pytest.fixture()
def interpreted_k11(monkeypatch):
    """The JAX module's K11 in interpret mode, as its own tests run it."""
    orig = jax_convnext.dwconv_ln_pallas
    monkeypatch.setattr(jax_convnext, "dwconv_ln_pallas",
                        lambda *a, interpret=False: orig(*a, interpret=True))


@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_convnext_matches_jax(interpreted_k11, kind):
    """Stem, one block, downsample, one block, head. bf16 is held to
    3e-2·max|logit|: the JAX XLA MLP rounds to bf16 after each product and
    add, K7 adds bias, gamma and shortcut in f32 and casts once."""
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[kind]
    jm = jax_convnext.ConvNeXt(**TINY, block_impl="pallas", mlp_impl="xla", dtype=jdt)
    flat = _flax_vars(0)
    pm = port_convnext.ConvNeXt(**TINY, dtype=tdt).eval()
    pm.load_state_dict(convert.state_dict_from_flax(flat))
    x = np.random.default_rng(1).normal(0, 0.5, (2, SIZE, SIZE, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda v, xx: jm.apply(v, xx, train=False))(unflatten(flat), x),
                     np.float32)
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    if kind == "f32":
        assert np.abs(got - ref).max() <= 2e-4 * np.abs(ref).max()
        np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))
    else:
        assert np.abs(got - ref).max() <= 3e-2 * np.abs(ref).max()


def test_bridge_is_inverse_of_jax_converter():
    """Flax → the port's facebook-named state dict (the depthwise kernel
    (7, 7, 1, C) → (C, 1, 7, 7)) → the JAX package's torch→Flax converter
    gives back every tensor unchanged."""
    flat = _flax_vars(3)
    sd = convert.state_dict_from_flax(flat)
    assert tuple(sd["stages.0.0.dwconv.weight"].shape) == (32, 1, 7, 7)
    variables = unflatten({k: np.zeros_like(v) for k, v in flat.items()})
    back, missing = convert_state_dict({k: v.numpy() for k, v in sd.items()}, variables,
                                       "ConvNeXt")
    assert missing == []
    for name, value in flatten(back).items():
        np.testing.assert_array_equal(np.asarray(value), flat[name])
    assert set(sd) == set(port_convnext.ConvNeXt(**TINY).state_dict())


def test_create_classifier_convnext_init_and_names():
    """Published init: gamma at 1e-6; ``probe_init`` draws it from
    U(0.5, 1.5). In bf16 the depthwise weights stay f32 (K11 takes f32
    parameters), the pointwise and patchify weights follow the dtype."""
    clf = create_classifier("convnext_base", seed=0, device="cpu")
    blk = clf.model.stages[0][0]
    assert torch.equal(blk.gamma.detach(), torch.full((128,), 1e-6))
    probe = create_classifier("convnext_base", seed=0, device="cpu", probe_init=True)
    g = probe.model.stages[2][5].gamma.detach()
    assert 0.5 <= float(g.min()) and float(g.max()) <= 1.5
    with torch.device("meta"):  # the dtypes only: no storage, no init
        model = port_registry.get_model("convnext_base", dtype=torch.bfloat16, bn={})
    blk = model.stages[3][0]
    assert blk.dwconv.weight.dtype == torch.float32
    assert blk.pwconv1.weight.dtype == torch.bfloat16
    assert model.downsample_layers[1][1].weight.dtype == torch.bfloat16
    assert model.head.weight.dtype == torch.float32
    assert "convnext_base" in set(port_registry.model_names()) & set(jax_registry.model_names())


def _solver_cfg(results):
    cfg = load_config("exprs/exp/imagenet_c_loop_mini/config_convnext_base.yaml")
    out = {k: v for k, v in dict(cfg).items() if k not in ("saver", "data")}
    out["model"] = {**dict(cfg.model), "type": "convnext_tiny_test"}
    out["data"] = {
        "batch_size": 4, "num_workers": 2, "input_size": SIZE, "test_resize": 36,
        "read_from": "fake", "fake_size": 8, "fake_num_classes": 10,
        "test": {"imagenet_c_online": True, "transforms": {"type": "JUSTNORM"},
                 "sampler": {"type": "distributed"}, "limit_samples": 8,
                 "corruptions": ["gaussian_noise", "glass_blur"], "severities": [1, 3],
                 "evaluator": {"type": "imagenetc", "kwargs": {"topk": [1, 5]}}},
    }
    out["saver"] = {"results_dir": str(results)}
    return out


def test_online_solver_matches_jax_with_zero_draws(tmp_path, monkeypatch):
    """Both solvers online on a fake-backend copy of config_convnext_base.yaml
    with a tiny ConvNeXt and the same randomized weights, every random draw
    zero: the same top-1 in every result file, logits within the f32
    tolerance."""
    monkeypatch.setitem(jax_registry.MODELS._factories, "convnext_tiny_test",
                        lambda **kw: jax_convnext.ConvNeXt(**TINY))
    monkeypatch.setitem(jax_registry._META, "convnext_tiny_test",
                        {**jax_registry._META["convnext_base"], "input_size": SIZE})
    monkeypatch.setitem(port_registry.MODELS, "convnext_tiny_test",
                        lambda **kw: port_convnext.ConvNeXt(**TINY))
    monkeypatch.setitem(port_registry._META, "convnext_tiny_test",
                        port_registry._META["convnext_base"])
    # zero draws: no Gaussian noise, glass offsets all (0, 0)
    monkeypatch.setitem(jk.CORRUPTIONS, "gaussian_noise", lambda x, key, severity=1: x)
    monkeypatch.setattr(jax.random, "randint",
                        lambda key, shape, lo, hi, *a, **k: jnp.zeros(shape, jnp.int32))
    from robustart_torch.noise import corruptions as pc
    from robustart_torch.solvers import multi_eval_solver as pme

    monkeypatch.setitem(pme.NOISE_SEVERITY, "gaussian_noise", [0.0] * 5)
    glass = pc.CORRUPTIONS["glass_blur"]

    def glass_zero(x, severity=1, *, generator=None):
        iters = pc.GLASS_SEVERITY[severity - 1][2]
        return glass(x, severity, offsets=torch.zeros((iters, *x.shape[:3], 2)))

    monkeypatch.setitem(pc.CORRUPTIONS, "glass_blur", glass_zero)

    numpy_init(monkeypatch)
    jax_solver = JaxSolver(Config(_solver_cfg(tmp_path / "jax")))
    jax_solver.build_model(seed=0)
    flat = _flax_vars(0)
    jax_solver.classifier.variables = unflatten({k: jnp.asarray(v) for k, v in flat.items()})
    jax_summary = jax_solver.evaluate()
    port = PortSolver(PortConfig(_solver_cfg(tmp_path / "port")), device="cpu")
    port.build_model(seed=0)
    port.classifier.model.load_state_dict(convert.state_dict_from_flax(flat))
    port_summary = port.evaluate()
    assert port_summary["top1_per_corruption"] == jax_summary["top1_per_corruption"]
    for corr in ("gaussian_noise", "glass_blur"):
        for sev in ("1", "3"):
            a = [json.loads(x) for x in open(tmp_path / "jax" / corr / sev / "results.txt.all")]
            b = [json.loads(x) for x in open(tmp_path / "port" / corr / sev / "results.txt.all")]
            sa, sb = np.array([r["score"] for r in a]), np.array([r["score"] for r in b])
            assert sa.shape == sb.shape == (8, 10)
            np.testing.assert_array_equal(sa.argmax(-1), sb.argmax(-1))
            assert np.abs(sa - sb).max() <= 2e-4 * np.abs(sa).max()
