"""The port's dense block (K12), DenseNet, its weight bridge and its config
path against the JAX package.

K12's plain version follows the Pallas kernel's roundings (in bf16, a1 and
t2 are cast before their products). It is held at f32 to the JAX package's
``dense_block_reference`` and at f32 and bf16 to its Pallas kernel in
interpret mode (``dense_block_pallas(..., interpret=True)``, the way the JAX
package's own tests run it on the CPU), at 2 × 6 × 6, c0 8, growth 4, mid
16, 2 layers. Tolerances: f32 max|Δ| ≤ 1e-5·max|ref| (the order of the
sums); bf16 one bf16 ulp of max|ref| (an order of sums may round a t2 value
the other way).

The tiny DenseNet (``block_config=(2, 2)``, growth 8, 16 stem features,
32²) takes the JAX model's variables, its BatchNorm statistics jittered as
``tests/test_pallas_densenet.py`` jitters them, through
``robustart_torch.models.convert``. The port's concat forward and its
CUDA-form forward (K12's plain version on the CPU) are held to the Flax
module and to ``fused_eval_forward(interpret=True)``: f32 max|Δlogit| ≤
2e-4·max|logit| and equal argmax; bf16 3e-2 (the JAX module rounds each
BatchNorm step to bf16, the block adds in f32 and casts once).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustart_torch.core.config import Config as PortConfig
from robustart_torch.core.config import load_config
from robustart_torch.models import convert, create_classifier
from robustart_torch.models import densenet as port_densenet
from robustart_torch.models import registry as port_registry
from robustart_torch.ops import densenet as port_ops
from robustart_torch.solvers import MultiEvalSolver as PortSolver
from robustart_tpu.models import densenet as jax_densenet
from robustart_tpu.models import registry as jax_registry
from robustart_tpu.models.torch_convert import convert_state_dict, flatten, unflatten
from robustart_tpu.ops import pallas_densenet

BLOCK = dict(c0=8, growth=4, n_layers=2, mid=16)
TINY = dict(block_config=(2, 2), growth_rate=8, num_init_features=16, num_classes=10)
SIZE = 32
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _packed(kind, seed=0):
    """x (2, 6, 6, c0) and the packed parameters as numpy f32, x and the
    weights exact in ``kind``'s type."""
    rng = np.random.default_rng(seed)
    jdt = DTYPES[kind][0]
    c0, g, n, mid = BLOCK["c0"], BLOCK["growth"], BLOCK["n_layers"], BLOCK["mid"]
    s = sum(c0 + li * g for li in range(n))

    def exact(a):
        return np.array(jnp.asarray(a, jdt).astype(jnp.float32))

    return dict(x=exact(rng.normal(0, 1, (2, 6, 6, c0))),
                g1=rng.uniform(0.5, 1.5, (1, s)).astype(np.float32),
                b1=rng.normal(0, 0.1, (1, s)).astype(np.float32),
                w1=exact(rng.normal(0, 0.3, (s, mid))),
                g2=rng.uniform(0.5, 1.5, (n, mid)).astype(np.float32),
                b2=rng.normal(0, 0.1, (n, mid)).astype(np.float32),
                w2=exact(rng.normal(0, 0.15, (n * 9 * mid, g))))


def _args(p, kind, lib):
    """The packed arguments as ``lib`` ("jax" or "torch") arrays, x and the
    weights in ``kind``'s type, the affines f32."""
    jdt, tdt = DTYPES[kind]
    if lib == "jax":
        cast = {"x": jdt, "w1": jdt, "w2": jdt}
        return [jnp.asarray(p[k], cast.get(k, jnp.float32))
                for k in ("x", "g1", "b1", "w1", "g2", "b2", "w2")]
    cast = {"x": tdt, "w1": tdt, "w2": tdt}
    return [torch.from_numpy(p[k]).to(cast.get(k, torch.float32))
            for k in ("x", "g1", "b1", "w1", "g2", "b2", "w2")]


def _within(got, ref, kind):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    top = np.abs(ref).max()
    tol = 1e-5 * top if kind == "f32" else 2.0 ** (np.floor(np.log2(top)) - 7)
    assert np.abs(got - ref).max() <= tol, (np.abs(got - ref).max(), tol)


def test_dense_block_plain_matches_jax_reference():
    p = _packed("f32")
    ref = pallas_densenet.dense_block_reference(*_args(p, "f32", "jax"), **BLOCK)
    got = port_ops.dense_block(*_args(p, "f32", "torch"), **BLOCK)
    assert tuple(got.shape) == (2, 6, 6, 16)
    _within(got.numpy(), ref, "f32")


@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_dense_block_plain_matches_pallas_interpret(kind):
    p = _packed(kind, seed=1)
    ref = pallas_densenet.dense_block_pallas(*_args(p, kind, "jax"), interpret=True, **BLOCK)
    got = port_ops.dense_block(*_args(p, kind, "torch"), **BLOCK)
    assert got.dtype == DTYPES[kind][1]
    _within(got.float().numpy(), ref, kind)


def test_fold_bn_matches_jax():
    rng = np.random.default_rng(2)
    w, b, mean = (rng.normal(0, 1, 12).astype(np.float32) for _ in range(3))
    var = rng.uniform(0.5, 2.0, 12).astype(np.float32)
    ref = jax_densenet._fold_bn({"scale": w, "bias": b}, {"mean": mean, "var": var})
    got = port_ops.fold_bn(*(torch.from_numpy(a) for a in (w, b, mean, var)))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def _flax_vars(module, seed):
    """Flat numpy variables with the BatchNorm statistics jittered (mean +
    N(0, 0.1), var · U(0.5, 2)) and the BatchNorm affines drawn from numpy."""
    v = jax.jit(lambda k: module.init(k, jnp.zeros((1, SIZE, SIZE, 3)), train=False))(
        jax.random.key(seed))
    rng = np.random.default_rng(seed)
    flat = {}
    for name, a in flatten(v).items():
        a = np.asarray(a, np.float32)
        leaf = name.rsplit("/", 1)[-1]
        if leaf == "mean":
            a = a + rng.normal(0, 0.1, a.shape).astype(np.float32)
        elif leaf == "var":
            a = a * rng.uniform(0.5, 2.0, a.shape).astype(np.float32)
        elif leaf == "scale":
            a = rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        elif leaf == "bias":
            a = rng.normal(0.0, 0.1, a.shape).astype(np.float32)
        flat[name] = a
    return flat


@pytest.fixture(scope="module")
def tiny():
    """The tiny Flax DenseNet (f32 and bf16) with jittered variables, a
    batch, and each reference's logits: the module and fused_eval_forward
    in interpret mode."""
    x = np.random.default_rng(1).normal(0, 0.5, (2, SIZE, SIZE, 3)).astype(np.float32)
    out = {"x": x}
    for kind, (jdt, _) in DTYPES.items():
        jm = jax_densenet.DenseNet(**TINY, concat_impl="concat", dtype=jdt)
        flat = _flax_vars(jm, 0)
        v = unflatten(flat)
        module = np.asarray(jax.jit(lambda vv, xx: jm.apply(vv, xx, train=False))(v, x),
                            np.float32)
        fused = np.asarray(jax.jit(lambda vv, xx: jax_densenet.fused_eval_forward(
            jm, vv, xx, interpret=True))(v, x), np.float32)
        out[kind] = {"flat": flat, "module": module, "fused": fused}
    return out


@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("ref", ["module", "fused"])
@pytest.mark.parametrize("forward", ["concat", "fused"])
def test_densenet_matches_jax(tiny, kind, ref, forward):
    pm = port_densenet.DenseNet(**TINY, dtype=DTYPES[kind][1]).eval()
    pm.load_state_dict(convert.state_dict_from_flax(tiny[kind]["flat"]))
    with torch.no_grad():
        fn = pm.concat_forward if forward == "concat" else pm.fused_forward
        got = fn(torch.from_numpy(tiny["x"])).numpy()
    want = tiny[kind][ref]
    assert got.dtype == np.float32
    if kind == "f32":
        assert np.abs(got - want).max() <= 2e-4 * np.abs(want).max()
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    else:
        assert np.abs(got - want).max() <= 3e-2 * np.abs(want).max()


def test_fused_forward_packs_the_current_weights(tiny):
    """A state dict loaded after a fused forward takes effect in the next:
    the blocks are folded and packed from the parameters at every call."""
    pm = port_densenet.DenseNet(**TINY).eval()
    x = torch.from_numpy(tiny["x"])
    with torch.no_grad():
        before = pm.fused_forward(x)
        pm.load_state_dict(convert.state_dict_from_flax(tiny["f32"]["flat"]))
        after = pm.fused_forward(x).numpy()
    assert not np.allclose(before.numpy(), after)
    want = tiny["f32"]["module"]
    assert np.abs(after - want).max() <= 2e-4 * np.abs(want).max()


def test_bridge_is_inverse_of_jax_converter(tiny):
    """Flax → the port's torchvision-named state dict → the JAX package's
    torch→Flax converter gives back every tensor unchanged."""
    flat = tiny["f32"]["flat"]
    sd = convert.state_dict_from_flax(flat)
    assert tuple(sd["features.denseblock2.denselayer2.conv2.weight"].shape) == (8, 32, 3, 3)
    assert "features.transition1.norm.running_var" in sd
    variables = unflatten({k: np.zeros_like(v) for k, v in flat.items()})
    back, missing = convert_state_dict({k: v.numpy() for k, v in sd.items()}, variables,
                                       "DenseNet")
    assert missing == []
    for name, value in flatten(back).items():
        np.testing.assert_array_equal(np.asarray(value), flat[name])
    assert set(sd) == set(port_densenet.DenseNet(**TINY).state_dict())


def test_densenet121_config_and_torchvision_checkpoint_reach_the_model(tmp_path):
    """``densenet121``'s config block builds DenseNet-121 through the solver
    (58 dense layers, 1024 features into the classifier), and a
    torchvision-named checkpoint under ``saver.pretrain.path`` loads in
    full. In bf16 the convolutions follow the dtype; BatchNorm and the
    classifier stay f32. ``probe_init`` moves the BatchNorms off identity."""
    src = create_classifier("densenet121", seed=5, device="cpu", probe_init=True,
                            dtype=torch.bfloat16).model
    norm = src.features.denseblock3.denselayer7.norm1
    assert not torch.equal(norm.running_var, torch.ones_like(norm.running_var))
    path = tmp_path / "densenet.pth"
    torch.save({"state_dict": {f"module.{k}": v for k, v in src.state_dict().items()}}, path)
    cfg = load_config("exprs/robust_baseline_exp/densenet/densenet121/config.yaml")
    cfg = PortConfig({"model": {**dict(cfg.model), "dtype": "bf16"}, "seed": 0,
                      "saver": {"pretrain": {"path": str(path)}}})
    model = PortSolver(cfg, device="cpu").build_model(seed=0).model
    assert sum(len(block) for block, _ in model._blocks()) == 58
    assert model.classifier.in_features == 1024
    assert model.features.conv0.weight.dtype == torch.bfloat16
    assert model.features.norm5.weight.dtype == model.classifier.weight.dtype == torch.float32
    for name, value in src.state_dict().items():
        assert torch.equal(model.state_dict()[name], value), name
    names = {"densenet121", "densenet169", "densenet201"}
    assert names <= set(port_registry.model_names()) & set(jax_registry.model_names())
