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


STAGED = dict(c0=16, growth=8, n_layers=2, mid=16)


@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_dense_block_stages_match_reference_and_pallas(kind):
    """The bf16 path's three launches as plain stages, in the kernels' order
    (the BN1-ReLU pass, the 1×1 product with the relu(acc·g2 + b2) epilogue
    on W1's (mid, c) transposes, the 3×3), at 2 images of 7 × 7, c0 16,
    growth 8, mid 16, 2 layers: equal to the plain version and to the Pallas
    kernel in interpret mode. f32 max|Δ| ≤ 1e-5·max|ref|; bf16 one bf16 ulp
    of max|ref| (the product sums in another order, which may round a t2
    value the other way)."""
    rng = np.random.default_rng(3)
    jdt, tdt = DTYPES[kind]
    c0, g, n, mid = STAGED["c0"], STAGED["growth"], STAGED["n_layers"], STAGED["mid"]
    s = sum(c0 + li * g for li in range(n))
    p = dict(x=rng.normal(0, 1, (2, 7, 7, c0)), g1=rng.uniform(0.5, 1.5, (1, s)),
             b1=rng.normal(0, 0.1, (1, s)), w1=rng.normal(0, 0.3, (s, mid)),
             g2=rng.uniform(0.5, 1.5, (n, mid)), b2=rng.normal(0, 0.1, (n, mid)),
             w2=rng.normal(0, 0.15, (n * 9 * mid, g)))
    names = ("x", "g1", "b1", "w1", "g2", "b2", "w2")
    typed = {"x", "w1", "w2"}
    targs = [torch.from_numpy(p[k]).to(tdt if k in typed else torch.float32) for k in names]
    jargs = [jnp.asarray(p[k], jdt if k in typed else jnp.float32) for k in names]
    got = port_ops.dense_block_stages(*targs, **STAGED)
    assert got.dtype == tdt and tuple(got.shape) == (2, 7, 7, c0 + n * g)
    _within(got.float().numpy(), port_ops.dense_block_reference(*targs, **STAGED).float().numpy(),
            kind)
    ref = pallas_densenet.dense_block_pallas(*jargs, interpret=True, **STAGED)
    _within(got.float().numpy(), ref, kind)


def test_block_plan_scratch_offsets_tiles_and_boxes():
    """The arithmetic of the bf16 path at DenseNet-121's four blocks (B =
    128): scratch at the widest c, offsets in values into the packed
    parameters, ⌈M / 64⌉ tiles of the 3×3, and the product's 64 × 128 boxes
    and one N tile at K = c, 64 … 992; W1's and W2's transposes in the
    kernels' layouts; the blocks the kernels do not take are refused."""
    blocks = ((56, 64, 6), (28, 128, 12), (14, 256, 24), (7, 512, 16))
    ks = set()
    for hw, c0, n in blocks:
        plan = port_ops.block_plan(128, hw, hw, c0=c0, growth=32, n_layers=n, mid=128)
        m = 128 * hw * hw
        assert plan["m"] == m and plan["ctot"] == c0 + 32 * n
        assert plan["a1"] == m * (c0 + 32 * (n - 1)) and plan["t2"] == m * 128
        assert plan["tiles"] == -(-m // 64)
        off = 0
        for li, lay in enumerate(plan["layers"]):
            c = c0 + 32 * li
            assert (lay["c"], lay["bn1"], lay["w1t"]) == (c, off, off * 128)
            assert (lay["bn2"], lay["w2t"]) == (li * 128, li * 9 * 32 * 128)
            assert lay["gemm"] == {"box": (64, 128), "tiles": (1, -(-m // 128))}
            ks.add(c)
            off += c
    assert min(ks) == 64 and max(ks) == 992
    assert port_ops.block_plan(128, 56, 56, c0=64, growth=32, n_layers=6, mid=128)["a1"] == (
        401_408 * 224)
    assert port_ops.block_plan(128, 7, 7, c0=512, growth=32, n_layers=16, mid=128)["tiles"] == 98
    for kw in (dict(c0=12, growth=32, mid=128), dict(c0=64, growth=12, mid=128),
               dict(c0=64, growth=40, mid=128), dict(c0=64, growth=32, mid=136),
               dict(c0=64, growth=32, mid=24)):
        with pytest.raises(ValueError, match="multiple"):
            port_ops.block_plan(2, 7, 7, n_layers=2, **kw)
    w1 = torch.arange(24 * 16, dtype=torch.float32).reshape(24, 16)
    w1t = port_ops.pack_w1t(w1, c0=8, growth=8, n_layers=2, mid=16)
    assert torch.equal(w1t[:128].view(16, 8), w1[:8].t())
    assert torch.equal(w1t[128:].view(16, 16), w1[8:].t())
    # W2 (L·9·mid, g) → (L, 9, ⌈mid/64⌉, 32, 64): each tap's (g, mid) transpose,
    # zero past g and past mid, in 64-wide K slices
    w2 = torch.arange(2 * 9 * 80 * 8, dtype=torch.float32).reshape(2 * 9 * 80, 8)
    w2t = port_ops.pack_w2t(w2, growth=8, n_layers=2, mid=80)
    assert tuple(w2t.shape) == (2, 9, 2, 32, 64)
    taps = w2.reshape(2, 9, 80, 8)
    assert torch.equal(w2t[:, :, 0, :8, :], taps[:, :, :64].transpose(2, 3))
    assert torch.equal(w2t[:, :, 1, :8, :16], taps[:, :, 64:].transpose(2, 3))
    assert not w2t[:, :, :, 8:].any() and not w2t[:, :, 1, :, 16:].any()


def test_fold_bn_matches_jax():
    rng = np.random.default_rng(2)
    w, b, mean = (rng.normal(0, 1, 12).astype(np.float32) for _ in range(3))
    var = rng.uniform(0.5, 2.0, 12).astype(np.float32)
    ref = jax_densenet._fold_bn({"scale": w, "bias": b}, {"mean": mean, "var": var})
    got = port_ops.fold_bn(*(torch.from_numpy(a) for a in (w, b, mean, var)))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def _flax_vars(seed):
    """Flat numpy variables with the BatchNorm statistics jittered (mean +
    N(0, 0.1), var · U(0.5, 2)) and the BatchNorm affines drawn from numpy;
    from the f32 module's init, which every dtype shares."""
    module = jax_densenet.DenseNet(**TINY, concat_impl="concat")
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
    flat = _flax_vars(0)
    for kind, (jdt, _) in DTYPES.items():
        jm = jax_densenet.DenseNet(**TINY, concat_impl="concat", dtype=jdt)
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


@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_fused_forward_reuses_the_pack_until_a_weight_changes(tiny, kind):
    """The second forward reuses the packed blocks (the same tensors); a
    weight changed in place is picked up by the next forward, which then
    agrees with the concat forward (which reads the weights directly). In
    bf16 the pack holds the kernels' W1 and W2 transposes as well. f32
    max|Δlogit| ≤ 2e-4·max|logit|, bf16 3e-2 (as above)."""
    pm = port_densenet.DenseNet(**TINY, dtype=DTYPES[kind][1]).eval()
    pm.load_state_dict(convert.state_dict_from_flax(tiny[kind]["flat"]))
    x = torch.from_numpy(tiny["x"])
    with torch.no_grad():
        first = pm.fused_forward(x)
        packs = [pm._pack_cache[bi][1] for bi in range(2)]
        assert set(packs[0][1]) == (set() if kind == "f32" else {"w1t", "w2t"})
        assert torch.equal(pm.fused_forward(x), first)
        assert all(pm._pack_cache[bi][1] is packs[bi] for bi in range(2))
        pm.features.denseblock2.denselayer1.conv1.weight.mul_(1.5)
        after = pm.fused_forward(x).numpy()
        want = pm.concat_forward(x).numpy()
    assert pm._pack_cache[0][1] is packs[0] and pm._pack_cache[1][1] is not packs[1]
    assert not np.allclose(first.numpy(), after)
    tol = 2e-4 if kind == "f32" else 3e-2
    assert np.abs(after - want).max() <= tol * np.abs(want).max()


def test_fused_forward_of_a_model_made_under_inference_mode():
    """Parameters made under ``torch.inference_mode`` carry no version
    counter: such a model packs its blocks at every forward, and a weight
    changed in place still takes effect."""
    x = torch.from_numpy(np.random.default_rng(4).normal(0, 0.5, (1, SIZE, SIZE, 3))
                         .astype(np.float32))
    with torch.inference_mode():
        pm = port_densenet.DenseNet(**TINY).eval()
        port_densenet.jitter_batch_norms(pm, torch.Generator().manual_seed(0))
        first = pm.fused_forward(x)
        pm.features.denseblock1.denselayer2.conv2.weight.mul_(2.0)
        after, want = pm.fused_forward(x), pm.concat_forward(x)
    assert pm._pack_cache[0][0] is None and not torch.equal(first, after)
    assert (after - want).abs().max() <= 2e-4 * want.abs().max()


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
