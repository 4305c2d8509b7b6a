"""The port's Swin and ConvNeXt kernel forms against the JAX package: K9
(window attention), K6 with Swin's bias and mask at head width 32, K7 with
ConvNeXt's layer-scale and shortcut, and K11 (depthwise 7×7 + LayerNorm),
each through its plain version and through the composition of steps its
CUDA wrapper launches, run here on CPU tensors.

Inputs are drawn with numpy and handed to both; the port's weights are the
JAX weights in torch's layouts. The Pallas kernels run in interpret mode, as
the JAX package's own tests run them on the CPU. Tolerance at f32:
max|Δ| ≤ 1e-5·max|ref| (the two libraries sum in different orders). In
bf16, one bf16 ulp of max|ref| where each output is rounded once from f32
sums taken in another order (K9, K11); two for K6, whose reference also
rounds q·scale, the scores and the attention output to bf16 on the way, so
that a sum landing on the other side of a rounding step moves the output by
at most one more ulp.
"""

import tests.torch_port_threads  # noqa: F401  (before any torch work)
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustart_torch.ops import attention as pa
from robustart_torch.ops import convnext as pc
from robustart_torch.ops import mlp as pm
from robustart_tpu.ops import pallas_attention as ja
from robustart_tpu.ops import pallas_convnext as jc
from robustart_tpu.ops import pallas_mlp as jm

TOL = 1e-5
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _close(got, ref, ulps=0):
    """f32 (``ulps`` = 0): 1e-5 of max|ref|; bf16: ``ulps`` bf16 ulps of it."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    top = np.abs(ref).max()
    tol = TOL * top if not ulps else ulps * 2.0 ** (math.floor(math.log2(top)) - 7)
    err = np.abs(got - ref).max()
    assert err <= tol, (err, tol)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _j(a, dtype=jnp.float32):
    return jnp.asarray(a).astype(dtype)


def _f32(t):
    return t.float().numpy()


def _swin_bias_mask(rng, h, n, nw):
    rel = (rng.standard_normal((h, n, n)) * 0.5).astype(np.float32)
    mask = np.where(rng.uniform(size=(nw, n, n)) < 0.3, -100.0, 0.0).astype(np.float32)
    return rel, mask


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_window_mha_matches_pallas_interpret(masked, kind):
    """K9 at Swin-T's head width: 8 windows of 49 tokens (2 images of 4
    window positions), 3 heads of 32. The CPU wrapper gives its plain
    version and counts no launch; the core the CUDA wrapper launches agrees
    on the strided views of a packed q/k/v product."""
    jdt, tdt = DTYPES[kind]
    rng = np.random.default_rng(0)
    bnw, n, h, d, nw = 8, 49, 3, 32, 4
    q, k, v = (rng.standard_normal((bnw, n, h, d)).astype(np.float32) for _ in range(3))
    rel, mask = _swin_bias_mask(rng, h, n, nw)
    mask = mask if masked else None
    ref = ja.window_mha_pallas(_j(q, jdt), _j(k, jdt), _j(v, jdt), _j(rel),
                               None if mask is None else _j(mask), num_windows=nw,
                               interpret=True)
    tq, tk, tv = _t(q, tdt), _t(k, tdt), _t(v, tdt)
    tm = None if mask is None else _t(mask)
    before = pa.window_mha.launches
    got = pa.window_mha(tq, tk, tv, _t(rel), tm, num_windows=nw)
    assert pa.window_mha.launches == before
    _close(_f32(got), np.asarray(ref, np.float32), ulps=0 if kind == "f32" else 1)
    packed = torch.stack([tq, tk, tv], dim=2)
    core = pa.attention_core(packed[:, :, 0], packed[:, :, 1], packed[:, :, 2], _t(rel), tm,
                             num_windows=nw)
    assert torch.equal(core, got)


def _block(rng, bnw, n, c):
    def arr(*shape, s=1.0):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    x = arr(bnw, n, c)
    ln = (arr(c, s=0.2) + 1.0, arr(c, s=0.1))
    ws = [arr(c, c, s=c ** -0.5) for _ in range(4)]  # JAX (in, out)
    bs = [arr(c, s=0.05) for _ in range(4)]
    return x, ln, ws, bs


@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_window_block_swin_form_matches_jax(kind):
    """K6 in Swin-B's stage-0 form: C = 128, 4 heads of 32, 49 tokens, the
    relative-position bias and the shift mask of 2 window positions. At f32
    against the Pallas kernel in interpret mode; in bf16 against the JAX
    reference, the definition whose q·scale rounding at D = 32 the kernel
    follows. The packed entry and the three steps of the CUDA wrapper agree."""
    jdt, tdt = DTYPES[kind]
    rng = np.random.default_rng(1)
    c, h, n, nw = 128, 4, 49, 2
    x, ln, ws, bs = _block(rng, 4, n, c)
    rel, mask = _swin_bias_mask(rng, h, n, nw)
    jargs = (_j(x, jdt), _j(ln[0]), _j(ln[1]), _j(ws[0], jdt), _j(bs[0]), _j(ws[1], jdt),
             _j(bs[1]), _j(ws[2], jdt), _j(bs[2]), _j(ws[3], jdt), _j(bs[3]), _j(rel), _j(mask))
    if kind == "f32":
        ref = ja.window_block_pallas(*jargs, num_windows=nw, eps=1e-5, interpret=True)
    else:
        ref = ja.window_block_reference(*jargs, num_windows=nw, eps=1e-5)
    wt = [_t(w.T, tdt) for w in ws]
    tb = [_t(b) for b in bs]
    blk = (_t(x, tdt), _t(ln[0]), _t(ln[1]), wt[0], tb[0], wt[1], tb[1], wt[2], tb[2], wt[3],
           tb[3], _t(rel), _t(mask))
    before = pa.window_block.launches
    got = pa.window_block(*blk, num_windows=nw, eps=1e-5)
    assert pa.window_block.launches == before
    _close(_f32(got), np.asarray(ref, np.float32), ulps=0 if kind == "f32" else 2)
    packed = (blk[0], blk[1], blk[2], torch.cat(wt[:3]), torch.cat(tb[:3]), wt[3], tb[3],
              _t(rel), _t(mask))
    assert torch.equal(pa.window_block_qkv(*packed, num_heads=h, num_windows=nw, eps=1e-5), got)
    composed = pa.fused_window_block(*packed, num_heads=h, num_windows=nw, eps=1e-5)
    _close(_f32(composed), _f32(got), ulps=0 if kind == "f32" else 1)


def test_window_block_bf16_rounds_scaled_q():
    """The D = 32 trap: the JAX reference rounds q·(1/√32) to bf16 before
    the product. The port's plain version does too, and its bf16 scores
    equal the reference's but for under 1% (f32 sums in another order that
    round the other way); without that rounding more than 1% differ."""
    rng = np.random.default_rng(2)
    bnw, n, h, d = 4, 49, 4, 32
    q, k, v = (rng.standard_normal((bnw, n, h, d)).astype(np.float32) for _ in range(3))
    tq, tk, tv = (_t(a, torch.bfloat16) for a in (q, k, v))
    scale = 1.0 / np.sqrt(d)  # a numpy scalar, as in the reference: q·scale in f32
    jq, jk = _j(q, jnp.bfloat16), _j(k, jnp.bfloat16)
    ref = np.asarray(jnp.einsum("bqhd,bkhd->bhqk", (jq * scale).astype(jnp.bfloat16), jk),
                     np.float32)
    rounded = torch.einsum("bqhd,bkhd->bhqk", (tq.float() * scale).to(torch.bfloat16).float(),
                           tk.float()).to(torch.bfloat16).float()
    unrounded = (torch.einsum("bqhd,bkhd->bhqk", tq.float(), tk.float()) * scale).to(
        torch.bfloat16).float()
    differ_r = (rounded.numpy() != ref).mean()
    differ_u = (unrounded.numpy() != ref).mean()
    assert differ_r < 0.01 < differ_u, (differ_r, differ_u)
    core = pa.attention_core_reference(tq, tk, tv, round_scores=True)
    p = torch.softmax(rounded, -1).to(torch.bfloat16).float()
    want = torch.einsum("bhqk,bkhd->bqhd", p, tv.float()).to(torch.bfloat16)
    _close(_f32(core), _f32(want), ulps=1)


def _mlp_args(rng, m, c, f):
    x = rng.standard_normal((m, c)).astype(np.float32)
    w1 = (rng.standard_normal((c, f)) * c ** -0.5).astype(np.float32)
    w2 = (rng.standard_normal((f, c)) * f ** -0.5).astype(np.float32)
    b1 = (rng.standard_normal(f) * 0.1).astype(np.float32)
    b2 = (rng.standard_normal(c) * 0.1).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, c).astype(np.float32)
    shortcut = rng.standard_normal((m, c)).astype(np.float32)
    return x, w1, b1, w2, b2, gamma, shortcut


def test_mlp_convnext_form_matches_jax():
    """K7 as ConvNeXt calls it (no LN, layer-scale gamma, a separate
    shortcut) against ``mlp_reference`` and the Pallas kernel in interpret
    mode (polynomial erf within 1.5e-7 of the exact one); the CPU wrapper
    counts no launch and the two CUDA launches' composition agrees."""
    x, w1, b1, w2, b2, gamma, sc = _mlp_args(np.random.default_rng(3), 2 * 6 * 6, 64, 256)
    jargs = [jnp.asarray(a) for a in (x, w1, b1, w2, b2)]
    ref = np.asarray(jm.mlp_reference(*jargs, gamma=jnp.asarray(gamma),
                                      shortcut=jnp.asarray(sc)))
    kernel = np.asarray(jm.mlp_pallas(*jargs, gamma=jnp.asarray(gamma), shortcut=jnp.asarray(sc),
                                      interpret=True))
    shape = (2, 6, 6, 64)
    args = (_t(x).reshape(shape), _t(w1.T), _t(b1), _t(w2.T), _t(b2))
    kw = {"gamma": _t(gamma), "residual": _t(sc).reshape(shape)}
    _close(pm.mlp_reference(*args, **kw).reshape(-1, 64).numpy(), ref)
    before = pm.mlp.launches
    got = pm.mlp(*args, **kw)
    assert pm.mlp.launches == before
    _close(got.reshape(-1, 64).numpy(), kernel)
    composed = pm.fused_mlp(*args, None, 1e-6, kw["residual"], kw["gamma"])
    assert torch.equal(composed, got)


def test_mlp_refuses_quick_gelu_and_double_residual():
    """An activation the JAX package does not know is refused (CLIP's
    quick_gelu is taken: tests/test_torch_port_transformer_ops.py holds it to
    the JAX package), and so is a residual that is not of x's shape: here
    two stacked copies of the shortcut."""
    x, w1, b1, w2, b2, gamma, sc = (_t(a) for a in _mlp_args(np.random.default_rng(4), 4, 32,
                                                             64))
    with pytest.raises(ValueError, match="unknown act 'quick_gelu2'"):
        pm.mlp(x, w1.t(), b1, w2.t(), b2, act="quick_gelu2")
    assert pm.mlp(x, w1.t(), b1, w2.t(), b2, act="quick_gelu").shape == x.shape
    with pytest.raises(ValueError, match="residual"):
        pm.mlp(x, w1.t(), b1, w2.t(), b2, residual=torch.cat([sc, sc]))


def _dwconv_args(rng, shape):
    c = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32)
    w = (rng.standard_normal((7, 7, 1, c)) / 7.0).astype(np.float32)  # JAX (7, 7, 1, C)
    b, beta = ((rng.standard_normal(c) * 0.1).astype(np.float32) for _ in range(2))
    gamma = rng.uniform(0.5, 1.5, c).astype(np.float32)
    return x, w, b, gamma, beta


@pytest.mark.parametrize("shape", [(2, 14, 14, 32), (2, 7, 7, 64)])
@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_dwconv_ln_matches_pallas_interpret(shape, kind):
    """K11 against the Pallas kernel in interpret mode, the weights in
    ``nn.Conv2d(C, C, 7, groups=C)``'s (C, 1, 7, 7); the CPU wrapper counts
    no launch."""
    jdt, tdt = DTYPES[kind]
    x, w, b, gamma, beta = _dwconv_args(np.random.default_rng(5), shape)
    ref = jc.dwconv_ln_pallas(_j(x, jdt), _j(w), _j(b), _j(gamma), _j(beta), interpret=True)
    before = pc.dwconv_ln.launches
    got = pc.dwconv_ln(_t(x, tdt), _t(w.transpose(3, 2, 0, 1)), _t(b), _t(gamma), _t(beta))
    assert pc.dwconv_ln.launches == before and got.dtype == tdt
    _close(_f32(got), np.asarray(ref, np.float32), ulps=0 if kind == "f32" else 1)


def test_dwconv_ln_taps_are_the_pallas_layout():
    """The (49, C) tap table the plain version multiplies by is the Pallas
    kernel's ``w.reshape(49, C)`` of the (7, 7, 1, C) weights (the CUDA
    kernel reads the (C, 1, 7, 7) weights as they are)."""
    _, w, _, _, _ = _dwconv_args(np.random.default_rng(6), (1, 7, 7, 32))
    taps = pc._taps(_t(w.transpose(3, 2, 0, 1)))
    np.testing.assert_array_equal(taps.numpy(), w.reshape(49, 32))
    with pytest.raises(ValueError, match="7, 7"):
        pc._taps(torch.zeros((32, 1, 3, 3)))


# ConvNeXt-B's four stages at batch 128, and shapes whose H and W divide
# neither the band nor the 2 × 7 patch (C = 96 and 544: 16-lane groups; 544
# and 1024: channels split over a cluster; W = 15: three column tiles; W =
# 300 at C = 32: fewer column groups than threads allow, for the ring to fit)
PLAN_SHAPES = [(128, 56, 56, 128), (128, 28, 28, 256), (128, 14, 14, 512), (128, 7, 7, 1024),
               (3, 13, 11, 96), (2, 13, 11, 128), (3, 9, 15, 1024), (3, 7, 7, 544),
               (1, 30, 61, 64), (2, 5, 3, 32), (1, 9, 300, 32)]


@pytest.mark.parametrize("shape", PLAN_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_dwconv_plan_fits_and_covers_every_pixel_once(shape, dtype):
    """K11's launch plan (``csrc/dwconv_ln.cu``): at most 227 KB of shared
    memory and 256 threads a block, and the blocks (image, band, tile,
    cluster rank) × threads (column group, channel pair) × 2 × 7 patch cover
    every (pixel, channel) of x exactly once, the patches past the ragged
    edge aside. The ring's rows fit the staged weights."""
    n, h, w, c = shape
    p = pc.dwconv_plan(n, h, w, c, dtype)
    assert p["smem"] <= 227 * 1024 and p["threads"] == p["groups"] * p["pairs"] <= 256
    assert p["pairs"] % p["lanes"] == 0 and p["band"] % 2 == 0 and p["tile"] == 7 * p["groups"]
    assert p["grid"] == p["cluster"] * p["tiles"] * p["bands"] * n
    size = torch.empty((), dtype=dtype).element_size()
    assert p["boxes"] * 256 >= p["c0"] * size and p["tile"] + 6 <= 256  # TMA boxes
    ring = p["ring"] * p["boxes"] * (p["tile"] + 6) * 256
    assert ring >= p["c0"] * 49 * 4  # the weights pass through the ring's space
    covered = np.zeros((h, w, c), np.int64)
    spans = [(r * p["c0"], min(c, (r + 1) * p["c0"])) for r in range(p["cluster"])]
    assert all(0 < hi - lo <= p["c0"] and (hi - lo) % 32 == 0 for lo, hi in spans)
    for band in range(p["bands"]):
        rows = slice(band * p["band"], min((band + 1) * p["band"], h))
        for tile in range(p["tiles"]):
            for g in range(p["groups"]):
                c0 = tile * p["tile"] + g * 7
                for lo, hi in spans:  # one block a cluster rank, its pairs' channels
                    covered[rows, c0:min(c0 + 7, w), lo:hi] += 1
    assert (covered == 1).all()  # each image alike: the grid repeats it n times


def test_dwconv_plan_refuses_what_the_kernel_does_not_take():
    """C a multiple of 32 up to 1024, a non-empty x, bf16 or f32."""
    for c in (16, 48, 1056):
        with pytest.raises(ValueError, match="multiple of 32"):
            pc.dwconv_plan(1, 7, 7, c, torch.bfloat16)
    with pytest.raises(ValueError, match="positive"):
        pc.dwconv_plan(0, 7, 7, 32, torch.bfloat16)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        pc.dwconv_plan(1, 7, 7, 32, torch.float16)
