"""The port's transformer block kernels K6, K7, K8 (their plain versions and
the compositions the CUDA wrappers launch) against the JAX package.

Inputs are drawn with numpy and handed to both; the port's weights are the
JAX weights transposed to nn.Linear's (out, in) layout. Tolerance at f32:
max|Δ| ≤ 1e-5·max|ref| (the two libraries sum the products in different
orders). The Pallas kernels run in interpret mode, as the JAX package's own
tests run them on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustart_torch.ops import attention as pa
from robustart_torch.ops import mlp as pm
from robustart_tpu.ops import pallas_attention as ja
from robustart_tpu.ops import pallas_mlp as jm

TOL = 1e-5


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= tol, err


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _block_args(bnw, n, h, d, seed, with_bias, with_mask, num_windows=2):
    rng = np.random.default_rng(seed)
    c = h * d

    def arr(*shape, s=1.0):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    x = arr(bnw, n, c)
    ln = (arr(c, s=0.2) + 1.0, arr(c, s=0.1))
    ws = [arr(c, c, s=c ** -0.5) for _ in range(4)]  # JAX (in, out)
    bs = [arr(c, s=0.05) for _ in range(4)]
    rel = arr(h, n, n, s=0.5) if with_bias else np.zeros((h, 1, 1), np.float32)
    mask = None
    if with_mask:
        mask = np.where(rng.uniform(size=(num_windows, n, n)) < 0.3, -100.0, 0.0)
        mask = mask.astype(np.float32)
    return x, ln, ws, bs, rel, mask


def _jax_block(fn, x, ln, ws, bs, rel, mask, **kw):
    j = jnp.asarray
    return np.asarray(fn(j(x), j(ln[0]), j(ln[1]), j(ws[0]), j(bs[0]), j(ws[1]), j(bs[1]),
                         j(ws[2]), j(bs[2]), j(ws[3]), j(bs[3]), j(rel),
                         None if mask is None else j(mask), **kw))


def _port_block(fn, x, ln, ws, bs, **kw):
    wt = [_t(w.T) for w in ws]
    return fn(_t(x), _t(ln[0]), _t(ln[1]), wt[0], _t(bs[0]), wt[1], _t(bs[1]), wt[2],
              _t(bs[2]), wt[3], _t(bs[3]), **kw)


@pytest.mark.parametrize("with_bias,with_mask", [(False, False), (True, False), (True, True)])
def test_window_block_reference_matches_jax(with_bias, with_mask):
    """K6's plain version with the JAX reference's full semantics: Swin's
    relative-position bias and each window position's shift mask."""
    args = _block_args(4, 17, 4, 32, 0, with_bias, with_mask)
    x, ln, ws, bs, rel, mask = args
    ref = _jax_block(ja.window_block_reference, *args, num_windows=2, eps=1e-6)
    got = _port_block(pa.window_block_reference, x, ln, ws, bs,
                      rel_bias=_t(rel) if with_bias else None,
                      mask=_t(mask) if with_mask else None, num_heads=4, num_windows=2,
                      eps=1e-6)
    _close(got.numpy(), ref)


def test_window_block_matches_pallas_interpret():
    """The ViT form (one window per image, (H, 1, 1) zero bias) against the
    Pallas kernel in interpret mode; the wrapper, on CPU tensors, gives its
    plain version and counts no launch."""
    args = _block_args(2, 17, 4, 32, 1, False, False)
    ref = _jax_block(ja.window_block_pallas, *args, num_windows=1, eps=1e-6, interpret=True)
    before = pa.window_block.launches
    x, ln, ws, bs, rel, _ = args
    got = _port_block(pa.window_block, x, ln, ws, bs, rel_bias=_t(rel),
                      eps=1e-6)
    assert pa.window_block.launches == before
    _close(got.numpy(), ref)


def test_fused_window_block_composition_matches_reference():
    """The three launches K6 makes on CUDA (LN + packed q/k/v product,
    attention core on the packed views, proj + residual), each through its
    plain version here: the orchestration agrees with the reference."""
    x, ln, ws, bs, _, _ = _block_args(3, 50, 3, 64, 2, False, False)
    wt = [_t(w.T) for w in ws]
    w_qkv = torch.cat(wt[:3])
    for qkv_bias in (True, False):
        b = [_t(v) if qkv_bias else None for v in bs[:3]]
        b_qkv = torch.cat(b) if qkv_bias else None
        args = (_t(x), _t(ln[0]), _t(ln[1]), wt[0], b[0], wt[1], b[1], wt[2], b[2], wt[3],
                _t(bs[3]))
        ref = pa.window_block_reference(*args, num_heads=3, eps=1e-6)
        packed = (_t(x), _t(ln[0]), _t(ln[1]), w_qkv, b_qkv, wt[3], _t(bs[3]))
        got = pa.fused_window_block(*packed, num_heads=3, eps=1e-6)
        _close(got.numpy(), ref.numpy())
        before = pa.window_block.launches
        assert torch.equal(pa.window_block_qkv(*packed, num_heads=3, eps=1e-6), ref)
        assert pa.window_block.launches == before


def _mlp_args(m, c, f, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, c)).astype(np.float32)
    w1 = (rng.standard_normal((c, f)) * c ** -0.5).astype(np.float32)
    w2 = (rng.standard_normal((f, c)) * f ** -0.5).astype(np.float32)
    b1 = (rng.standard_normal(f) * 0.1).astype(np.float32)
    b2 = (rng.standard_normal(c) * 0.1).astype(np.float32)
    ln = ((rng.standard_normal(c) * 0.2 + 1).astype(np.float32),
          (rng.standard_normal(c) * 0.1).astype(np.float32))
    return x, w1, b1, w2, b2, ln


@pytest.mark.parametrize("with_ln,residual", [(False, False), (True, False), (True, True)])
def test_mlp_reference_matches_jax(with_ln, residual):
    """K7's plain version against ``mlp_reference`` (exact erf); the JAX
    reference takes no residual, its kernel adds the raw x in f32."""
    x, w1, b1, w2, b2, ln = _mlp_args(34, 96, 384, 3)
    jln = (jnp.asarray(ln[0]), jnp.asarray(ln[1])) if with_ln else None
    ref = np.asarray(jm.mlp_reference(jnp.asarray(x), jnp.asarray(w1), jnp.asarray(b1),
                                      jnp.asarray(w2), jnp.asarray(b2), ln=jln))
    if residual:
        ref = ref + x
    got = pm.mlp_reference(_t(x), _t(w1.T), _t(b1), _t(w2.T), _t(b2),
                           ln=(_t(ln[0]), _t(ln[1])) if with_ln else None,
                           residual=_t(x) if residual else None)
    _close(got.numpy(), ref)


def test_mlp_matches_pallas_interpret():
    """K7 as ViT calls it (LN prologue, raw-x residual) against the Pallas
    kernel in interpret mode, whose polynomial erf is within 1.5e-7 of the
    exact one; the CPU wrapper counts no launch and the composition of the
    two CUDA launches agrees."""
    x, w1, b1, w2, b2, ln = _mlp_args(34, 128, 512, 4)
    x3 = x.reshape(2, 17, 128)
    ref = np.asarray(jm.mlp_pallas(jnp.asarray(x3), jnp.asarray(w1), jnp.asarray(b1),
                                   jnp.asarray(w2), jnp.asarray(b2),
                                   ln=(jnp.asarray(ln[0]), jnp.asarray(ln[1])),
                                   residual_input=True, interpret=True))
    args = (_t(x3), _t(w1.T), _t(b1), _t(w2.T), _t(b2))
    before = pm.mlp.launches
    got = pm.mlp(*args, ln=(_t(ln[0]), _t(ln[1])), residual=args[0])
    assert pm.mlp.launches == before
    _close(got.numpy(), ref)
    composed = pm.fused_mlp(*args, (_t(ln[0]), _t(ln[1])), 1e-6, args[0])
    assert torch.equal(composed, got)


def test_mlp_refuses_convnext_and_clip_forms():
    """An activation the JAX package does not know is refused with its
    ValueError (CLIP's quick_gelu is one of the four it takes); ConvNeXt's
    layer-scale and residual are taken since they were ported
    (tests/test_torch_port_window_ops.py holds them to the JAX package)."""
    x, w1, b1, w2, b2, _ = (_t(a) if isinstance(a, np.ndarray) else a
                            for a in _mlp_args(4, 32, 64, 5))
    with pytest.raises(ValueError, match="unknown act 'swish'"):
        pm.mlp(x, w1.t(), b1, w2.t(), b2, act="swish")
    with pytest.raises(ValueError, match="unknown act 'swish'"):
        jm.mlp_reference(*(jnp.asarray(a.numpy()) for a in (x, w1, b1, w2, b2)), act="swish")
    got = pm.mlp(x, w1.t(), b1, w2.t(), b2, gamma=b2, residual=x)
    plain = pm.mlp(x, w1.t(), b1, w2.t(), b2)  # fc2 + b2, before gamma and the residual
    torch.testing.assert_close(got, plain * b2 + x, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("act", ["gelu", "gelu_tanh", "quick_gelu", "relu"])
def test_mlp_activations_match_jax(act):
    """Each of the JAX package's four activations: K7's plain version
    against ``mlp_reference`` and against the Pallas kernel in interpret
    mode (ViT's form: LN prologue, raw-x residual), at f32 within
    1e-5·max|ref| (the kernel's polynomial erf is within 1.5e-7 of the exact
    one); the CPU wrapper gives the plain version."""
    x, w1, b1, w2, b2, ln = _mlp_args(34, 128, 512, 9)
    j = jnp.asarray
    jln = (j(ln[0]), j(ln[1]))
    ref = np.asarray(jm.mlp_reference(j(x), j(w1), j(b1), j(w2), j(b2), act=act, ln=jln))
    x3 = x.reshape(2, 17, 128)
    kernel = np.asarray(jm.mlp_pallas(j(x3), j(w1), j(b1), j(w2), j(b2), act=act, ln=jln,
                                      residual_input=True, interpret=True))
    args = (_t(w1.T), _t(b1), _t(w2.T), _t(b2))
    pln = (_t(ln[0]), _t(ln[1]))
    _close(pm.mlp_reference(_t(x), *args, ln=pln, act=act).numpy(), ref)
    got = pm.mlp(_t(x3), *args, ln=pln, residual=_t(x3), act=act)
    _close(got.numpy(), kernel)
    assert torch.equal(pm.fused_mlp(_t(x3), *args, pln, 1e-6, _t(x3), act=act), got)


def _qkv(b, n, h, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, n, h, d)).astype(np.float32) for _ in range(3)]


def test_mha_reference_matches_einsum_form():
    """K8 has no named reference in the JAX package: its plain version is
    held to the einsum form of ``models/vit.py:145-155`` at f32."""
    q, k, v = _qkv(2, 17, 4, 32, 6)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    attn = jnp.einsum("bqhd,bkhd->bhqk", jq * (1.0 / np.sqrt(32)), jk)
    attn = jnp.exp(attn - attn.max(-1, keepdims=True))
    attn = attn / attn.sum(-1, keepdims=True)
    ref = np.asarray(jnp.einsum("bhqk,bkhd->bqhd", attn, jv))
    _close(pa.mha_reference(_t(q), _t(k), _t(v)).numpy(), ref)


def test_mha_matches_pallas_interpret():
    q, k, v = _qkv(2, 17, 4, 32, 7)
    ref = np.asarray(ja.mha_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   interpret=True))
    before = pa.mha.launches
    got = pa.mha(_t(q), _t(k), _t(v))
    assert pa.mha.launches == before
    _close(got.numpy(), ref)


def test_attention_core_takes_packed_views():
    """The strided q/k/v views of a packed (B, N, 3, H, D) product give what
    contiguous copies give, in both score modes."""
    rng = np.random.default_rng(8)
    qkv = _t(rng.standard_normal((2, 50, 3, 3, 64)).astype(np.float32))
    views = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    for round_scores in (False, True):
        a = pa.attention_core(*views, round_scores=round_scores)
        b = pa.attention_core(*(t.contiguous() for t in views), round_scores=round_scores)
        assert torch.equal(a, b) and a.is_contiguous()


@pytest.mark.parametrize("c,h", [(768, 12), (192, 3), (384, 6), (128, 4), (96, 3),
                                 (1024, 16), (512, 16)])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_block_kernel_head_groups_is_the_jax_policy(c, h, itemsize):
    assert pa.block_kernel_head_groups(c, h, itemsize) == ja.block_kernel_head_groups(
        c, h, itemsize)


def test_attention_core_plain_matches_pallas_at_clip_tokens():
    """CLIP-L/14's 257 tokens (one past the old 256 cap): the port's plain
    core, which the CUDA core is held to on the card, against the Pallas
    kernel in interpret mode, at 1 image × 2 heads of 64."""
    q, k, v = _qkv(1, 257, 2, 64, 10)
    ref = np.asarray(ja.mha_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   interpret=True))
    _close(pa.mha(_t(q), _t(k), _t(v)).numpy(), ref)


def test_window_block_matches_pallas_interpret_past_256_tokens():
    """K6 at 260 tokens with a (H, N, N) bias against the Pallas kernel in
    interpret mode, and the three launches' composition (each step's plain
    version here) against the plain block."""
    args = _block_args(1, 260, 2, 32, 11, True, False)
    x, ln, ws, bs, rel, _ = args
    ref = _jax_block(ja.window_block_pallas, *args, num_windows=1, eps=1e-6, interpret=True)
    got = _port_block(pa.window_block, x, ln, ws, bs, rel_bias=_t(rel), eps=1e-6)
    _close(got.numpy(), ref)
    wt = [_t(w.T) for w in ws]
    composed = pa.fused_window_block(_t(x), _t(ln[0]), _t(ln[1]), torch.cat(wt[:3]),
                                     torch.cat([_t(b) for b in bs[:3]]), wt[3], _t(bs[3]),
                                     _t(rel), num_heads=2, eps=1e-6)
    _close(composed.numpy(), ref)


@pytest.mark.parametrize("n", [1, 49, 197, 257, 577])
@pytest.mark.parametrize("d,padded", [(8, 32), (32, 32), (64, 64), (80, 128), (128, 128)])
def test_core_plan_takes_any_tokens_and_head_widths(n, d, padded):
    """The core's tile arithmetic: any N (64-row query blocks, the last
    ragged), any D that is a multiple of 8 up to 128, zero-padded to the
    compiled width that holds it."""
    plan = pa.core_plan(n, d)
    assert plan == {"head_dim_padded": padded, "query_tiles": -(-n // 64)}
    assert (plan["query_tiles"] - 1) * pa.CORE_TILE < n <= plan["query_tiles"] * pa.CORE_TILE


@pytest.mark.parametrize("d", [136, 36, 0])
def test_core_plan_refuses_head_widths_it_cannot_take(d):
    with pytest.raises(ValueError, match="multiple of 8 up to 128"):
        pa.core_plan(197, d)


def test_gemm_plan_boxes_grid_and_rows():
    """The product's tile arithmetic: 64 × 128 TMA boxes, 128 × 128 output
    tiles over (N, M) with the ragged ones counted, 16-byte rows (K a
    multiple of 8, so K = 200 is taken where the old kernel wanted 32; in
    bf16 N too, for the TMA stores; f32 takes any N)."""
    from robustart_torch.ops import linear

    vit = linear.gemm_plan(25_216, 3072, 768, 2)
    assert vit == {"box": (64, 128), "tiles": (24, 197)}
    assert linear.gemm_plan(150, 192, 200, 2) == {"box": (64, 128), "tiles": (2, 2)}
    assert linear.gemm_plan(401_408, 384, 128, 2)["tiles"] == (3, 3136)
    assert linear.gemm_plan(401_408, 512, 24, 4)["tiles"] == (4, 3136)
    for k in (100, 12):
        with pytest.raises(ValueError, match="K a multiple of 8"):
            linear.gemm_plan(64, 64, k, 2)
    with pytest.raises(ValueError, match="N a multiple of 8"):
        linear.gemm_plan(64, 10, 64, 2)
    assert linear.gemm_plan(64, 10, 64, 4)["tiles"] == (1, 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_linear_fused_scale_form_matches_torch(dtype):
    """The dense block's epilogue form relu(acc·scale + bias), one cast,
    equals the direct torch expression on the same working-type inputs,
    bitwise (the same f32 steps in the same order), through the plain
    version and the wrapper on the CPU; the wrapper refuses the form with
    anything else in the epilogue."""
    from robustart_torch.ops import linear

    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.normal(0, 1, (37, 64)).astype(np.float32)).to(dtype)
    w = torch.from_numpy(rng.normal(0, 0.125, (48, 64)).astype(np.float32)).to(dtype)
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, 48).astype(np.float32))
    shift = torch.from_numpy(rng.normal(0, 0.1, 48).astype(np.float32))
    want = torch.relu(torch.matmul(x.float(), w.float().t()) * scale + shift).to(dtype)
    assert torch.equal(linear.linear_fused_reference(x, w, shift, scale=scale, act="relu"), want)
    assert torch.equal(linear.linear_fused(x, w, shift, scale=scale, act="relu"), want)
    for kw in ({"act": None}, {"act": "gelu"}, {"act": "relu", "gamma": scale},
               {"act": "relu", "residual": want}, {"act": "relu", "ln": (scale[:1], shift[:1])}):
        with pytest.raises(ValueError, match="scale form"):
            linear.linear_fused(x, w, shift, scale=scale, **kw)
