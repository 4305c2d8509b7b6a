"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Each test is marked ``gpu`` and skips without CUDA: a CUDA kernel has no CPU
mode. The file imports no JAX, so that on a machine with a card and without
JAX it runs alone (``tests/conftest.py`` imports JAX):

    python -m pytest --noconftest -m gpu tests/test_torch_port_cuda.py

The shapes are odd (3×56×40, 3×31×17; 3 images of 50 tokens at C = 192;
6 Swin windows of 49 tokens, 3 images for K10, K11 and K12, K10 also at
49, 196 and 256 tokens and C = 20 and 768, K12 also at
DenseNet-121's block 1 and block 4 widths) so that no block is full.
K2 and K3 round every step as their plain versions do and K4 and K5 copy or
take minima, so they are held bitwise; K1's plain version divides where
torch's CUDA division multiplies by a reciprocal (``PERF.md``). K6-K12
sum in another order than their plain versions: f32 is held to
max|Δ| ≤ 1e-5·max|ref|, bf16 to one bf16 ulp of max|ref|.
"""

import math

import pytest
import torch

from robustart_torch.noise.corruptions import MOTION_BANK, SNOW_BANK
from robustart_torch.ops import attention as ka
from robustart_torch.ops import build
from robustart_torch.ops import convnext as k11
from robustart_torch.ops import densenet as kd
from robustart_torch.ops import mlp as k7
from robustart_torch.ops import motion as km
from robustart_torch.ops import noise as k1
from robustart_torch.ops import warp as kw

B, H, W = 3, 56, 40


@pytest.fixture()
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


def test_library_name_follows_source_and_flags(tmp_path, monkeypatch):
    """A changed source, shared header or flag set builds a new library,
    never a stale one."""
    a = build.library_path("chamfer")
    assert a.parent == build.BUILD_DIR and a.name.startswith("chamfer-")
    assert a == build.library_path("chamfer") != build.library_path("glass_shuffle")
    assert set(build.KERNELS) == {p.stem for p in build.CSRC.glob("*.cu")}
    assert (build.CSRC / "activation.cuh").exists()
    chamfer = a
    (tmp_path / "k.cu").write_text('#include "shared.cuh"\n')
    (tmp_path / "shared.cuh").write_text("// one\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    before = build.library_path("k")
    (tmp_path / "shared.cuh").write_text("// two\n")
    assert build.library_path("k") != before
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-lineinfo",))
    assert build.library_path("k") not in (before, chamfer)


@pytest.mark.gpu
def test_cuda_fused_noise_matches_plain_version(gen):
    x = torch.randint(0, 256, (B, 31, 17, 3), dtype=torch.uint8, device="cuda",
                      generator=gen)
    before = k1.fused_noise_normalize.launches
    got = k1.fused_noise_normalize(x, 5, noise="gaussian_noise", sigma=0.18)
    ref = k1.fused_noise_normalize_reference(x, 5, noise="gaussian_noise", sigma=0.18)
    torch.cuda.synchronize()
    assert k1.fused_noise_normalize.launches == before + 1
    assert (got != ref).float().mean() <= 1e-4


@pytest.mark.gpu
def test_cuda_warp_matches_plain_version(gen):
    img = torch.rand((B, H, W, 3), device="cuda", generator=gen)
    cy = torch.rand((B, H, W), device="cuda", generator=gen) * 200 - 70
    cx = torch.rand((B, H, W), device="cuda", generator=gen) * 150 - 50
    before = kw.warp_bilinear.launches
    got = kw.warp_bilinear(img, cy, cx)
    torch.cuda.synchronize()
    assert kw.warp_bilinear.launches == before + 1
    assert torch.equal(got, kw.warp_bilinear_reference(img, cy, cx))


@pytest.mark.gpu
@pytest.mark.parametrize("c,radius,sigma,bank", [(3, 20.0, 15.0, MOTION_BANK),
                                                 (1, 12.0, 12.0, SNOW_BANK)])
def test_cuda_motion_taps_matches_plain_version(gen, c, radius, sigma, bank):
    img = torch.rand((B, H, W, c), device="cuda", generator=gen)
    idx = torch.tensor([0, 13, 31], device="cuda")
    rows = km.tap_rows(idx, radius, sigma, bank)
    before = km.motion_taps.launches
    got = km.motion_blur_bank(img, idx, radius, sigma, bank)
    torch.cuda.synchronize()
    assert km.motion_taps.launches == before + 1
    assert torch.equal(got, km.motion_taps_reference(img, *rows))


@pytest.mark.gpu
@pytest.mark.parametrize("d", [1, 4])
def test_cuda_glass_shuffle_matches_plain_version(gen, d):
    x = torch.rand((B, H, W, 3), device="cuda", generator=gen)
    code = torch.randint(0, (2 * d) ** 2, (B, H, W), device="cuda",
                         generator=gen).to(torch.uint8)
    got = km.glass_shuffle(x, code, d)
    torch.cuda.synchronize()
    assert torch.equal(got, km.glass_shuffle_reference(x, code, d))


@pytest.mark.gpu
@pytest.mark.parametrize("iters", [1, 12])
def test_cuda_chamfer_matches_plain_version(gen, iters):
    dist0 = torch.where(torch.rand((B, H, W), device="cuda", generator=gen) < 0.02,
                        0.0, 20.0)
    before = km.chamfer.launches
    got = km.chamfer(dist0, 20.0, iters)
    torch.cuda.synchronize()
    assert km.chamfer.launches == before + iters
    assert torch.equal(got, km.chamfer_reference(dist0, 20.0, iters))


def _within(got, ref):
    """f32: 1e-5 of max|ref|; bf16: one bf16 ulp of max|ref|."""
    top = float(ref.float().abs().max())
    err = float((got.float() - ref.float()).abs().max())
    tol = 1e-5 * top if ref.dtype == torch.float32 else 2.0 ** (math.floor(math.log2(top)) - 7)
    assert err <= tol, (err, tol)


def _block_params(gen, c, dtype):
    def arr(*shape, s=1.0):
        return torch.randn(shape, device="cuda", generator=gen) * s

    w = [arr(c, c, s=c ** -0.5).to(dtype) for _ in range(4)]
    b = [arr(c, s=0.05) for _ in range(4)]
    return arr(c, s=0.2) + 1.0, arr(c, s=0.1), w, b


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_window_block_matches_plain_version(gen, dtype):
    c, h = 192, 3
    x = torch.randn((3, 50, c), device="cuda", generator=gen).to(dtype)
    lns, lnb, w, b = _block_params(gen, c, dtype)
    args = (x, lns, lnb, w[0], b[0], w[1], b[1], w[2], b[2], w[3], b[3])
    before = ka.window_block.launches
    got = ka.window_block(*args, num_heads=h, eps=1e-6)
    ref = ka.window_block_reference(*args, num_heads=h, eps=1e-6)
    torch.cuda.synchronize()
    assert ka.window_block.launches == before + 1
    _within(got, ref)
    packed = ka.window_block_qkv(x, lns, lnb, torch.cat(w[:3]), torch.cat(b[:3]), w[3], b[3],
                                 num_heads=h, eps=1e-6)
    torch.cuda.synchronize()
    assert ka.window_block.launches == before + 2
    assert torch.equal(packed, got)



def _swin_bias_mask(gen, bnw, n, h, nw):
    rel = torch.randn((h, n, n), device="cuda", generator=gen) * 0.5
    mask = torch.where(torch.rand((nw, n, n), device="cuda", generator=gen) < 0.3, -100.0, 0.0)
    return rel, mask


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_window_block_swin_form_matches_plain_version(gen, dtype):
    """K6 with Swin's bias and mask at head width 32: 6 windows (3 images of
    2 window positions), 49 tokens, C = 128, 4 heads."""
    c, h, n = 128, 4, 49
    x = torch.randn((6, n, c), device="cuda", generator=gen).to(dtype)
    lns, lnb, w, b = _block_params(gen, c, dtype)
    rel, mask = _swin_bias_mask(gen, 6, n, h, 2)
    args = (x, lns, lnb, w[0], b[0], w[1], b[1], w[2], b[2], w[3], b[3], rel)
    for m in (None, mask):
        before = ka.window_block.launches
        got = ka.window_block(*args, m, num_windows=2, eps=1e-5)
        ref = ka.window_block_reference(*args, m, num_windows=2, eps=1e-5)
        torch.cuda.synchronize()
        assert ka.window_block.launches == before + 1
        _within(got, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_window_mha_matches_plain_version(gen, dtype):
    """K9 on 6 windows of 49 tokens, 3 heads of 32, with and without the
    mask, and on the strided views of a packed q/k/v product."""
    bnw, n, h, d = 6, 49, 3, 32
    rel, mask = _swin_bias_mask(gen, bnw, n, h, 2)
    packed = torch.randn((bnw, n, 3, h, d), device="cuda", generator=gen).to(dtype)
    q, k, v = packed[:, :, 0], packed[:, :, 1], packed[:, :, 2]
    for m in (None, mask):
        before = ka.window_mha.launches
        got = ka.window_mha(q, k, v, rel, m, num_windows=2)
        ref = ka.window_mha_reference(q, k, v, rel, m, num_windows=2)
        torch.cuda.synchronize()
        assert ka.window_mha.launches == before + 1
        _within(got, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(3, 14, 13, 32), (3, 7, 7, 96)])
def test_cuda_dwconv_ln_matches_plain_version(gen, dtype, shape):
    c = shape[-1]
    x = torch.randn(shape, device="cuda", generator=gen).to(dtype)
    w = torch.randn((c, 1, 7, 7), device="cuda", generator=gen) / 7.0
    b, beta = (torch.randn(c, device="cuda", generator=gen) * 0.1 for _ in range(2))
    gamma = torch.rand(c, device="cuda", generator=gen) + 0.5
    before = k11.dwconv_ln.launches
    got = k11.dwconv_ln(x, w, b, gamma, beta)
    ref = k11.dwconv_ln_reference(x, w, b, gamma, beta)
    torch.cuda.synchronize()
    assert k11.dwconv_ln.launches == before + 1
    _within(got, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_mlp_matches_plain_version(gen, dtype):
    c, f = 192, 768
    x = torch.randn((3, 50, c), device="cuda", generator=gen).to(dtype)
    lns, lnb, _, _ = _block_params(gen, c, dtype)
    w1 = (torch.randn((f, c), device="cuda", generator=gen) * c ** -0.5).to(dtype)
    w2 = (torch.randn((c, f), device="cuda", generator=gen) * f ** -0.5).to(dtype)
    b1 = torch.randn(f, device="cuda", generator=gen) * 0.1
    b2 = torch.randn(c, device="cuda", generator=gen) * 0.1
    gamma = torch.rand(c, device="cuda", generator=gen) + 0.5
    shortcut = torch.randn(x.shape, device="cuda", generator=gen).to(dtype)
    forms = ({"ln": None}, {"ln": (lns, lnb), "residual": x},
             {"gamma": gamma, "residual": shortcut})  # ViT/Swin and ConvNeXt
    for kw in forms:
        before = k7.mlp.launches
        got = k7.mlp(x, w1, b1, w2, b2, **kw)
        ref = k7.mlp_reference(x, w1, b1, w2, b2, **kw)
        torch.cuda.synchronize()
        assert k7.mlp.launches == before + 1
        _within(got, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_mha_matches_plain_version(gen, dtype):
    q, k, v = (torch.randn((3, 50, 3, 64), device="cuda", generator=gen).to(dtype)
               for _ in range(3))
    before = ka.mha.launches
    got = ka.mha(q, k, v)
    torch.cuda.synchronize()
    assert ka.mha.launches == before + 1
    _within(got, ka.mha_reference(q, k, v))
    packed = torch.randn((3, 50, 3, 3, 64), device="cuda", generator=gen).to(dtype)
    views = packed[:, :, 0], packed[:, :, 1], packed[:, :, 2]
    _within(ka.mha(*views), ka.mha_reference(*views))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d", [(257, 64), (577, 64), (197, 128), (49, 32), (70, 80), (1, 64)])
def test_cuda_attention_core_any_tokens_and_widths(gen, dtype, n, d):
    """The key-tiled core past the old 256-token cap (CLIP-L/14's 257,
    ViT-B/16 at 384 px's 577), at D = 128, at a padded D = 80 and at one
    token, in all three score forms: K8's (mha), K9's (bias and mask) and
    K6's (rounded q·scale and scores), each launch counted."""
    b, h = 2, 3
    q, k, v = (torch.randn((b, n, h, d), device="cuda", generator=gen).to(dtype)
               for _ in range(3))
    rel, mask = _swin_bias_mask(gen, b, n, h, 2)
    before = ka.mha.launches, ka.window_mha.launches
    _within(ka.mha(q, k, v), ka.mha_reference(q, k, v))
    _within(ka.window_mha(q, k, v, rel, mask, num_windows=2),
            ka.window_mha_reference(q, k, v, rel, mask, num_windows=2))
    torch.cuda.synchronize()
    assert (ka.mha.launches, ka.window_mha.launches) == (before[0] + 1, before[1] + 1)
    _within(ka.attention_core(q, k, v, rel, round_scores=True),
            ka.attention_core_reference(q, k, v, rel, round_scores=True))


@pytest.mark.gpu
def test_cuda_attention_core_refuses_wide_heads(gen):
    q = torch.randn((1, 10, 1, 136), device="cuda", generator=gen).to(torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 8 up to 128"):
        ka.mha(q, q, q)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["gelu", "gelu_tanh", "quick_gelu", "relu"])
def test_cuda_mlp_activations(gen, dtype, act):
    """K7 with each of the four activations, ViT's form, 3 images of 50
    tokens (150 rows: a ragged 128-row tile) at C = 192."""
    c, f = 192, 768
    x = torch.randn((3, 50, c), device="cuda", generator=gen).to(dtype)
    lns, lnb, _, _ = _block_params(gen, c, dtype)
    w1 = (torch.randn((f, c), device="cuda", generator=gen) * c ** -0.5).to(dtype)
    w2 = (torch.randn((c, f), device="cuda", generator=gen) * f ** -0.5).to(dtype)
    b1 = torch.randn(f, device="cuda", generator=gen) * 0.1
    b2 = torch.randn(c, device="cuda", generator=gen) * 0.1
    kw = {"ln": (lns, lnb), "residual": x, "act": act}
    got = k7.mlp(x, w1, b1, w2, b2, **kw)
    torch.cuda.synchronize()
    _within(got, k7.mlp_reference(x, w1, b1, w2, b2, **kw))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,n", [(150, 96), (333, 200), (7, 24)])
def test_cuda_linear_fused_ragged_with_k200(gen, dtype, m, n):
    """The product at a ragged M and N and K = 200 (a multiple of 8, not of
    32 or 64: TMA zero-fills the last K tile), with and without the
    LayerNorm pass, gamma and a residual."""
    from robustart_torch.ops import linear

    k = 200
    x = torch.randn((m, k), device="cuda", generator=gen).to(dtype)
    w = (torch.randn((n, k), device="cuda", generator=gen) * k ** -0.5).to(dtype)
    bias = torch.randn(n, device="cuda", generator=gen) * 0.1
    gamma = torch.rand(n, device="cuda", generator=gen) + 0.5
    res = torch.randn((m, n), device="cuda", generator=gen).to(dtype)
    ln = (torch.rand(k, device="cuda", generator=gen) + 0.5,
          torch.randn(k, device="cuda", generator=gen) * 0.1)
    for kw in ({}, {"ln": ln, "act": "quick_gelu"}, {"gamma": gamma, "residual": res}):
        got = linear.linear_fused(x, w, bias, **kw)
        torch.cuda.synchronize()
        _within(got, linear.linear_fused_reference(x, w, bias, **kw))


@pytest.mark.gpu
@pytest.mark.parametrize("k", [64, 200])
def test_cuda_linear_fused_many_tiles_a_block(gen, k):
    """The bf16 product's persistent grid at more tiles than two a block on
    any card (38,333 × 264: 300 × 3 tiles, the last row and column of tiles
    ragged), so both consumer warpgroups take several tiles each and the
    ring wraps many times, with the LayerNorm pass and a residual."""
    from robustart_torch.ops import linear

    m, n = 38_333, 264
    x = torch.randn((m, k), device="cuda", generator=gen).to(torch.bfloat16)
    w = (torch.randn((n, k), device="cuda", generator=gen) * k ** -0.5).to(torch.bfloat16)
    bias = torch.randn(n, device="cuda", generator=gen) * 0.1
    res = torch.randn((m, n), device="cuda", generator=gen).to(torch.bfloat16)
    ln = (torch.rand(k, device="cuda", generator=gen) + 0.5,
          torch.randn(k, device="cuda", generator=gen) * 0.1)
    for kw in ({"act": "gelu"}, {"ln": ln, "residual": res}):
        got = linear.linear_fused(x, w, bias, **kw)
        torch.cuda.synchronize()
        _within(got, linear.linear_fused_reference(x, w, bias, **kw))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["gelu_tanh", "quick_gelu", "relu"])
def test_cuda_token_mlp_activations(gen, dtype, act):
    t, c, h = 50, 96, 40
    x = torch.randn((3, t, c), device="cuda", generator=gen).to(dtype)
    w1 = (torch.randn((h, t), device="cuda", generator=gen) * t ** -0.5).to(dtype)
    w2 = (torch.randn((t, h), device="cuda", generator=gen) * h ** -0.5).to(dtype)
    b1 = torch.randn(h, device="cuda", generator=gen) * 0.1
    b2 = torch.randn(t, device="cuda", generator=gen) * 0.1
    got = k7.token_mlp(x, w1, b1, w2, b2, residual_input=True, act=act)
    torch.cuda.synchronize()
    _within(got, k7.token_mlp_reference(x, w1, b1, w2, b2, residual_input=True, act=act))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_token_mlp_matches_plain_version(gen, dtype):
    """K10 at 3 images of 50 tokens, C = 96 (a ragged channel block), hidden
    40: the Mixer's form (LN prologue, raw-x residual), a shortcut, and
    neither."""
    t, c, h = 50, 96, 40
    x = torch.randn((3, t, c), device="cuda", generator=gen).to(dtype)
    lns, lnb, _, _ = _block_params(gen, c, dtype)
    w1 = (torch.randn((h, t), device="cuda", generator=gen) * t ** -0.5).to(dtype)
    w2 = (torch.randn((t, h), device="cuda", generator=gen) * h ** -0.5).to(dtype)
    b1 = torch.randn(h, device="cuda", generator=gen) * 0.1
    b2 = torch.randn(t, device="cuda", generator=gen) * 0.1
    shortcut = torch.randn(x.shape, device="cuda", generator=gen).to(dtype)
    forms = ({"ln": (lns, lnb), "residual_input": True}, {"shortcut": shortcut}, {})
    for kw in forms:
        before = k7.token_mlp.launches
        got = k7.token_mlp(x, w1, b1, w2, b2, **kw)
        ref = k7.token_mlp_reference(x, w1, b1, w2, b2, **kw)
        torch.cuda.synchronize()
        assert k7.token_mlp.launches == before + 1
        _within(got, ref)


def _token_params(gen, t, c, h, dtype):
    """x (3, T, C), LN parameters, W1 (H, T), W2 (T, H), b1, b2 and a
    shortcut for K10."""
    def arr(*shape, s=1.0):
        return torch.randn(shape, device="cuda", generator=gen) * s

    return dict(x=arr(3, t, c).to(dtype), ln=(arr(c, s=0.2) + 1.0, arr(c, s=0.1)),
                w1=arr(h, t, s=t ** -0.5).to(dtype), b1=arr(h, s=0.1),
                w2=arr(t, h, s=h ** -0.5).to(dtype), b2=arr(t, s=0.1),
                shortcut=arr(3, t, c).to(dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("t,c,h", [(49, 20, 40), (50, 96, 384), (196, 768, 384), (256, 96, 40),
                                   (196, 20, 384), (256, 768, 384), (49, 768, 40)])
def test_cuda_token_mlp_bf16_ragged_shapes(gen, t, c, h):
    """The bf16 K10 (statistics pass, then the fused wgmma kernel) in the
    Mixer's form at 3 images: T 49 and 50 (Tp 64), 196 (Tp 208) and 256;
    C 20 (element-wise loads and stores, one block with an idle consumer),
    96 (a ragged block) and 768; H 40 (a ragged chunk: W2's padded columns
    zero) and 384. One launch counted a call; the packed weights give the
    bits of the weights packed inside the call."""
    p = _token_params(gen, t, c, h, torch.bfloat16)
    args = (p["x"], p["w1"], p["b1"], p["w2"], p["b2"])
    kw = {"ln": p["ln"], "residual_input": True}
    before = k7.token_mlp.launches
    got = k7.token_mlp(*args, **kw)
    packed = k7.token_mlp(*args, **kw, packed=k7.pack_token_weights(p["w1"], p["w2"]))
    ref = k7.token_mlp_reference(*args, **kw)
    torch.cuda.synchronize()
    assert k7.token_mlp.launches == before + 2
    assert torch.equal(got, packed)
    _within(got, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("act", ["gelu", "gelu_tanh", "quick_gelu", "relu"])
def test_cuda_token_mlp_bf16_residual_forms(gen, act):
    """The bf16 K10 at 3 × 196 × 96, hidden 384, with each activation, in
    all three residual forms: the raw pre-norm x (with the LN prologue), a
    separate shortcut (without it), and none (with it)."""
    p = _token_params(gen, 196, 96, 384, torch.bfloat16)
    args = (p["x"], p["w1"], p["b1"], p["w2"], p["b2"])
    for kw in ({"ln": p["ln"], "residual_input": True}, {"shortcut": p["shortcut"]},
               {"ln": p["ln"]}):
        got = k7.token_mlp(*args, act=act, **kw)
        torch.cuda.synchronize()
        _within(got, k7.token_mlp_reference(*args, act=act, **kw))


@pytest.mark.gpu
def test_cuda_mixer_block_packed_path(gen):
    """A bf16 MixerBlock (50 tokens, C 96, hidden 40 and 192) on the card:
    its K10 call on the block's packed weights against the plain version,
    and the block's output against K7's plain version on that result; the
    pack is made once across two forwards."""
    from robustart_torch.models import mlp_mixer

    blk = mlp_mixer.MixerBlock(96, 50, 40, 192).cuda().eval()
    with torch.no_grad():
        for lin in (blk.mlp_tokens.fc1, blk.mlp_tokens.fc2, blk.mlp_channels.fc1,
                    blk.mlp_channels.fc2):
            lin.weight.copy_(torch.randn(lin.weight.shape, device="cuda", generator=gen)
                             * lin.weight.shape[1] ** -0.5)
            lin.weight.data = lin.weight.data.to(torch.bfloat16)
            lin.bias.copy_(torch.randn(lin.bias.shape, device="cuda", generator=gen) * 0.1)
        for norm in (blk.norm1, blk.norm2):
            norm.weight.copy_(torch.rand(96, device="cuda", generator=gen) + 0.5)
            norm.bias.copy_(torch.randn(96, device="cuda", generator=gen) * 0.1)
        x = torch.randn((3, 50, 96), device="cuda", generator=gen).to(torch.bfloat16)
        tok, ch = blk.mlp_tokens, blk.mlp_channels
        targs = (x, tok.fc1.weight, tok.fc1.bias, tok.fc2.weight, tok.fc2.bias)
        tkw = {"ln": (blk.norm1.weight, blk.norm1.bias), "ln_eps": mlp_mixer.LN_EPS,
               "residual_input": True}
        before = k7.token_mlp.launches
        out = blk(x)
        pack = blk._token_pack[1]
        assert torch.equal(blk(x), out) and blk._token_pack[1] is pack
        assert k7.token_mlp.launches == before + 2
        mid = k7.token_mlp(*targs, **tkw, packed=pack)
        torch.cuda.synchronize()
        _within(mid, k7.token_mlp_reference(*targs, **tkw))
        cargs = (mid, ch.fc1.weight, ch.fc1.bias, ch.fc2.weight, ch.fc2.bias)
        ckw = {"ln": (blk.norm2.weight, blk.norm2.bias), "ln_eps": mlp_mixer.LN_EPS,
               "residual": mid}
        _within(out, k7.mlp_reference(*cargs, **ckw))


def _dense_params(gen, c0, g, n, mid, dtype):
    s = sum(c0 + li * g for li in range(n))

    def arr(*shape, s=1.0):
        return torch.randn(shape, device="cuda", generator=gen) * s

    return (torch.rand((1, s), device="cuda", generator=gen) + 0.5, arr(1, s, s=0.1),
            arr(s, mid, s=(c0 + (n - 1) * g) ** -0.5).to(dtype),
            torch.rand((n, mid), device="cuda", generator=gen) + 0.5, arr(n, mid, s=0.1),
            arr(n * 9 * mid, g, s=(9 * mid) ** -0.5).to(dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,w,c0,n", [(3, 13, 11, 64, 3), (3, 7, 7, 512, 3),
                                        (2, 56, 56, 64, 2)])
def test_cuda_dense_block_matches_plain_version(gen, dtype, b, h, w, c0, n):
    """K12 with growth 32 and mid 128: at 3 images of 13 × 11 (64-pixel
    tiles that cross rows and images, ragged 8 × 8 tiles in f32), at block
    4's width (7 × 7, c0 512) and at block 1's (2 images of 56², c0 64): one
    call; three launches a layer in bf16, one in f32."""
    g, mid = 32, 128
    x = torch.randn((b, h, w, c0), device="cuda", generator=gen).to(dtype)
    params = _dense_params(gen, c0, g, n, mid, dtype)
    kw = dict(c0=c0, growth=g, n_layers=n, mid=mid)
    calls, launches = kd.dense_block.calls, kd.dense_block.launches
    got = kd.dense_block(x, *params, **kw)
    ref = kd.dense_block_reference(x, *params, **kw)
    torch.cuda.synchronize()
    per_layer = 3 if dtype == torch.bfloat16 else 1
    assert (kd.dense_block.calls, kd.dense_block.launches) == (calls + 1,
                                                               launches + per_layer * n)
    _within(got, ref)


@pytest.mark.gpu
def test_cuda_dense_block_stages_match_their_plain_versions(gen):
    """Each of the bf16 layer's three launches against its plain stage, at 3
    images of 13 × 11 and c = 96 of a 160-wide buffer (mid 128, growth 32):
    the BN1-ReLU pass bitwise (the same _rn steps), the product with the
    relu(acc·g2 + b2) epilogue and the 3×3 within one bf16 ulp of max|ref|;
    the 3×3 writes channels [96, 128) and nothing else. Then the whole
    block's stages through the wrappers equal the one-call path bitwise."""
    from robustart_torch.ops import linear

    c, ctot, g, mid = 96, 160, 32, 128
    buf = torch.randn((3, 13, 11, ctot), device="cuda", generator=gen).to(torch.bfloat16)
    g1 = torch.rand(c, device="cuda", generator=gen) + 0.5
    b1 = torch.randn(c, device="cuda", generator=gen) * 0.1
    before = kd.dense_block.launches
    a1 = kd.bn_relu(buf, c, g1, b1)
    torch.cuda.synchronize()
    assert torch.equal(a1, kd.bn_relu_reference(buf[..., :c], g1, b1).reshape(-1, c))
    w1t = (torch.randn((mid, c), device="cuda", generator=gen) * c ** -0.5).to(torch.bfloat16)
    g2 = torch.rand(mid, device="cuda", generator=gen) + 0.5
    b2 = torch.randn(mid, device="cuda", generator=gen) * 0.1
    t2 = linear.linear_fused(a1, w1t, b2, scale=g2, act="relu")
    torch.cuda.synchronize()
    _within(t2, linear.linear_fused_reference(a1, w1t, b2, scale=g2, act="relu"))
    w2 = (torch.randn((9 * mid, g), device="cuda", generator=gen) * (9 * mid) ** -0.5).to(
        torch.bfloat16)
    out = buf.clone()
    kd.conv3x3(t2.view(3, 13, 11, mid), w2, out, c)
    torch.cuda.synchronize()
    assert kd.dense_block.launches == before + 2
    _within(out[..., c:c + g], kd.conv3x3_reference(t2.view(3, 13, 11, mid), w2))
    assert torch.equal(out[..., :c], buf[..., :c]) and torch.equal(out[..., c + g:],
                                                                    buf[..., c + g:])
    x = buf[..., :64].contiguous()
    params = _dense_params(gen, 64, g, 3, mid, torch.bfloat16)
    kw = dict(c0=64, growth=g, n_layers=3, mid=mid)
    assert torch.equal(kd.dense_block_stages(x, *params, **kw), kd.dense_block(x, *params, **kw))


@pytest.mark.gpu
@pytest.mark.parametrize("m,k", [(333, 200), (38_333, 64)])
def test_cuda_linear_fused_scale_form_ragged(gen, m, k):
    """The product's relu(acc·scale + bias) epilogue (the dense block's 1×1)
    at a ragged M, at K = 200 and at K = 64 (one K step), N = 128 and 96."""
    from robustart_torch.ops import linear

    x = torch.randn((m, k), device="cuda", generator=gen).to(torch.bfloat16)
    for n in (128, 96):
        w = (torch.randn((n, k), device="cuda", generator=gen) * k ** -0.5).to(torch.bfloat16)
        scale = torch.rand(n, device="cuda", generator=gen) + 0.5
        shift = torch.randn(n, device="cuda", generator=gen) * 0.1
        got = linear.linear_fused(x, w, shift, scale=scale, act="relu")
        torch.cuda.synchronize()
        _within(got, linear.linear_fused_reference(x, w, shift, scale=scale, act="relu"))
