"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Each test is marked ``gpu`` and skips without CUDA: a CUDA kernel has no CPU
mode. The file imports no JAX, so that on a machine with a card and without
JAX it runs alone (``tests/conftest.py`` imports JAX):

    python -m pytest --noconftest -m gpu tests/test_torch_port_cuda.py

The shapes are odd (3×56×40, 3×31×17; 3 images of 50 tokens at C = 192;
6 Swin windows of 49 tokens, 3 images for K10, K11 and K12) so that no
block is full.
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


def test_library_name_follows_source_and_flags():
    """A changed source or flag set builds a new library, never a stale one."""
    a = build.library_path("chamfer")
    assert a.parent == build.BUILD_DIR and a.name.startswith("chamfer-")
    assert a == build.library_path("chamfer") != build.library_path("glass_shuffle")
    assert set(build.KERNELS) == {p.stem for p in build.CSRC.glob("*.cu")}


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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_dense_block_matches_plain_version(gen, dtype):
    """K12 at 3 images of 13 × 11 (ragged 8 × 8 tiles), c0 64, growth 32,
    mid 128, 3 layers: one call, three launches."""
    c0, g, n, mid = 64, 32, 3, 128
    s = sum(c0 + li * g for li in range(n))

    def arr(*shape, s=1.0):
        return torch.randn(shape, device="cuda", generator=gen) * s

    x = arr(3, 13, 11, c0).to(dtype)
    params = (torch.rand((1, s), device="cuda", generator=gen) + 0.5, arr(1, s, s=0.1),
              arr(s, mid, s=s ** -0.5).to(dtype),
              torch.rand((n, mid), device="cuda", generator=gen) + 0.5, arr(n, mid, s=0.1),
              arr(n * 9 * mid, g, s=(9 * mid) ** -0.5).to(dtype))
    kw = dict(c0=c0, growth=g, n_layers=n, mid=mid)
    calls, launches = kd.dense_block.calls, kd.dense_block.launches
    got = kd.dense_block(x, *params, **kw)
    ref = kd.dense_block_reference(x, *params, **kw)
    torch.cuda.synchronize()
    assert (kd.dense_block.calls, kd.dense_block.launches) == (calls + 1, launches + n)
    _within(got, ref)
