"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Each test is marked ``gpu`` and skips without CUDA: a CUDA kernel has no CPU
mode. The file imports no JAX, so that on a machine with a card and without
JAX it runs alone (``tests/conftest.py`` imports JAX):

    python -m pytest --noconftest -m gpu tests/test_torch_port_cuda.py

The shapes are odd (3×56×40, 3×31×17; 3 images of 50 tokens at C = 192;
6 Swin windows of 49 tokens, 3 images for K10, K11 and K12, K10 also at
49, 196 and 256 tokens and C = 20 and 768, K11 also at H and W that divide
neither its band nor its 2 × 7 patch and at C = 544 and 1024 (the channels
split over a cluster of two blocks), K12 also at
DenseNet-121's block 1 and block 4 widths) so that no block is full.
K2 and K3 round every step as their plain versions do and K4 and K5 copy or
take minima, so they are held bitwise (K2 on near, far and elastic
coordinates at C = 1, 3 and 4 and on an image past 32-bit offsets; K3 on
every severity's taps of motion_blur and snow, 8 × 8 and 224² too, on its
gathering route and past 32-bit offsets; K5
also at 224², 384² and a map beyond a cluster's shared memory); K1's
plain version divides where torch's CUDA division multiplies by a
reciprocal (``PERF.md``). K6-K12 sum in another order than their plain
versions: f32 is held to max|Δ| ≤ 1e-5·max|ref|, bf16 to one bf16 ulp of
max|ref|.
"""

import tests.torch_port_threads  # noqa: F401  (before any torch work)
import math

import pytest
import torch

from robustart_torch.noise.corruptions import MOTION_BANK, MOTION_SEVERITY, SNOW_BANK, SNOW_SEVERITY
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


def _warp_coords(kind: str, b: int, h: int, w: int, gen) -> tuple:
    """Coordinates of each kind K2 meets: near identity, far overhangs of
    up to three periods (reflections of reflections), image 0 near identity
    and the others far, elastic_transform's at severity 3 (the main
    path's)."""
    from robustart_torch.noise.corruptions import elastic_coords

    if kind == "elastic":
        img = torch.rand((b, h, w, 3), device="cuda", generator=gen)
        return elastic_coords(img, 3, generator=gen)[1]
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device="cuda"),
                            torch.arange(w, dtype=torch.float32, device="cuda"), indexing="ij")
    near = [yy + torch.rand((b, h, w), device="cuda", generator=gen) * 6 - 3,
            xx + torch.rand((b, h, w), device="cuda", generator=gen) * 6 - 3]
    far = [torch.rand((b, h, w), device="cuda", generator=gen) * 12 * n - 6 * n
           for n in (h, w)]
    if kind == "near":
        return tuple(near)
    if kind == "far":
        return tuple(far)
    for a, f in zip(near, far):
        a[1:] = f[1:]
    return tuple(near)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["near", "far", "mix", "elastic"])
@pytest.mark.parametrize("c", [1, 3, 4])
@pytest.mark.parametrize("shape", [(B, H, W), (3, 31, 17), (2, 224, 224), (2, 33, 65)])
def test_cuda_warp_is_bitwise_on_each_kind_of_coordinates(gen, kind, c, shape):
    """K2 bitwise at C = 1 and 3 (compiled) and 4 (any C), at H · W that
    its blocks of 256 pixels do not divide; one launch a call."""
    cy, cx = _warp_coords(kind, *shape, gen)
    img = torch.rand((*shape, c), device="cuda", generator=gen)
    before = kw.warp_bilinear.launches
    got = kw.warp_bilinear(img, cy, cx)
    torch.cuda.synchronize()
    assert kw.warp_bilinear.launches == before + 1
    assert torch.equal(got, kw.warp_bilinear_reference(img, cy, cx))


@pytest.mark.gpu
def test_cuda_warp_offsets_past_32_bits(gen):
    """An image of more than 2^31 floats (H · W · C), which the kernel
    addresses with 64-bit offsets: 2,000 pixels held to the plain version's
    arithmetic, at far and near coordinates."""
    h, w, c = 2900, 2900, 256
    img = torch.rand((1, h, w, c), device="cuda", generator=gen)
    far, near = _warp_coords("far", 1, h, w, gen), _warp_coords("near", 1, h, w, gen)
    top = torch.arange(h, device="cuda")[None, :, None] < h // 2
    cy, cx = (torch.where(top, n, f) for n, f in zip(near, far))
    got = kw.warp_bilinear(img, cy, cx)
    idx = torch.randint(0, h * w, (2000,), device="cuda", generator=gen)
    idx[:8] = torch.tensor([0, 1, w - 1, w, h * w // 2, h * w - w, h * w - 2, h * w - 1])
    ys, xs = cy.reshape(-1)[idx].reshape(1, 1, -1), cx.reshape(-1)[idx].reshape(1, 1, -1)
    # the plain version on a one-row image of the sampled corners only
    y0, x0 = torch.floor(ys).long(), torch.floor(xs).long()
    flat = img.reshape(h * w, c)
    corners = [flat[kw._reflect(y0 + dy, h) * w + kw._reflect(x0 + dx, w)].reshape(1, 1, -1, c)
               for dy in (0, 1) for dx in (0, 1)]
    fy, fx = (ys - torch.floor(ys))[..., None], (xs - torch.floor(xs))[..., None]
    top = corners[0] * (1 - fx) + corners[1] * fx
    bot = corners[2] * (1 - fx) + corners[3] * fx
    want = top * (1 - fy) + bot * fy
    torch.cuda.synchronize()
    assert torch.equal(got.reshape(h * w, c)[idx].reshape(1, 1, -1, c), want)


# every severity's taps: motion_blur at C = 3, snow's layer at C = 1
MOTION_TAPS = ([(3, float(r), float(g), MOTION_BANK) for r, g in MOTION_SEVERITY]
               + [(1, float(c[4]), float(c[5]), SNOW_BANK) for c in SNOW_SEVERITY])


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(32, 224, 224), (32, H, W), (32, 8, 8), (32, 31, 17)])
@pytest.mark.parametrize("c,radius,sigma,bank", MOTION_TAPS,
                         ids=[f"C{t[0]}-r{t[1]:g}-s{t[2]:g}" for t in MOTION_TAPS])
def test_cuda_motion_taps_matches_plain_version(gen, c, radius, sigma, bank, shape):
    """K3 bitwise on every severity's taps of both corruptions, the 32 bank
    angles one an image, at 224², at odd sizes (partial tiles) and at 8 × 8
    (boxes that clamp almost everything); one launch a call."""
    b, h, w = shape
    img = torch.rand((b, h, w, c), device="cuda", generator=gen)
    idx = torch.arange(32, device="cuda")
    rows = km.tap_rows(idx, radius, sigma, bank)
    before = km.motion_taps.launches
    got = km.motion_blur_bank(img, idx, radius, sigma, bank)
    torch.cuda.synchronize()
    assert km.motion_taps.launches == before + 1
    assert torch.equal(got, km.motion_taps_reference(img, *rows))


@pytest.mark.gpu
@pytest.mark.parametrize("c", [1, 3])
def test_cuda_motion_taps_gather_route(gen, c):
    """Tiles over the box budget gather: 64 taps a row, two images near
    (|offsets| ≤ 3), two far (up to ±300 px and int32's extremes, past the
    image), in one launch; and the path's rows with a budget that fits no
    box (``reach`` (0, 0) says every box is the tile), so that every
    image gathers. Bitwise."""
    img = torch.rand((4, 100, 90, c), device="cuda", generator=gen)
    near = torch.randint(-3, 4, (2, 2, 64), device="cuda", generator=gen)
    far = torch.randint(-300, 301, (2, 2, 64), device="cuda", generator=gen)
    far[:, 1, :4] = torch.tensor([2**31 - 1, -2**31, 0, 5], device="cuda")
    dy, dx = torch.cat([near, far], dim=1).to(torch.int32).unbind(0)
    dy, dx = dy.contiguous(), dx.contiguous()
    wt = torch.rand((4, 64), device="cuda", generator=gen)
    before = km.motion_taps.launches
    got = km.motion_taps(img, dy, dx, wt)
    torch.cuda.synchronize()
    assert km.motion_taps.launches == before + 1
    assert torch.equal(got, km.motion_taps_reference(img, dy, dx, wt))
    idx = torch.tensor([0, 7, 16, 31], device="cuda")
    rows = km.tap_rows(idx, 20.0, 15.0, MOTION_BANK)
    got = km.motion_taps(img, *rows, reach=(0, 0))
    torch.cuda.synchronize()
    assert torch.equal(got, km.motion_taps_reference(img, *rows))


@pytest.mark.gpu
def test_cuda_motion_taps_offsets_past_32_bits(gen):
    """An image of more than 2^31 floats (H · W · C), which the kernel
    addresses with 64-bit offsets: 2,000 pixels held to the plain version's
    arithmetic on motion_blur's severity-5 taps."""
    h, w = 26800, 26800
    img = torch.rand((1, h, w, 3), device="cuda", generator=gen)
    dy, dx, wt = km.tap_rows(torch.tensor([5], device="cuda"), 20.0, 15.0, MOTION_BANK)
    got = km.motion_taps(img, dy, dx, wt)
    idx = torch.randint(0, h * w, (2000,), device="cuda", generator=gen)
    idx[:6] = torch.tensor([0, w - 1, h * w // 2, h * w - w, h * w - 2, h * w - 1])
    i, j = idx // w, idx % w
    flat = img.reshape(h * w, 3)
    want = torch.zeros((2000, 3), device="cuda")
    for t in range(dy.shape[1]):
        src = (i + dy[0, t]).clamp(0, h - 1) * w + (j + dx[0, t]).clamp(0, w - 1)
        want = want + wt[0, t] * flat[src]
    torch.cuda.synchronize()
    assert torch.equal(got.reshape(h * w, 3)[idx], want)


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
@pytest.mark.parametrize("zeros", [0.02, 0.005])
@pytest.mark.parametrize("iters", [1, 12])
@pytest.mark.parametrize("shape,route,cluster", [
    ((B, H, W), "cluster", 1), ((2, 224, 224), "cluster", 2), ((2, 57, 41), "cluster", 1),
    ((1, 384, 384), "cluster", 8), ((1, 480, 480), "rounds", None)])
def test_cuda_chamfer_matches_plain_version(gen, zeros, iters, shape, route, cluster):
    """K5 bitwise against its plain version on both of ``chamfer_plan``'s
    routes: one launch a call on a cluster of 1, 2 or 8 blocks (odd H and W:
    element-wise loads and stores, a ragged column group), or one a round
    for a map too large for a cluster; the launches as counted where they
    are issued. 2% zeros, and 0.5%, so sparse that distances cross the
    bands' borders over more of the rounds."""
    dist0 = torch.where(torch.rand(shape, device="cuda", generator=gen) < zeros, 0.0, 20.0)
    plan = km.chamfer_plan(*shape, iters)
    assert (plan["route"], plan.get("cluster")) == (route, cluster)
    before = km.chamfer.launches
    got = km.chamfer(dist0, 20.0, iters)
    torch.cuda.synchronize()
    assert km.chamfer.launches == before + plan["launches"]
    assert plan["launches"] == (1 if route == "cluster" else iters)
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
@pytest.mark.parametrize("shape", [(3, 14, 13, 32), (3, 7, 7, 96), (2, 13, 11, 128),
                                   (3, 7, 7, 1024), (3, 9, 15, 1024), (3, 7, 7, 544),
                                   (1, 9, 300, 32)])
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,c,h", [(576, 96, 384), (324, 768, 384)])
def test_cuda_token_mlp_over_the_product(gen, dtype, t, c, h):
    """K10 above 256 tokens (Mixer-B/16 at 384 px: 576; at 288 px: 324, a
    token count the product's 16-byte rows pad) takes ``token_plan``'s
    route over the product: the LN pass, fc1, fc2 with the residual in its
    epilogue. With the LN prologue and the raw-x residual, and with a
    shortcut and no LN, against the plain version; one call counted a
    call, its launches in ``product_launches``; in bf16 the packed weights
    give the bits of the weights packed inside the call."""
    p = _token_params(gen, t, c, h, dtype)
    p["x"] = p["x"][:2 if c == 768 else 3]
    p["shortcut"] = p["shortcut"][:p["x"].shape[0]]
    args = (p["x"], p["w1"], p["b1"], p["w2"], p["b2"])
    assert k7.token_plan(p["x"].shape[0], t, c, h)["route"] == "product"
    for kw, issued in (({"ln": p["ln"], "residual_input": True}, 3),
                       ({"shortcut": p["shortcut"]}, 2)):
        before = (k7.token_mlp.launches, k7.token_mlp.product_launches)
        got = k7.token_mlp(*args, **kw)
        ref = k7.token_mlp_reference(*args, **kw)
        torch.cuda.synchronize()
        assert (k7.token_mlp.launches, k7.token_mlp.product_launches) == (
            before[0] + 1, before[1] + issued)
        _within(got, ref)
        if dtype == torch.bfloat16:
            packed = k7.pack_token_weights(p["w1"], p["w2"])
            assert torch.equal(got, k7.token_mlp(*args, **kw, packed=packed))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [20, 768, 1100])
def test_cuda_layer_norm_pass_any_width(gen, dtype, k):
    """``linear_fused.cu``'s LN pass on its own (``ops/linear.py::
    layer_norm``): K 20 (the scalar kernel in bf16), 768 (the row in
    registers), 1100 (a row read twice), against ``layer_norm_f32`` cast
    to the type."""
    from robustart_torch.ops import linear

    x = (torch.randn((333, k), device="cuda", generator=gen) * 2.0 + 0.5).to(dtype)
    w = torch.randn(k, device="cuda", generator=gen) * 0.2 + 1.0
    b = torch.randn(k, device="cuda", generator=gen) * 0.1
    got = linear.layer_norm(x, w, b, 1e-6)
    torch.cuda.synchronize()
    _within(got, linear.layer_norm_f32(x, w, b, 1e-6).to(dtype))


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


# the int8 path: conv_i8's int32 accumulators on cuBLASLt's int8 GEMM
# (torch._int_mm) against the CPU's exact integer product, at ResNet-50's
# stem (K 147 padded to 152, on the border-padded input), a strided 1×1,
# a ResNeXt-50 grouped 3×3 (32 groups) and a product of 16 rows (padded to
# 17 on the card): (B, H, W, Cin, k, stride, padding, groups, Cout)
INT8_CONVS = [(2, 230, 230, 3, 7, 2, 0, 1, 64), (2, 56, 56, 256, 1, 2, 0, 1, 512),
              (2, 28, 28, 256, 3, 1, 1, 32, 256), (1, 4, 4, 64, 1, 1, 0, 1, 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", INT8_CONVS)
def test_cuda_conv_i8_accumulators_bitwise(gen, shape):
    from robustart_torch.ops import quant

    b, h, w, cin, k, stride, pad, groups, cout = shape
    x = torch.randint(-128, 128, (b, h, w, cin), dtype=torch.int8, device="cuda",
                      generator=gen)
    wt = torch.randint(-127, 128, (k, k, cin // groups, cout), dtype=torch.int8,
                       device="cuda", generator=gen)
    got = quant.conv_i8(x, wt, stride, pad, groups)
    ref = quant.conv_i8(x.cpu(), wt.cpu(), stride, pad, groups)
    assert got.dtype == torch.int32 and torch.equal(got.cpu(), ref)


@pytest.mark.gpu
def test_cuda_int8_vit_runs_k8_against_its_plain_version(gen):
    """A two-block int8 ViT (C 64, two heads of 32) quantized on the CPU:
    on the card its attention is K8, once a block, on the bf16 q/k/v; on
    the CPU it is ``mha_reference``. Logits cosine ≥ 0.999 and within rel
    2e-2 of max|logit| (the bf16 float side rounds at the same places;
    the products' sums differ in order)."""
    import numpy as np

    from robustart_torch.models import quantize_vit
    from robustart_torch.models.classifier import Classifier
    from robustart_torch.models.registry import init_weights
    from robustart_torch.models.vit import VisionTransformer

    model = VisionTransformer(patch_size=8, embed_dim=64, depth=2, num_heads=2, num_classes=16,
                              img_size=32).eval()
    init_weights(model, torch.Generator().manual_seed(0))
    clf = Classifier("vit_tiny", model, input_size=32, num_classes=16)
    calib = np.random.default_rng(0).integers(0, 256, (8, 32, 32, 3), np.uint8)
    cpu = quantize_vit.quantize_vit(clf, calib, calib_batch_size=8)
    card = cpu.to("cuda")
    x = torch.randint(0, 256, (3, 32, 32, 3), dtype=torch.uint8, device="cuda", generator=gen)
    before = ka.mha.launches
    with torch.inference_mode():
        got = card(x).cpu()
        ref = cpu(x.cpu())
    assert ka.mha.launches - before == 2
    cos = (got * ref).sum(-1) / (got.norm(dim=-1) * ref.norm(dim=-1))
    assert float(cos.min()) >= 0.999
    assert float((got - ref).abs().max()) <= 2e-2 * float(ref.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("severity", [1, 2, 3, 4, 5])
def test_cuda_jpeg_compression_is_bitwise_the_cpu(gen, severity):
    """libjpeg's integer transcode in int32 tensors: the card's image equals
    the CPU's bit for bit (224² and an unaligned 57 × 43)."""
    from robustart_torch.noise import corruptions as pc

    for shape in ((4, 224, 224, 3), (2, 57, 43, 3)):
        x01 = pc.to_unit(torch.randint(0, 256, shape, dtype=torch.uint8, device="cuda",
                                       generator=gen))
        got = pc.jpeg_compression(x01, severity)
        assert torch.equal(got.cpu(), pc.jpeg_compression(x01.cpu(), severity))


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["jpeg_compression", "fog", "frost", "brightness",
                                  "contrast", "pixelate", "saturate"])
def test_cuda_corrupt_one_image_equals_corrupt_batch(gen, name):
    """``corrupt`` on the card equals ``corrupt_batch`` of the same image
    (divided by 255 on the host, as ``corrupt`` does) with a generator of
    the same seed, by uint8 level."""
    from robustart_torch.noise import corruptions as pc

    img = torch.randint(0, 256, (1, 57, 43, 3), dtype=torch.uint8, device="cuda",
                        generator=gen)
    got = pc.corrupt(img[0].cpu().numpy(), 3, name, seed=5, device="cuda")
    x01 = (img.cpu().float() / 255.0).cuda()
    want = pc.corrupt_batch(x01, name, 3,
                            generator=torch.Generator(device="cuda").manual_seed(5))
    assert str(got.dtype) == "uint8" and got.shape == (57, 43, 3)
    assert (got == pc.uint8_grid(want)[0].to(torch.uint8).cpu().numpy()).all()
