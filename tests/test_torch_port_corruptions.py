"""The port's blur, snow, spatter and elastic corruptions and its kernels
K2-K5 against the JAX package, on the CPU.

- Each plain kernel against its Pallas kernel run by the TPU interpreter
  (``interpret=True``) on the same inputs, made with numpy from a seed:
  K2 warp (and the gather form, with an overhang only it covers), K3 motion
  taps (C = 1 and 3), K4 glass shuffle (interior, exact), K5 chamfer (exact).
- The image ops of ``robustart_torch.ops.image`` against ``ops/image.py``.
- The eight corruptions against ``jax_kernels`` with the JAX draw injected,
  at severities 1, 3 and 5, and spatter's water branch stage by stage.
- The online slice: the port's solver against the JAX solver with the same
  weights, and the fused run byte-equal to the per-severity run.

The CUDA kernels against their plain versions are in
``tests/test_torch_port_cuda.py``, which imports no JAX.

Sizes are small (2 images, 32×32; H a multiple of 8 for the interpreter).
"""

import filecmp
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustart_torch.core.config import Config as PortConfig
from robustart_torch.models import convert
from robustart_torch.noise import corruptions as pc
from robustart_torch.ops import image as pimg
from robustart_torch.ops import motion as km
from robustart_torch.ops import warp as kw
from robustart_torch.solvers import MultiEvalSolver as PortSolver
from robustart_tpu.core.config import Config
from robustart_tpu.models.torch_convert import flatten
from robustart_tpu.noise.corruptions import jax_kernels as jk
from robustart_tpu.ops import image as jimg
from robustart_tpu.ops.pallas_motion import (
    _angle_tap_table,
    chamfer_pallas,
    glass_shuffle_pallas,
    motion_taps_pallas,
)
from robustart_tpu.ops.pallas_warp import warp_banded_pallas
from robustart_tpu.solvers import MultiEvalSolver as JaxSolver
from tests.test_torch_port_resnet import numpy_init

B, H, W = 2, 32, 32
NEW = ("defocus_blur", "glass_blur", "motion_blur", "zoom_blur", "snow",
       "elastic_transform", "gaussian_blur", "spatter")
# the JAX package's jitted gather warp, the form elastic_transform runs
_gather = jax.jit(jimg.map_coordinates_bilinear_reflect)


def _t(a):
    return torch.from_numpy(np.array(a))


def _identity_plus(rng, h, w, lo, hi):
    yy, xx = np.meshgrid(np.arange(h, dtype=np.float32),
                         np.arange(w, dtype=np.float32), indexing="ij")
    cy = yy + rng.uniform(lo, hi, (B, h, w)).astype(np.float32)
    cx = xx + rng.uniform(lo, hi, (B, h, w)).astype(np.float32)
    return cy, cx


# ---------------------------------------------------------------------------
# K2: bilinear warp
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", [2, 9])
def test_plain_warp_matches_pallas_and_gather(d):
    """Displacements inside the band (-d, d): the plain K2 against the TPU
    kernel and the gather form, atol 1e-6 (XLA may contract the bilinear
    multiply-adds into FMAs, ~1 ulp)."""
    rng = np.random.default_rng(d)
    img = rng.random((B, H, 24, 3), dtype=np.float32)
    cy, cx = _identity_plus(rng, H, 24, -d + 0.01, d - 0.01)
    got = kw.warp_bilinear_reference(_t(img), _t(cy), _t(cx)).numpy()
    for b in range(B):
        pal = np.asarray(warp_banded_pallas(img[b], cy[b], cx[b], d, d, interpret=True))
        gat = np.asarray(_gather(img[b], cy[b], cx[b]))
        np.testing.assert_allclose(got[b], pal, rtol=0, atol=1e-6)
        np.testing.assert_allclose(got[b], gat, rtol=0, atol=1e-6)


def test_plain_warp_reflects_any_overhang():
    """Coordinates up to three image sizes outside: scipy's reflect of
    period 2n, which only the gather form covers; atol 1e-6."""
    rng = np.random.default_rng(1)
    img = rng.random((B, 16, 24, 3), dtype=np.float32)
    cy = rng.uniform(-48, 64, (B, 16, 24)).astype(np.float32)
    cx = rng.uniform(-72, 96, (B, 16, 24)).astype(np.float32)
    got = kw.warp_bilinear_reference(_t(img), _t(cy), _t(cx)).numpy()
    for b in range(B):
        ref = np.asarray(_gather(img[b], cy[b], cx[b]))
        np.testing.assert_allclose(got[b], ref, rtol=0, atol=1e-6)


def test_warp_wrapper_runs_plain_version_on_cpu():
    rng = np.random.default_rng(2)
    img = _t(rng.random((B, 8, 8, 3), dtype=np.float32))
    cy, cx = (_t(a) for a in _identity_plus(rng, 8, 8, -3, 3))
    before = kw.warp_bilinear.launches
    assert torch.equal(kw.warp_bilinear(img, cy, cx),
                       kw.warp_bilinear_reference(img, cy, cx))
    assert kw.warp_bilinear.launches == before
    with pytest.raises(ValueError):
        kw.warp_bilinear(img, cy[:, :4], cx)
    with pytest.raises(TypeError):
        kw.warp_bilinear(img.double(), cy, cx)


# ---------------------------------------------------------------------------
# K3: motion taps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("radius,sigma,bank", [(15.0, 8.0, pc.MOTION_BANK),
                                               (12.0, 8.0, pc.SNOW_BANK)])
def test_angle_tap_table_equals_jax(radius, sigma, bank):
    want = _angle_tap_table(radius, sigma, bank)
    got = km.angle_tap_table(radius, sigma, bank)
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a, b)
    assert got[3:] == want[3:]


@pytest.mark.parametrize("c", [1, 3])
def test_plain_motion_taps_matches_pallas(c):
    """The plain K3 against the TPU kernel at C = 1 (snow's layer) and C = 3
    (motion_blur): atol 1e-6 (the interpreter may fuse multiply-adds)."""
    rng = np.random.default_rng(c)
    x = rng.random((B, H, W, c), dtype=np.float32)
    idx = np.array([3, 29])
    dy, dx, wt, py, px = _angle_tap_table(15.0, 8.0, pc.MOTION_BANK)
    got = km.motion_taps_reference(_t(x), _t(dy[idx]), _t(dx[idx]), _t(wt[idx])).numpy()
    for b in range(B):
        ref = np.asarray(motion_taps_pallas(x[b], dy[idx[b]], dx[idx[b]], wt[idx[b]],
                                            py, px, interpret=True))
        np.testing.assert_allclose(got[b], ref, rtol=0, atol=1e-6)


def test_motion_blur_bank_matches_direct_blur():
    """Each image at its own bank angle: the port's K3 path against the
    port's and the JAX package's direct per-angle blur, atol 1e-6."""
    rng = np.random.default_rng(4)
    x = rng.random((B, H, W, 3), dtype=np.float32)
    idx = torch.tensor([0, 17])
    got = km.motion_blur_bank(_t(x), idx, 15.0, 8.0, pc.MOTION_BANK).numpy()
    for b in range(B):
        angle = pc.MOTION_BANK[int(idx[b])]
        own = pimg.motion_blur(_t(x[b]), 15.0, 8.0, angle).numpy()
        ref = np.asarray(jimg.motion_blur(jnp.asarray(x[b]), 15.0, 8.0, angle))
        np.testing.assert_allclose(got[b], own, rtol=0, atol=1e-6)
        np.testing.assert_allclose(got[b], ref, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# K4: glass shuffle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", [1, 2, 3, 4])
def test_plain_glass_shuffle_matches_pallas(d):
    """Exact on the interior (the TPU kernel's other pixels are overwritten
    by its caller); the plain K4 keeps x there."""
    rng = np.random.default_rng(d)
    x = rng.random((B, H, W, 3), dtype=np.float32)
    off = rng.integers(-d, d, (B, H, W, 2))
    code = (off[..., 0] + d) * (2 * d) + (off[..., 1] + d)
    got = km.glass_shuffle_reference(_t(x), _t(code.astype(np.uint8)), d).numpy()
    rows, cols = np.arange(H)[:, None], np.arange(W)[None, :]
    interior = (rows > d) & (rows < H - d) & (cols > d) & (cols < W - d)
    for b in range(B):
        ref = np.asarray(glass_shuffle_pallas(x[b], code[b].astype(np.int32), d,
                                              interpret=True))
        np.testing.assert_array_equal(got[b][interior], ref[interior])
        np.testing.assert_array_equal(got[b][~interior], x[b][~interior])


# ---------------------------------------------------------------------------
# K5: chamfer propagation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("iters", [1, 12])
def test_plain_chamfer_matches_pallas_and_jax(iters):
    """Exact: min is exact and each add sees the same f32 operands."""
    rng = np.random.default_rng(iters)
    mask = rng.random((B, H, W)) < 0.02
    dist0 = np.where(mask, 0.0, 20.0).astype(np.float32)
    got = km.chamfer_reference(_t(dist0), 20.0, iters).numpy()
    for b in range(B):
        pal = np.asarray(chamfer_pallas(jnp.asarray(dist0[b]), cap=20.0, iters=iters,
                                        interpret=True))
        ref = np.asarray(jk._chamfer_distance(jnp.asarray(mask[b]), 20.0, iters))
        np.testing.assert_array_equal(got[b], pal)
        np.testing.assert_array_equal(got[b], ref)


@pytest.mark.parametrize("shape,iters,want", [
    ((128, 224, 224), 12, {"cluster": 2, "band": 112, "wp": 232, "groups": 56, "strips": 8,
                           "threads": 448, "smem": 215_312}),
    ((3, 56, 40), 12, {"cluster": 1, "band": 56, "wp": 48, "groups": 10, "strips": 4,
                       "threads": 64, "smem": 23_056}),
    ((2, 384, 384), 1, {"cluster": 8, "band": 48, "wp": 392, "groups": 96, "strips": 4,
                        "threads": 384, "smem": 163_088}),
    ((2, 57, 41), 12, {"cluster": 1, "band": 57, "wp": 52, "groups": 11, "strips": 5,
                       "threads": 64, "smem": 25_392}),
    ((1, 1000, 64), 12, {"cluster": 4, "band": 250, "wp": 72, "groups": 16, "strips": 18,
                         "threads": 288, "smem": 146_320}),
    ((2, 512, 512), 12, None),
    ((1, 480, 480), 5, None),
])
def test_chamfer_plan(shape, iters, want):
    """K5's route by shape: one launch a call on the least cluster (1, 2, 4
    or 8 blocks) whose band of ceil(H / n) rows with 2 halo rows fits two
    f32 buffers of 4·ceil(W / 4) + 8 columns (and two mbarriers) in a
    block's 232,448 bytes, 14-row strips of 4 columns a thread; past a
    cluster of 8, a launch a round."""
    b = shape[0]
    plan = km.chamfer_plan(*shape, iters)
    if want is None:
        assert plan == {"route": "rounds", "launches": iters, "threads": 256,
                        "grid": (-(-shape[1] * shape[2] // 256), b)}
    else:
        assert plan == {"route": "cluster", "launches": 1, **want, "grid": (want["cluster"], b)}
        assert plan["smem"] <= km.CHAMFER_SMEM


def test_chamfer_plan_refusals():
    for args, match in (((65536, 8, 8, 12), "grid limit"), ((1, 8, 8, 0), "at least 1"),
                        ((1, 0, 8, 12), "must be positive")):
        with pytest.raises(ValueError, match=match):
            km.chamfer_plan(*args)


@pytest.mark.parametrize("seed", [0, 1])
def test_chamfer_kernel_arithmetic_is_bitwise(seed):
    """The cluster kernel's arithmetic (``csrc/chamfer.cu``), written in
    torch, for rounds of maps of arbitrary f32 values (not only integers):
    per weight class the least neighbour plus the weight, by the pair
    minima of rows i ± 1 and i ± 2, then the centre and the cap. Rounding
    x + w to nearest is monotone in x, so it equals the plain version's
    minimum of 16 sums bit for bit."""
    import torch.nn.functional as F

    rng = np.random.default_rng(seed)
    dist = _t(rng.uniform(0.0, 30.0, (2, 23, 37)).astype(np.float32))
    dist[dist < 3.0] = 0.0
    cap = 20.0
    w0, w1, w2 = (float(np.float32(w)) for w in km.CHAMFER_WEIGHTS)
    ref = dist
    for _ in range(3):
        p = F.pad(dist, (2, 2, 2, 2), value=cap)
        h, w = dist.shape[1:]

        def at(dy, dx):
            return p[:, 2 + dy:2 + dy + h, 2 + dx:2 + dx + w]

        def v(k, dx):
            return torch.minimum(at(-k, dx), at(k, dx))

        m0 = torch.minimum(torch.minimum(at(0, -1), at(0, 1)), v(1, 0))
        m1 = torch.minimum(v(1, -1), v(1, 1))
        m2 = torch.minimum(torch.minimum(v(1, -2), v(1, 2)), torch.minimum(v(2, -1), v(2, 1)))
        cand = torch.minimum(torch.minimum(m0 + w0, m1 + w1), m2 + w2)
        dist = torch.minimum(torch.clamp_max(dist, cap), cand)
        ref = km.chamfer_reference(ref, cap, 1)
        assert torch.equal(dist, ref)


def test_kernel_wrappers_run_plain_versions_on_cpu():
    rng = np.random.default_rng(5)
    x = _t(rng.random((B, H, W, 3), dtype=np.float32))
    code = _t(rng.integers(0, 16, (B, H, W)).astype(np.uint8))
    dist0 = _t(np.where(rng.random((B, H, W)) < 0.05, 0.0, 20.0).astype(np.float32))
    dy, dx, wt, _, _ = km.angle_tap_table(10.0, 3.0, pc.MOTION_BANK)
    rows = [_t(a[[1, 30]]) for a in (dy, dx, wt)]
    counts = (km.motion_taps.launches, km.glass_shuffle.launches, km.chamfer.launches)
    assert torch.equal(km.motion_taps(x, *rows), km.motion_taps_reference(x, *rows))
    assert torch.equal(km.glass_shuffle(x, code, 2), km.glass_shuffle_reference(x, code, 2))
    assert torch.equal(km.chamfer(dist0, 20.0, 12), km.chamfer_reference(dist0, 20.0, 12))
    assert counts == (km.motion_taps.launches, km.glass_shuffle.launches,
                      km.chamfer.launches)
    with pytest.raises(ValueError):
        km.motion_taps(x[..., :2].contiguous(), *rows)
    with pytest.raises(ValueError):
        km.glass_shuffle(x, code.to(torch.int32), 2)
    with pytest.raises(ValueError):
        km.chamfer(dist0, 20.0, 0)


# ---------------------------------------------------------------------------
# the image ops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sigma,truncate", [(1.0, 4.0), (6.0, 4.0), (170.8, 3.0)])
def test_gaussian_blur_matches_jax(sigma, truncate):
    """Banded products in another summation order: atol 1e-6. σ = 170.8 at
    truncate 3 (elastic, severity 1) has a radius beyond the image."""
    x = np.random.default_rng(0).random((B, H, W, 3), dtype=np.float32)
    got = pimg.gaussian_blur(_t(x), sigma, truncate).numpy()
    ref = np.asarray(jimg.gaussian_blur(jnp.asarray(x), sigma, truncate))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("kernel", ["disk3", "disk10", "sobel", "emboss"])
def test_filter2d_same_matches_jax(kernel):
    """cv2's reflect-101 filter as SVD terms: atol 1e-6 relative to the
    largest output."""
    k = {"disk3": jimg.disk_kernel(3, 0.1), "disk10": jimg.disk_kernel(10, 0.5),
         "sobel": pc.SOBEL_X, "emboss": pc.EMBOSS}[kernel]
    x = np.random.default_rng(1).random((B, H, W, 3), dtype=np.float32)
    np.testing.assert_array_equal(pimg.disk_kernel(6, 0.5), jimg.disk_kernel(6, 0.5))
    got = pimg.filter2d_same(_t(x), k).numpy()
    ref = np.asarray(jimg.filter2d_same(jnp.asarray(x), k))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * np.abs(ref).max())


@pytest.mark.parametrize("zoom", [1.0, 1.13, 2.5, 4.5])
def test_clipped_zoom_matches_jax(zoom):
    x = np.random.default_rng(2).random((B, H, W, 1), dtype=np.float32)
    got = pc.clipped_zoom(_t(x), zoom).numpy()
    for b in range(B):
        ref = np.asarray(jk.clipped_zoom(jnp.asarray(x[b]), zoom))
        np.testing.assert_allclose(got[b], ref, rtol=0, atol=1e-6)


def test_gray_and_equalize_match_jax():
    """rgb_to_gray to 2e-7 (the JAX dot may fuse a multiply-add);
    equalize_hist exact (integer histograms, the
    LUT rounded half to even)."""
    rng = np.random.default_rng(3)
    x = rng.random((B, H, W, 3), dtype=np.float32)
    np.testing.assert_allclose(pimg.rgb_to_gray(_t(x)).numpy(),
                               np.asarray(jimg.rgb_to_gray(jnp.asarray(x))),
                               rtol=0, atol=2e-7)
    u8 = np.floor(rng.random((B, H, W)) ** 3 * 40).astype(np.float32)
    got = pc.equalize_hist(_t(u8)).numpy()
    for b in range(B):
        np.testing.assert_array_equal(got[b], np.asarray(jk._equalize_hist(u8[b])))


# ---------------------------------------------------------------------------
# the eight corruptions, with the JAX draw injected
# ---------------------------------------------------------------------------


def jax_draws(name, key, severity, h, w):
    """The draw each image of ``jax_kernels.corrupt_batch(x, key, ...)``
    makes, from the same key chain, in the port's injected form."""
    keys = jax.random.split(key, B)
    f32 = jnp.float32
    if name == "glass_blur":
        _, d, iters = pc.GLASS_SEVERITY[severity - 1]
        offs = []
        for k in keys:
            per = []
            for _ in range(iters):
                k, sub = jax.random.split(k)
                per.append(np.asarray(jax.random.randint(sub, (h, w, 2), -d, d)))
            offs.append(per)
        return {"offsets": _t(np.stack(offs, axis=1))}
    if name == "motion_blur":
        return {"angles": _t(np.array([jax.random.uniform(k, (), f32, -45.0, 45.0)
                                       for k in keys], np.float32))}
    if name == "snow":
        pairs = [jax.random.split(k) for k in keys]
        return {
            "normal": _t(np.stack([np.asarray(jax.random.normal(k1, (h, w), f32))
                                   for k1, _ in pairs])),
            "angles": _t(np.array([jax.random.uniform(k2, (), f32, -135.0, -45.0)
                                   for _, k2 in pairs], np.float32)),
        }
    if name == "spatter":
        return {"normal": _t(np.stack([np.asarray(jax.random.normal(k, (h, w), f32))
                                       for k in keys]))}
    if name == "elastic_transform":
        cc = pc.ELASTIC_SEVERITY[severity - 1][2]
        triples = [jax.random.split(k, 3) for k in keys]
        return {
            "affine": _t(np.stack([np.asarray(jax.random.uniform(t[0], (3, 2), f32, -cc, cc))
                                   for t in triples])),
            "field_x": _t(np.stack([np.asarray(jax.random.uniform(t[1], (h, w), f32, -1.0, 1.0))
                                    for t in triples])),
            "field_y": _t(np.stack([np.asarray(jax.random.uniform(t[2], (h, w), f32, -1.0, 1.0))
                                    for t in triples])),
        }
    return {}


def _levels_differ(a, b):
    return float(np.mean(np.floor(a * 255.0) != np.floor(b * 255.0)))


# atol on the [0,1] output. The blurs and filters are f32 products whose
# summation order differs between the two libraries (~2e-7). Elastic's two
# warps amplify that, and at severities 1-2 its affine anchor system has a
# condition number near 500 (32 px), so the JAX package's own float32 solve
# is off by ~4e-5 in the map; spatter's water branch is checked stage by
# stage in test_spatter_water_branch_stages, because it floors a box filter
# of integer distances, whose ties each library rounds its own way.
ATOL = {"elastic_transform": 1e-4, "spatter": 1e-4}
LEVELS = 1e-3  # at most this share of uint8 levels may differ


@pytest.mark.parametrize("severity", [1, 3, 5])
@pytest.mark.parametrize("name", NEW)
def test_corruption_matches_jax(name, severity):
    x = np.random.default_rng(severity).random((B, H, W, 3), dtype=np.float32)
    key = jax.random.key(severity)
    ref = np.asarray(jk.corrupt_batch(jnp.asarray(x), key, name, severity))
    got = pc.CORRUPTIONS[name](_t(x), severity,
                               **jax_draws(name, key, severity, H, W)).numpy()
    assert got.shape == ref.shape and got.dtype == np.float32
    if name == "spatter" and severity <= 3:
        # ties of the water branch (see ATOL): the dry pixels, where the
        # liquid layer is 0, are x itself in both, and most others agree
        assert np.mean(np.abs(got - ref) <= ATOL[name]) >= 0.8
        return
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL.get(name, 1e-5))
    assert _levels_differ(got, ref) <= LEVELS


def test_spatter_water_branch_stages():
    """Spatter's water branch (severity 3) one stage at a time, each stage
    fed the JAX package's output of the stage before, so that no tie of an
    earlier floor or threshold reaches it. Exact: the uint8 liquid, the
    edges (away from magnitudes within 1e-3 of a threshold), the chamfer
    distance and the equalization; atol 1e-5 relative for the filters."""
    c = pc.SPATTER_SEVERITY[2]
    key = jax.random.key(3)
    normal = np.asarray(jax.random.normal(key, (H, W), jnp.float32))
    x = np.random.default_rng(3).random((1, H, W, 3), dtype=np.float32)

    liquid_j = jimg.gaussian_blur(jnp.asarray(c[0] + c[1] * normal)[..., None], c[2])[..., 0]
    liquid_j = np.asarray(jnp.where(liquid_j < c[3], 0.0, liquid_j))
    liquid_p = pimg.gaussian_blur(_t(c[0] + c[1] * normal[None])[..., None], c[2])[..., 0]
    liquid_p = torch.where(liquid_p < c[3], 0.0, liquid_p)
    np.testing.assert_allclose(liquid_p[0].numpy(), liquid_j, rtol=0, atol=1e-6)

    u8 = np.floor(np.clip(liquid_j, 0.0, 1.0) * 255.0).astype(np.float32)
    edges_j = np.asarray(jk._sobel_edges(jnp.asarray(u8), 50.0, 150.0))
    edges_p = pc.sobel_edges(_t(u8[None]), 50.0, 150.0)[0].numpy()
    pad = np.pad(u8.astype(np.int64), 1, mode="reflect")
    gx = sum(int(k) * pad[i:i + H, j:j + W]
             for (i, j), k in np.ndenumerate(pc.SOBEL_X.astype(np.int64)))
    gy = sum(int(k) * pad[i:i + H, j:j + W]
             for (i, j), k in np.ndenumerate(pc.SOBEL_X.T.astype(np.int64)))
    mag = np.abs(gx) + np.abs(gy)
    near = np.zeros_like(mag, bool)
    for thr in (50, 150):  # the 3x3 hysteresis dilation spreads a tie
        tie = np.pad(mag == thr, 1)
        near |= sum(tie[i:i + H, j:j + W] for i in range(3) for j in range(3)) > 0
    assert edges_j.sum() > 0
    np.testing.assert_array_equal(edges_p[~near], edges_j[~near])

    dist_j = np.asarray(jk._chamfer_distance(jnp.asarray(edges_j > 0), 20.0, 12))
    dist_p = pc.chamfer_distance(_t(edges_j[None] > 0), 20.0, 12)[0].numpy()
    np.testing.assert_array_equal(dist_p, dist_j)

    box_j = np.asarray(jimg.filter2d_same(jnp.asarray(dist_j)[..., None], pc.BOX3))[..., 0]
    box_p = pimg.filter2d_same(_t(dist_j[None])[..., None], pc.BOX3)[0, ..., 0].numpy()
    np.testing.assert_allclose(box_p, box_j, rtol=0, atol=1e-5 * 20)

    lvl = np.floor(np.clip(box_j, 0, 255)).astype(np.float32)
    eq_j = np.asarray(jk._equalize_hist(jnp.asarray(lvl)))
    np.testing.assert_array_equal(pc.equalize_hist(_t(lvl[None]))[0].numpy(), eq_j)

    def rest_j(eq):
        d = jimg.filter2d_same(jnp.asarray(eq)[..., None], pc.EMBOSS)[..., 0]
        d = jimg.filter2d_same(jnp.clip(d, 0.0, 255.0)[..., None], pc.BOX3)[..., 0]
        m = jnp.asarray(liquid_j) * d
        return np.asarray(m / jnp.maximum(m.max(), 1e-12))

    d = pimg.filter2d_same(_t(eq_j[None])[..., None], pc.EMBOSS)[..., 0]
    d = pimg.filter2d_same(torch.clamp(d, 0.0, 255.0)[..., None], pc.BOX3)[..., 0]
    m = _t(liquid_j[None]) * d
    m = (m / torch.clamp_min(m.amax(dim=(-2, -1), keepdim=True), 1e-12))[0].numpy()
    np.testing.assert_allclose(m, rest_j(eq_j), rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", ["glass_blur", "snow", "spatter", "elastic_transform"])
def test_generator_draws_repeat(name):
    """The port's own draw: the same generator seed repeats, another seed
    differs, and the output stays in [0,1]."""
    x = torch.rand((B, H, W, 3), generator=torch.Generator().manual_seed(0))

    def run(seed):
        return pc.corrupt_batch(x, name, 2, generator=torch.Generator().manual_seed(seed))

    a = run(1)
    assert torch.equal(a, run(1)) and not torch.equal(a, run(2))
    assert float(a.min()) >= 0.0 and float(a.max()) <= 1.0


def test_registry_covers_every_corruption_and_refuses_unknown_names(tmp_path):
    """All 19 names of the JAX package's order are registered; an unknown
    name raises ValueError in corrupt_batch and in the online solver before
    any batch is read."""
    assert tuple(pc.CORRUPTIONS) == pc.CORRUPTION_ORDER == jk.CORRUPTION_ORDER
    with pytest.raises(ValueError, match="fogg"):
        pc.corrupt_batch(torch.zeros((1, 8, 8, 3)), "fogg", 1)
    test = {"corruptions": ["gaussian_noise", "fogg"], "severities": [1]}
    solver = PortSolver(PortConfig(_cfg(tmp_path, test)), device="cpu")
    with pytest.raises(ValueError, match="fogg"):
        solver.evaluate()
    assert not (tmp_path / "gaussian_noise").exists()


# ---------------------------------------------------------------------------
# the online slice
# ---------------------------------------------------------------------------


def _cfg(results, test):
    return {
        "model": {"type": "resnet18", "kwargs": {"num_classes": 10}},
        "seed": 0,
        "data": {
            "batch_size": 4, "num_workers": 2, "input_size": 32,
            "test_resize": 36, "read_from": "fake",
            "fake_size": 8, "fake_num_classes": 10,
            "test": {
                "imagenet_c_online": True, "transforms": {"type": "JUSTNORM"},
                "sampler": {"type": "distributed"},
                "evaluator": {"type": "imagenetc", "kwargs": {"topk": [1, 5]}},
                **test,
            },
        },
        "saver": {"results_dir": str(results)},
    }


def _scores(path):
    return np.array([json.loads(line)["score"] for line in open(path)])


@pytest.fixture(scope="module")
def jax_and_port(tmp_path_factory):
    """The JAX solver's classifier and a port solver holding its weights."""
    root = tmp_path_factory.mktemp("solvers")
    # severity 1's disk (alias blur 0.1) has 29 equal weights, so 3.5% of its
    # outputs on uint8 images are exact levels, which each library's
    # rounding floors its own way; severities 3 and 5 have smooth disks
    test = {"corruptions": ["defocus_blur"], "severities": [3, 5], "limit_samples": 8}
    jax_solver = JaxSolver(Config(_cfg(root / "jax", dict(test))))
    with pytest.MonkeyPatch.context() as mp:
        numpy_init(mp)
        jax_solver.build_model(seed=0)
    port = PortSolver(PortConfig(_cfg(root / "port", dict(test))), device="cpu")
    port.build_model(seed=0)
    flat = {k: np.asarray(v) for k, v in flatten(jax_solver.classifier.variables).items()}
    port.classifier.model.load_state_dict(convert.state_dict_from_flax(flat))
    return root, jax_solver, port


def test_online_defocus_matches_jax_solver(jax_and_port):
    """Both solvers online on the same fake images with the same weights,
    a deterministic corruption: logits within 1e-4·max|ref|."""
    root, jax_solver, port = jax_and_port
    assert port.evaluate() == jax_solver.evaluate()
    for sev in ("3", "5"):
        a = _scores(root / "jax" / "defocus_blur" / sev / "results.txt.all")
        b = _scores(root / "port" / "defocus_blur" / sev / "results.txt.all")
        assert a.shape == b.shape == (8, 10)
        assert np.abs(a - b).max() <= 1e-4 * np.abs(a).max()


def test_online_glass_chain_matches_jax(jax_and_port):
    """glass_blur with the JAX draw injected, through the chain the solvers
    run: u8 / 255 → corrupt → floor(·255) → classifier; logits within
    1e-4·max|ref|."""
    _, jax_solver, port = jax_and_port
    clf = jax_solver.classifier
    imgs = np.random.default_rng(6).integers(0, 256, (B, H, W, 3), np.uint8)
    key = jax.random.key(11)
    for severity in (1, 5):
        c = jk.corrupt_batch(jnp.asarray(imgs, jnp.float32) / 255.0, key, "glass_blur",
                             severity)
        ref = np.asarray(clf.apply_fn(clf.variables, jnp.floor(jnp.clip(c, 0.0, 1.0) * 255.0)
                                      / 255.0, train=False))
        x = pc.glass_blur(pc.to_unit(_t(imgs)), severity,
                          **jax_draws("glass_blur", key, severity, H, W))
        with torch.no_grad():
            got = port.classifier(pc.uint8_roundtrip(x)).numpy()
        assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()


def test_online_fused_equals_per_severity_new_corruptions(tmp_path):
    def run(name, fuse):
        test = {"fuse_severities": fuse, "corruptions": ["glass_blur", "snow", "spatter"],
                "severities": [1, 3], "limit_samples": 6}
        return PortSolver(PortConfig(_cfg(tmp_path / name, test)), device="cpu").evaluate()

    fused, split = run("fused", True), run("split", False)
    assert fused == split and fused["mCE"] is not None
    for corr in ("glass_blur", "snow", "spatter"):
        for sev in ("1", "3"):
            a = tmp_path / "fused" / corr / sev / "results.txt.all"
            assert len(a.read_text().splitlines()) == 6
            assert filecmp.cmp(a, tmp_path / "split" / corr / sev / "results.txt.all",
                               shallow=False)
