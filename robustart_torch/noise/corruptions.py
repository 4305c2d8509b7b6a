"""The 19 ImageNet-C corruptions in PyTorch.

Counterpart of ``robustart_tpu/noise/corruptions/jax_kernels.py`` and of
``robustart_tpu/noise/corruptions/__init__.py`` (``corrupt_batch``,
``CORRUPTION_ORDER``, the reference's single-image ``corrupt``). Each
corruption maps a batch (B, H, W, C) of [0,1] float32 images to a batch of
[0,1] images with the severity tables of the JAX package, which vmaps the
same functions over single images. The random draw comes from
``generator``, one draw for the whole batch, or is injected (the tests hand
in the JAX package's draw):

- ``normal=`` / ``uniform=``: the noise family, per element;
- ``offsets=`` (iters, B, H, W, 2) ints in [-d, d): glass_blur;
- ``angles=`` (B,) degrees: motion_blur and snow;
- ``normal=`` (B, H, W): the layer of snow and of spatter;
- ``fractal=``: fog's plasma fractal, one ``(u1, u2, u3)`` of (B, n, n)
  uniforms a level (:func:`plasma_draws`);
- ``idx=``, ``ys=``, ``xs=`` (B,): frost's texture and crop origin;
- ``affine=`` (B, 3, 2), ``field_x=`` / ``field_y=`` (B, H, W) in [-1, 1):
  elastic_transform.

defocus_blur, zoom_blur, gaussian_blur, contrast, brightness, saturate,
pixelate and jpeg_compression draw nothing. ``shot_noise`` is the exact
Poisson sampler (CDF inversion unrolled to ``kmax``), which the ImageNet-C
solver uses; the fused kernel's ``shot_noise`` mode is a Gaussian
approximation of it. The hand-written kernels on these paths are K2
(``ops/warp.py``: elastic_transform), K3 (``ops/motion.py``: motion_blur,
snow), K4 (glass_blur) and K5 (spatter); the rest is plain PyTorch, as the
JAX package computes it in plain XLA (jpeg_compression in
``noise/jpeg.py``, libjpeg's integer transcode).

Every division of a computed value by a constant is
``ops/image.py::div_const``, the product by the float32 reciprocal that XLA
compiles the JAX program's division into, and the multiply-adds that XLA
fuses are ``ops/image.py::fma``: one rounding each, the same on every
device, so a later ``floor`` to a uint8 level lands where the JAX solver's
does. A constant divided by a constant (frost's bank) is folded exactly, in
numpy, and :func:`corrupt` divides its image on the host, as the JAX
package's does.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from robustart_torch.noise.jpeg import jpeg_compression
from robustart_torch.ops.image import (
    disk_kernel,
    div_const,
    f32,
    filter2d_same,
    fma,
    gaussian_blur,
    hsv_to_rgb,
    matmul_h,
    matmul_w,
    on_device,
    pil_box_matrix,
    rgb_to_gray,
    rgb_to_hsv,
)
from robustart_torch.ops.motion import chamfer, glass_shuffle, motion_blur_bank
from robustart_torch.ops.warp import warp_bilinear

CORRUPTION_ORDER = (
    "gaussian_noise", "shot_noise", "impulse_noise", "defocus_blur",
    "glass_blur", "motion_blur", "zoom_blur", "snow", "frost", "fog",
    "brightness", "contrast", "elastic_transform", "pixelate",
    "jpeg_compression", "speckle_noise", "gaussian_blur", "spatter",
    "saturate",
)

# the per-severity parameter c of each noise corruption (jax_kernels.py)
NOISE_SEVERITY = {
    "gaussian_noise": (0.08, 0.12, 0.18, 0.26, 0.38),
    "shot_noise": (60.0, 25.0, 12.0, 5.0, 3.0),
    "impulse_noise": (0.03, 0.06, 0.09, 0.17, 0.27),
    "speckle_noise": (0.15, 0.2, 0.35, 0.45, 0.6),
}


def _draw_normal(x, generator, normal, shape=None):
    if normal is not None:
        return torch.as_tensor(normal, dtype=x.dtype, device=x.device)
    return torch.randn(shape or x.shape, dtype=x.dtype, device=x.device,
                       generator=generator)


def _draw_uniform(x, generator, uniform, dtype=None, shape=None, lo=0.0, hi=1.0):
    """The injected draw as given, else uniform in [lo, hi)."""
    dtype = dtype or x.dtype
    if uniform is not None:
        return torch.as_tensor(uniform, dtype=dtype, device=x.device)
    u = torch.rand(shape or x.shape, dtype=dtype, device=x.device, generator=generator)
    return u if (lo, hi) == (0.0, 1.0) else u * (hi - lo) + lo


def to_unit(images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 images → float32 in [0,1], the JAX solver's jitted ``/ 255.0``
    (:func:`div_const`). Brightness and saturate land many outputs exactly on
    a level, where an ulp of input moves the later floor."""
    return div_const(images_u8.to(torch.float32), 255.0)


def uint8_grid(x01: torch.Tensor) -> torch.Tensor:
    """The uint8 level of each value, by truncation, as the reference's
    np.uint8 casts do: ``floor(clamp(x, 0, 1)·255)``, in x's float type."""
    return torch.floor(torch.clamp(x01, 0.0, 1.0) * 255.0)


def uint8_roundtrip(x01: torch.Tensor) -> torch.Tensor:
    """Quantize through the uint8 grid (:func:`uint8_grid`) back to [0,1],
    by the JAX solver's jitted ``/ 255.0`` (:func:`div_const`)."""
    return div_const(uint8_grid(x01), 255.0)


def uint8_round(x01: torch.Tensor) -> torch.Tensor:
    """Quantize to the uint8 grid by rounding, as PIL's resampling stores
    its output (half up): ``floor(clamp(x, 0, 1)·255 + 0.5)`` back to
    [0,1] by :func:`div_const`, as the JAX program computes it (a box
    average of two levels of odd sum is a tie of the next rounding)."""
    return div_const(torch.floor(torch.clamp(x01, 0.0, 1.0) * 255.0 + 0.5), 255.0)


# ---------------------------------------------------------------------------
# noise family
# ---------------------------------------------------------------------------


def gaussian_noise(x, severity=1, *, generator=None, normal=None):
    c = NOISE_SEVERITY["gaussian_noise"][severity - 1]
    return torch.clamp(x + c * _draw_normal(x, generator, normal), 0.0, 1.0)


def poisson_inverse_cdf(lam: torch.Tensor, kmax: int, u: torch.Tensor) -> torch.Tensor:
    """Poisson via CDF inversion: X = min{k : U < CDF_k(lam)}, exact for the
    bounded rate here (lam ≤ c), unrolled to ``kmax`` terms."""
    p = torch.exp(-lam)
    cdf = p
    n = torch.zeros_like(lam)
    for k in range(kmax):
        n = n + (u >= cdf).to(torch.float32)
        p = p * (lam * (1.0 / (k + 1.0)))
        cdf = cdf + p
    return n


def shot_noise(x, severity=1, *, generator=None, uniform=None):
    c = NOISE_SEVERITY["shot_noise"][severity - 1]
    kmax = int(c + 12.0 * math.sqrt(c) + 12.0)
    u = _draw_uniform(x, generator, uniform, torch.float32)
    n = poisson_inverse_cdf(x.to(torch.float32) * c, kmax, u)
    return torch.clamp(div_const(n.to(x.dtype), c), 0.0, 1.0)


def impulse_noise(x, severity=1, *, generator=None, uniform=None):
    # skimage random_noise(mode='s&p', amount=c): elementwise salt (1.0) or
    # pepper (0.0) with probability c/2 each
    c = NOISE_SEVERITY["impulse_noise"][severity - 1]
    u = _draw_uniform(x, generator, uniform)
    x = torch.where(u < c / 2, 0.0, x)
    x = torch.where(u > 1.0 - c / 2, 1.0, x)
    return torch.clamp(x, 0.0, 1.0)


def speckle_noise(x, severity=1, *, generator=None, normal=None):
    c = NOISE_SEVERITY["speckle_noise"][severity - 1]
    return torch.clamp(x + x * c * _draw_normal(x, generator, normal), 0.0, 1.0)


# ---------------------------------------------------------------------------
# zoom helpers (scipy.ndimage.zoom, order 1)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def zoom_matrix(in_size: int, out_size: int) -> np.ndarray:
    """scipy.ndimage.zoom(order=1, grid_mode=False) 1-D matrix:
    x_in = i * (in-1)/(out-1) with bilinear taps."""
    w = np.zeros((out_size, in_size), dtype=np.float64)
    if out_size == 1:
        w[0, 0] = 1.0
        return w.astype(np.float32)
    ratio = (in_size - 1) / (out_size - 1)
    for i in range(out_size):
        src = i * ratio
        j0 = int(np.floor(src))
        frac = src - j0
        j0 = min(j0, in_size - 1)
        j1 = min(j0 + 1, in_size - 1)
        w[i, j0] += 1.0 - frac
        w[i, j1] += frac
    return w.astype(np.float32)


def _clipped_zoom_geometry(h: int, zoom: float) -> tuple[int, int, int, int]:
    """(top, ch, zh, trim) of the reference clipped_zoom: crop ch =
    ceil(h/zoom) from top, zoom to zh = round(ch·zoom) (Python's round, half
    to even), keep rows trim..trim+h."""
    ch = int(np.ceil(h / float(zoom)))
    zh = int(round(ch * float(zoom)))
    return (h - ch) // 2, ch, zh, (zh - h) // 2


def _clipped_zoom_matrix(h: int, zoom: float) -> np.ndarray:
    """The rows of the (zh, ch) zoom matrix that survive the trim."""
    _, ch, zh, trim = _clipped_zoom_geometry(h, zoom)
    return zoom_matrix(ch, zh)[trim:trim + h]


def clipped_zoom(img: torch.Tensor, zoom_factor: float) -> torch.Tensor:
    """Reference clipped_zoom (corruptions.py:105-115) of (B, H, W, C):
    center-crop ceil(h/zoom), scipy-zoom by the factor, trim back to h. The
    crop takes the row offset on both axes, as the JAX package does
    (square images)."""
    h = img.shape[1]
    top, ch, _, _ = _clipped_zoom_geometry(h, float(zoom_factor))
    crop = img[:, top:top + ch, top:top + ch]
    m = on_device(img.device, _clipped_zoom_matrix, h, float(zoom_factor))
    return matmul_w(m, matmul_h(m, crop))


# ---------------------------------------------------------------------------
# blur family
# ---------------------------------------------------------------------------

GLASS_SEVERITY = ((0.7, 1, 2), (0.9, 2, 1), (1, 2, 3), (1.1, 3, 2), (1.5, 4, 2))
DEFOCUS_SEVERITY = ((3, 0.1), (4, 0.5), (6, 0.5), (8, 0.5), (10, 0.5))
MOTION_SEVERITY = ((10, 3), (15, 5), (15, 8), (15, 12), (20, 15))
ZOOM_FACTORS = (
    np.arange(1, 1.11, 0.01),
    np.arange(1, 1.16, 0.01),
    np.arange(1, 1.21, 0.02),
    np.arange(1, 1.26, 0.02),
    np.arange(1, 1.31, 0.03),
)
N_ANGLES = 32
MOTION_BANK = tuple(float(a) for a in np.linspace(-45.0, 45.0, N_ANGLES))
SNOW_BANK = tuple(float(a) for a in np.linspace(-135.0, -45.0, N_ANGLES))


def gaussian_blur_c(x, severity=1, *, generator=None):
    c = (1, 2, 3, 4, 6)[severity - 1]
    return torch.clamp(gaussian_blur(x, float(c)), 0.0, 1.0)


def glass_blur(x, severity=1, *, generator=None, offsets=None):
    """Blur, uint8 grid, 1-3 passes of the pixel shuffle (K4, the gather
    approximation of the reference's sequential swap loop), blur."""
    sigma, d, iters = GLASS_SEVERITY[severity - 1]
    b, h, w, _ = x.shape
    x = uint8_roundtrip(gaussian_blur(x, float(sigma))).contiguous()
    for i in range(iters):
        if offsets is not None:
            off = torch.as_tensor(offsets[i], device=x.device).to(torch.int64)
        else:
            off = torch.randint(-d, d, (b, h, w, 2), device=x.device, generator=generator)
        code = ((off[..., 0] + d) * (2 * d) + (off[..., 1] + d)).to(torch.uint8)
        x = glass_shuffle(x, code, d)
    return torch.clamp(gaussian_blur(x, float(sigma)), 0.0, 1.0)


def defocus_blur(x, severity=1, *, generator=None):
    radius, alias = DEFOCUS_SEVERITY[severity - 1]
    return torch.clamp(filter2d_same(x, disk_kernel(radius, alias)), 0.0, 1.0)


def _bank_index(angle: torch.Tensor, lo: float) -> torch.Tensor:
    """Nearest of the N_ANGLES bank angles spread over [lo, lo + 90]."""
    idx = torch.round(div_const(angle - lo, 90.0) * (N_ANGLES - 1))
    return idx.to(torch.int64).clamp(0, N_ANGLES - 1)


def motion_blur_c(x, severity=1, *, generator=None, angles=None):
    """ImageMagick motion blur at a per-image angle in [-45, 45), taken to
    the nearest of 32 bank angles (K3, C = 3)."""
    radius, sigma = MOTION_SEVERITY[severity - 1]
    angle = _draw_uniform(x, generator, angles, torch.float32, (x.shape[0],), -45.0, 45.0)
    out = motion_blur_bank(x.contiguous(), _bank_index(angle, -45.0), float(radius),
                           float(sigma), MOTION_BANK)
    return torch.clamp(out, 0.0, 1.0)


def zoom_blur(x, severity=1, *, generator=None):
    factors = ZOOM_FACTORS[severity - 1]
    out = x
    for z in factors:
        out = out + clipped_zoom(x, float(z))
    return torch.clamp(div_const(out, len(factors) + 1), 0.0, 1.0)


# ---------------------------------------------------------------------------
# weather: snow
# ---------------------------------------------------------------------------

SNOW_SEVERITY = (
    (0.1, 0.3, 3, 0.5, 10, 4, 0.8),
    (0.2, 0.3, 2, 0.5, 12, 4, 0.7),
    (0.55, 0.3, 4, 0.9, 12, 8, 0.7),
    (0.55, 0.3, 4.5, 0.85, 12, 8, 0.65),
    (0.55, 0.3, 2.5, 0.85, 12, 12, 0.55),
)


def snow(x, severity=1, *, generator=None, normal=None, angles=None):
    """A zoomed, thresholded noise layer motion-blurred at a per-image angle
    in [-135, -45) (K3, C = 1), added twice (once turned by 180°) to the
    gray-boosted image."""
    c = SNOW_SEVERITY[severity - 1]
    b, h, w, _ = x.shape
    layer = c[0] + c[1] * _draw_normal(x, generator, normal, (b, h, w))
    layer = clipped_zoom(layer[..., None], c[2])
    layer = torch.where(layer < c[3], 0.0, layer)
    layer = uint8_roundtrip(layer).contiguous()
    angle = _draw_uniform(x, generator, angles, torch.float32, (b,), -135.0, -45.0)
    layer = motion_blur_bank(layer, _bank_index(angle, -135.0), float(c[4]),
                             float(c[5]), SNOW_BANK)
    layer = uint8_roundtrip(layer)
    gray_boost = rgb_to_gray(x)[..., None] * 1.5 + 0.5
    x = c[6] * x + (1 - c[6]) * torch.maximum(x, gray_boost)
    return torch.clamp(x + layer + torch.flip(layer, dims=(-3, -2)), 0.0, 1.0)


# ---------------------------------------------------------------------------
# weather: fog and frost
# ---------------------------------------------------------------------------

FOG_SEVERITY = ((1.5, 2), (2.0, 2), (2.5, 1.7), (2.5, 1.5), (3.0, 1.4))
FROST_SEVERITY = ((1, 0.4), (0.8, 0.6), (0.7, 0.7), (0.65, 0.7), (0.6, 0.75))


def fog_mapsize(h: int, w: int) -> int:
    """The plasma fractal's size for an h × w image: the next power of two
    of max(h, w) (itself if it is one), at least 256."""
    m = max(h, w)
    return max(1 << m.bit_length() if m & (m - 1) else m, 256)


def plasma_draws(b: int, mapsize: int, wibbledecay: float, generator=None,
                 device=None) -> list:
    """The random draw of :func:`plasma_fractal`: for each level of the
    diamond-square, three (b, n, n) arrays uniform in (-wibble, wibble),
    n = mapsize / stepsize, wibble = 100 / wibbledecay^level."""
    draws, n, wibble = [], 1, 100.0
    while n < mapsize:
        draws.append(tuple(
            torch.rand((b, n, n), generator=generator, device=device) * (2 * wibble) - wibble
            for _ in range(3)))
        n *= 2
        wibble /= wibbledecay
    return draws


def plasma_fractal(b: int, mapsize: int = 256, wibbledecay: float = 3.0, *,
                   generator=None, fractal=None, device=None) -> torch.Tensor:
    """Diamond-square heightmaps (b, mapsize, mapsize), each normalized to
    [0, 1] (reference corruptions.py:55-102, with its ``wibble ·
    uniform(-wibble, wibble)`` noise scale). ``fractal``: the draw of
    :func:`plasma_draws`, one ``(u1, u2, u3)`` a level, injected."""
    if fractal is None:
        fractal = plasma_draws(b, mapsize, wibbledecay, generator, device)
    m = torch.zeros((b, mapsize, mapsize), dtype=torch.float32,
                    device=fractal[0][0].device)
    stepsize, wibble = mapsize, 100.0
    for u1, u2, u3 in fractal:
        half = stepsize // 2
        # fill the squares
        corner = m[:, 0::stepsize, 0::stepsize]
        acc = corner + torch.roll(corner, -1, dims=1)
        acc = acc + torch.roll(acc, -1, dims=2)
        m[:, half::stepsize, half::stepsize] = div_const(acc, 4.0) + wibble * u1
        # fill the diamonds
        drgrid = m[:, half::stepsize, half::stepsize]
        ulgrid = m[:, 0::stepsize, 0::stepsize]
        ldrsum = drgrid + torch.roll(drgrid, 1, dims=1)
        lulsum = ulgrid + torch.roll(ulgrid, -1, dims=2)
        ltsum = div_const(ldrsum + lulsum, 4.0) + wibble * u2
        tdrsum = drgrid + torch.roll(drgrid, 1, dims=2)
        tulsum = ulgrid + torch.roll(ulgrid, -1, dims=1)
        m[:, 0::stepsize, half::stepsize] = ltsum
        m[:, half::stepsize, 0::stepsize] = div_const(tdrsum + tulsum, 4.0) + wibble * u3
        stepsize //= 2
        wibble /= wibbledecay
    m = m - m.amin(dim=(1, 2), keepdim=True)
    return m / m.amax(dim=(1, 2), keepdim=True)


def fog(x, severity=1, *, generator=None, fractal=None):
    """A plasma fractal per image added to the image, then scaled back by
    max / (max + c0), max the image's own."""
    c0, decay = FOG_SEVERITY[severity - 1]
    b, h, w, _ = x.shape
    max_val = x.amax(dim=(1, 2, 3), keepdim=True)
    frac = plasma_fractal(b, fog_mapsize(h, w), decay, generator=generator,
                          fractal=fractal, device=x.device)
    x = x + c0 * frac[:, :h, :w, None]
    return torch.clamp(x * max_val / (max_val + c0), 0.0, 1.0)


@functools.lru_cache(maxsize=1)
def frost_bank(size: int = 320) -> np.ndarray:
    """Six procedural frost textures (6, size, size, 3) in [0, 255]: the
    reference blends six frost photographs (corruptions.py:244-263) that
    the snapshot lacks, so the JAX package makes these from a fixed seed
    (fractal noise, a directional streak); this is the same numpy
    computation, bitwise its bank."""
    rng = np.random.default_rng(20260816)
    bank = []
    for _ in range(6):
        base = rng.normal(0.65, 0.2, size=(size, size))
        acc = np.zeros((size, size))
        for octave, s in enumerate([4, 8, 16, 32]):
            layer = rng.normal(0, 1, size=(size // s + 1, size // s + 1))
            layer = np.kron(layer, np.ones((s, s)))[:size, :size]
            acc += layer / (octave + 1)
        tex = base + 0.15 * acc
        angle = rng.uniform(0, np.pi)
        ky, kx = np.sin(angle), np.cos(angle)
        yy, xx = np.mgrid[0:size, 0:size]
        streak = 0.08 * np.sin((yy * ky + xx * kx) * rng.uniform(0.3, 0.9))
        tex = np.clip(tex + streak, 0, 1.3)
        tex = (tex - tex.min()) / (tex.max() - tex.min())
        img = np.stack([tex * 255, tex * 245 + 5, tex * 235 + 15], axis=-1)
        bank.append(img.astype(np.float32))
    return np.stack(bank)


def _frost_bank_unit() -> np.ndarray:
    return frost_bank() / np.float32(255.0)


def frost_draws(b: int, h: int, w: int, generator=None, device=None):
    """frost's draw for b images of h × w: a texture in [0, 6) and a crop
    origin ys in [0, S − h), xs in [0, S − w) of the S × S bank; an empty
    range draws 0, as ``jax.random.randint`` does."""
    n, size = frost_bank().shape[:2]
    return tuple(torch.randint(0, max(hi, 1), (b,), generator=generator, device=device)
                 for hi in (n, size - h, size - w))


def frost(x, severity=1, *, generator=None, idx=None, ys=None, xs=None):
    """The image blended with a crop of one of :func:`frost_bank`'s
    textures: ``ca·x + cb·crop``. The crop is plain indexing; rows or
    columns past the bank (images over 320 px) read 0, as the JAX
    package's one-hot crop does."""
    ca, cb = FROST_SEVERITY[severity - 1]
    b, h, w, _ = x.shape
    if idx is None:
        idx, ys, xs = frost_draws(b, h, w, generator, x.device)
    bank = on_device(x.device, _frost_bank_unit)
    size = bank.shape[1]
    rows = torch.as_tensor(ys, device=x.device)[:, None] + torch.arange(h, device=x.device)
    cols = torch.as_tensor(xs, device=x.device)[:, None] + torch.arange(w, device=x.device)
    tex = torch.as_tensor(idx, device=x.device).to(torch.int64)[:, None, None]
    crop = bank[tex, rows.clamp_max(size - 1)[:, :, None], cols.clamp_max(size - 1)[:, None, :]]
    inside = (rows < size)[:, :, None, None] & (cols < size)[:, None, :, None]
    crop = torch.where(inside, crop, 0.0)
    return torch.clamp(ca * x + cb * crop, 0.0, 1.0)


# ---------------------------------------------------------------------------
# weather: spatter (water branch: edges, chamfer distance, equalization)
# ---------------------------------------------------------------------------

SPATTER_SEVERITY = (
    (0.65, 0.3, 4, 0.69, 0.6, 0),
    (0.65, 0.3, 3, 0.68, 0.6, 0),
    (0.65, 0.3, 2, 0.68, 0.5, 0),
    (0.65, 0.3, 1, 0.65, 1.5, 1),
    (0.67, 0.4, 1, 0.65, 1.5, 1),
)
SOBEL_X = np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], np.float32)
BOX3 = np.ones((3, 3), np.float32) / 9.0
EMBOSS = np.array([[-2, -1, 0], [-1, 1, 1], [0, 1, 2]], np.float32)


def sobel_edges(gray: torch.Tensor, low: float, high: float) -> torch.Tensor:
    """Canny-style binary edges of (B, H, W): sobel L1 magnitude, double
    threshold, one hysteresis dilation pass (approximation of cv2.Canny)."""
    gx = filter2d_same(gray[..., None], SOBEL_X)[..., 0]
    gy = filter2d_same(gray[..., None], SOBEL_X.T)[..., 0]
    mag = torch.abs(gx) + torch.abs(gy)
    strong = mag >= high
    weak = mag >= low
    neigh = filter2d_same(strong.to(torch.float32)[..., None],
                          np.ones((3, 3), np.float32))[..., 0]
    return (strong | (weak & (neigh > 0))).to(torch.float32)


def chamfer_distance(zero_mask: torch.Tensor, cap: float, iters: int) -> torch.Tensor:
    """Distance of each pixel of (B, H, W) to the nearest True pixel of
    ``zero_mask`` by chamfer 5x5 propagation (cv2.distanceTransform
    DIST_L2/maskSize=5 analog), capped (K5)."""
    dist = torch.where(zero_mask, 0.0, float(cap)).to(torch.float32)
    return chamfer(dist.contiguous(), cap, iters)


def equalize_hist(u8: torch.Tensor) -> torch.Tensor:
    """cv2.equalizeHist of each (H, W) map of (B, H, W) uint8-valued floats:
    an exact integer histogram per image, its cumulative sum, the LUT
    rounded half to even (as ``jnp.round``)."""
    b = u8.shape[0]
    idx = u8.reshape(b, -1).to(torch.int64)
    n = idx.shape[1]
    hist = torch.zeros((b, 256), dtype=torch.int32, device=u8.device)
    hist.scatter_add_(1, idx, torch.ones_like(idx, dtype=torch.int32))
    cdf = torch.cumsum(hist.to(torch.float32), dim=1)  # exact: counts < 2^24
    first = torch.argmax((hist > 0).to(torch.int32), dim=1, keepdim=True)
    cdf_min = torch.gather(cdf, 1, first)
    lut = torch.round((cdf - cdf_min) / torch.clamp_min(n - cdf_min, 1.0) * 255.0)
    lut = torch.clamp(lut, 0.0, 255.0)
    return torch.gather(lut, 1, idx).reshape(u8.shape)


def spatter(x, severity=1, *, generator=None, normal=None):
    """A blurred, thresholded liquid layer: water (severities 1-3: edges,
    chamfer distance, equalization, emboss) or mud (severities 4-5)."""
    c = SPATTER_SEVERITY[severity - 1]
    b, h, w, _ = x.shape
    liquid = c[0] + c[1] * _draw_normal(x, generator, normal, (b, h, w))
    liquid = gaussian_blur(liquid[..., None], float(c[2]))[..., 0]
    liquid = torch.where(liquid < c[3], 0.0, liquid)
    if c[5] == 0:
        # water branch, reference corruptions.py:327-350
        liquid_u8 = torch.floor(torch.clamp(liquid, 0.0, 1.0) * 255.0)
        edges = sobel_edges(liquid_u8, 50.0, 150.0)
        dist = chamfer_distance(edges > 0, cap=20.0, iters=12)
        # cv2: threshold-trunc at 20, 3x3 blur, equalizeHist
        dist = filter2d_same(dist[..., None], BOX3)[..., 0]
        dist = equalize_hist(torch.floor(torch.clamp(dist, 0.0, 255.0)))
        dist = filter2d_same(dist[..., None].to(x.dtype), EMBOSS)[..., 0]
        dist = torch.clamp(dist, 0.0, 255.0)  # cv2.CV_8U saturation
        dist = filter2d_same(dist[..., None], BOX3)[..., 0]
        m = liquid * dist
        m = m / torch.clamp_min(m.amax(dim=(-2, -1), keepdim=True), 1e-12)
        m = (m * c[4])[..., None]
        color = torch.tensor([175 / 255.0, 238 / 255.0, 238 / 255.0], dtype=x.dtype,
                             device=x.device)
        return torch.clamp(x + m * color, 0.0, 1.0)
    # mud branch, reference corruptions.py:351-364
    m = torch.where(liquid > c[3], 1.0, 0.0).to(x.dtype)
    m = gaussian_blur(m[..., None], float(c[4]))[..., 0]
    m = torch.where(m < 0.8, 0.0, m)[..., None]
    color = torch.tensor([63 / 255.0, 42 / 255.0, 20 / 255.0], dtype=x.dtype,
                         device=x.device)
    return torch.clamp(x * (1.0 - m) + color * m, 0.0, 1.0)


# ---------------------------------------------------------------------------
# digital: contrast, brightness, saturate, pixelate
# ---------------------------------------------------------------------------

CONTRAST_SEVERITY = (0.4, 0.3, 0.2, 0.1, 0.05)
BRIGHTNESS_SEVERITY = (0.1, 0.2, 0.3, 0.4, 0.5)
SATURATE_SEVERITY = ((0.3, 0), (0.1, 0), (2, 0), (5, 0.1), (20, 0.2))
PIXELATE_SEVERITY = (0.6, 0.5, 0.4, 0.3, 0.25)


def contrast(x, severity=1, *, generator=None):
    """Each image's channels pulled toward their means over (H, W)."""
    c = CONTRAST_SEVERITY[severity - 1]
    means = x.mean(dim=(1, 2), keepdim=True)
    return torch.clamp((x - means) * c + means, 0.0, 1.0)


def brightness(x, severity=1, *, generator=None):
    """The HSV value raised by c."""
    c = BRIGHTNESS_SEVERITY[severity - 1]
    h, s, v = rgb_to_hsv(x).unbind(-1)
    hsv = torch.stack([h, s, torch.clamp(v + c, 0.0, 1.0)], dim=-1)
    return torch.clamp(hsv_to_rgb(hsv), 0.0, 1.0)


def saturate(x, severity=1, *, generator=None):
    """The HSV saturation scaled and shifted (``s·cs + cb`` rounded once,
    :func:`fma`, as the JAX package's program computes it)."""
    cs, cb = SATURATE_SEVERITY[severity - 1]
    h, s, v = rgb_to_hsv(x).unbind(-1)
    hsv = torch.stack([h, torch.clamp(fma(s, f32(cs), f32(cb)), 0.0, 1.0), v], dim=-1)
    return torch.clamp(hsv_to_rgb(hsv), 0.0, 1.0)


def pil_u8_resize(x01: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """PIL's 8-bit box resize of (B, H, W, C): the horizontal pass, stored
    as uint8 (:func:`uint8_round`), then the vertical pass, rounded again
    (Pillow Resample.c ImagingResampleInner)."""
    h_in, w_in = x01.shape[1], x01.shape[2]
    ww = on_device(x01.device, pil_box_matrix, w_in, out_hw[1])
    wh = on_device(x01.device, pil_box_matrix, h_in, out_hw[0])
    return uint8_round(matmul_h(wh, uint8_round(matmul_w(ww, x01))))


def pixelate(x, severity=1, *, generator=None):
    """PIL box resize of the uint8 image down to int(h·c) × int(w·c) and
    back up (reference corruptions.py:385-391)."""
    c = PIXELATE_SEVERITY[severity - 1]
    h, w = x.shape[1], x.shape[2]
    down = pil_u8_resize(x, (int(h * c), int(w * c)))
    return torch.clamp(pil_u8_resize(down, (h, w)), 0.0, 1.0)


# ---------------------------------------------------------------------------
# digital: elastic_transform
# ---------------------------------------------------------------------------

# the reference's 244 quirk (corruptions.py:392-396): (alpha, sigma, affine)
ELASTIC_SEVERITY = (
    (244 * 2, 244 * 0.7, 244 * 0.1),
    (244 * 2, 244 * 0.08, 244 * 0.2),
    (244 * 0.05, 244 * 0.01, 244 * 0.02),
    (244 * 0.07, 244 * 0.01, 244 * 0.02),
    (244 * 0.12, 244 * 0.01, 244 * 0.02),
)


def elastic_coords(x, severity=1, *, generator=None, affine=None, field_x=None,
                   field_y=None):
    """The sample coordinates of elastic_transform's two K2 warps of the
    batch ``x`` (B, H, W, C): ``((cy, cx), (cy, cx))``, each (B, H, W) f32
    and contiguous. The first pair is a random affine map of three anchor
    points (cv2.getAffineTransform + warpAffine), the second the identity
    plus a gaussian-smoothed random field. The draws come in the order
    affine, field_x, field_y, from ``generator`` or injected."""
    ca, cb, cc = ELASTIC_SEVERITY[severity - 1]
    b, h, w, _ = x.shape
    dev = x.device
    cy, cx, sq = float(h // 2), float(w // 2), float(min(h, w) // 3)
    pts1 = torch.tensor([[cx + sq, cy + sq], [cx + sq, cy - sq], [cx - sq, cy - sq]],
                        dtype=torch.float32, device=dev).expand(b, 3, 2)
    pts2 = pts1 + _draw_uniform(x, generator, affine, torch.float32, (b, 3, 2), -cc, cc)
    ones = torch.ones((b, 3, 1), dtype=torch.float32, device=dev)
    # warpAffine maps output coords through the inverse map, output -> input:
    # [x y 1] @ minv_t. The anchor system is ill-conditioned at severities
    # 1-2 (condition ~500 at 32 px), so it is solved in float64 and rounded
    # once, and the map is applied elementwise in a fixed order: the card
    # and the CPU then compute the same coordinates.
    minv_t = torch.linalg.solve_ex(torch.cat([pts2, ones], dim=-1).double(),
                                   pts1.double())[0].float()  # (B, 3, 2)
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev), indexing="ij")
    m = minv_t[:, :, None, None, :]  # (B, 3, 1, 1, 2)
    srcpts = xx[..., None] * m[:, 0] + yy[..., None] * m[:, 1] + m[:, 2]  # (B, H, W, 2)

    # gaussian-smoothed random displacement field, sigma=cb, truncate=3
    dx = _draw_uniform(x, generator, field_x, torch.float32, (b, h, w), -1.0, 1.0)
    dy = _draw_uniform(x, generator, field_y, torch.float32, (b, h, w), -1.0, 1.0)
    dx = gaussian_blur(dx[..., None], float(cb), truncate=3.0)[..., 0] * ca
    dy = gaussian_blur(dy[..., None], float(cb), truncate=3.0)[..., 0] * ca
    return ((srcpts[..., 1].contiguous(), srcpts[..., 0].contiguous()),
            ((yy + dy).contiguous(), (xx + dx).contiguous()))


def elastic_transform(x, severity=1, *, generator=None, affine=None, field_x=None,
                      field_y=None):
    """A random affine warp of three anchor points (cv2.getAffineTransform +
    warpAffine), then a warp by a gaussian-smoothed random field: two K2
    warps per image, at :func:`elastic_coords`' coordinates."""
    first, second = elastic_coords(x, severity, generator=generator, affine=affine,
                                   field_x=field_x, field_y=field_y)
    out = warp_bilinear(warp_bilinear(x.contiguous(), *first), *second)
    return torch.clamp(out, 0.0, 1.0)


CORRUPTIONS = {
    "gaussian_noise": gaussian_noise,
    "shot_noise": shot_noise,
    "impulse_noise": impulse_noise,
    "defocus_blur": defocus_blur,
    "glass_blur": glass_blur,
    "motion_blur": motion_blur_c,
    "zoom_blur": zoom_blur,
    "snow": snow,
    "frost": frost,
    "fog": fog,
    "brightness": brightness,
    "contrast": contrast,
    "elastic_transform": elastic_transform,
    "pixelate": pixelate,
    "jpeg_compression": jpeg_compression,
    "speckle_noise": speckle_noise,
    "gaussian_blur": gaussian_blur_c,
    "spatter": spatter,
    "saturate": saturate,
}


def corrupt_batch(x: torch.Tensor, name: str, severity: int = 1, *,
                  generator: torch.Generator | None = None) -> torch.Tensor:
    """Apply one corruption to a batch (B, H, W, 3) of [0,1] images."""
    if name not in CORRUPTIONS:
        raise ValueError(f"unknown corruption {name!r}")
    return CORRUPTIONS[name](x, severity, generator=generator)


# ---------------------------------------------------------------------------
# the reference's single-image API (robustart_tpu/noise/corruptions/__init__.py)
# ---------------------------------------------------------------------------


def corrupt(x, severity: int = 1, corruption_name: str | None = None,
            corruption_number: int = -1, seed: int | None = None,
            device: str | torch.device = "cuda") -> np.ndarray:
    """One image corrupted, with the reference's call signature.

    :param x: a PIL image or an (H, W, 3) (or (H, W)) array of levels.
    :param severity: 1-5.
    :param corruption_name: a name of ``CORRUPTION_ORDER``, else
        ``corruption_number`` indexes it.
    :param seed: the generator's seed (the reference draws from numpy's
        global state; None seeds it anew).
    :param device: where :func:`corrupt_batch` runs (jpeg_compression too:
        ``noise/jpeg.py`` is bitwise PIL's round trip).
    :return: (H, W, 3) uint8, by a truncating cast as the reference's.
    """
    if corruption_name is None:
        if corruption_number == -1:
            raise ValueError("Either corruption_name or corruption_number must be passed")
        corruption_name = CORRUPTION_ORDER[corruption_number]
    if corruption_name not in CORRUPTION_ORDER:
        raise KeyError(f"unknown corruption {corruption_name!r}")
    arr = np.asarray(x)
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    x01 = torch.from_numpy(arr.astype(np.float32) / 255.0).to(device)
    gen = torch.Generator(device=x01.device)
    if seed is None:
        gen.seed()
    else:
        gen.manual_seed(int(seed))
    out = corrupt_batch(x01[None], corruption_name, severity, generator=gen)[0]
    return torch.floor(out * 255.0).to(torch.uint8).cpu().numpy()


def _make_named(name: str):
    def fn(x, severity: int = 1, device: str | torch.device = "cuda"):
        return corrupt(x, severity=severity, corruption_name=name, device=device)

    fn.__name__ = name
    return fn


corruption_tuple = tuple(_make_named(n) for n in CORRUPTION_ORDER)
corruption_dict = {fn.__name__: fn for fn in corruption_tuple}
