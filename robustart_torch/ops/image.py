"""Image ops of the blur and weather corruptions, in plain PyTorch.

Counterpart of the part of ``robustart_tpu/ops/image.py`` that the
corruptions of ``robustart_torch.noise.corruptions`` use: the scipy gaussian
blur (:208-279), the defocus disk (:283), cv2's ``filter2D`` with its
reflect-101 border (:311-392), ImageMagick's motion-blur taps (:396-457) and
cv2's RGB→gray weights (:497), skimage's RGB↔HSV (:465, :483) and PIL's
box resize matrix (:78-158, pixelate's, :func:`pil_box_matrix`). The bilinear warp (:568) is
``robustart_torch.ops.warp`` and the motion-tap kernel
``robustart_torch.ops.motion``.

Tensors are channels-last, ``(..., H, W, C)``, as in the JAX package. The
blurs and filters are products with banded matrices built once on the host
(numpy, float64, then float32) with the border folded into the edge rows, so
no padded image is ever made. The products run in full float32, as the JAX
package runs them at ``Precision.HIGHEST``: on the card that is PyTorch's
default (``torch.backends.cuda.matmul.allow_tf32`` False); a convolution
would go through cuDNN, which takes TF32 by default, so none is used here.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


def f32(c: float) -> float:
    """The float32 value of a Python constant, as a program in float32 holds it."""
    return float(np.float32(c))


def div_const(x: torch.Tensor, c: float) -> torch.Tensor:
    """The JAX package's ``x / c`` for a constant ``c``: ``x · fl32(1/c)``.

    Under ``jit`` XLA compiles a computed value's division by a constant
    into this product by the float32 reciprocal, so this is the JAX
    program's own arithmetic, one rounding, the same on every device
    (torch's own ``x / c`` divides on the CPU and multiplies on the card).
    On uint8 levels the two differ by an ulp at about half the levels, and
    a later ``floor`` can then move to the next level."""
    return x * f32(1.0 / c)


def fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """``a·b + c`` rounded once to a's float32, as a fused multiply-add
    rounds it: the float32 product is exact in float64 and the sum rounds
    there first (a second rounding that can differ from the fused one only
    on a float32 midpoint, about 2^-29 of values). Each step is one IEEE
    operation, so every device computes the same value; XLA fuses the
    JAX package's multiply-adds this way on the CPU."""
    return (a.to(torch.float64) * b + c).to(a.dtype)


@functools.lru_cache(maxsize=None)
def on_device(device: torch.device, fn, *args) -> torch.Tensor:
    """``torch.from_numpy(fn(*args))`` on ``device``, made once per process:
    the host-built matrices and tables of the ops below."""
    return torch.from_numpy(np.ascontiguousarray(fn(*args))).to(device)


def matmul_h(m: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``m`` (I, H) applied along the H axis of ``x`` (..., H, W, C)."""
    return torch.einsum("ih,...hwc->...iwc", m, x)


def matmul_w(m: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``m`` (J, W) applied along the W axis of ``x`` (..., H, W, C)."""
    return torch.einsum("jw,...hwc->...hjc", m, x)


# ---------------------------------------------------------------------------
# gaussian blur (scipy.ndimage / skimage, 'nearest' border)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def gaussian_kernel_1d(sigma: float, truncate: float = 4.0) -> np.ndarray:
    """scipy.ndimage-compatible 1-D gaussian (radius = int(truncate*sigma+0.5))."""
    radius = int(truncate * sigma + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


@functools.lru_cache(maxsize=None)
def nearest_blur_matrix(n: int, sigma: float, truncate: float) -> np.ndarray:
    """(n, n) banded matrix G with G[i, j] = Σ_t k[t]·[clip(i+t-r, 0, n-1)=j]:
    one axis of the separable blur with scipy's 'nearest' border folded into
    the edge columns. A radius beyond the image (elastic_transform's σ up to
    170.8 at truncate 3 has radius 512) folds into the edges the same way."""
    k = gaussian_kernel_1d(sigma, truncate).astype(np.float64)
    r = (len(k) - 1) // 2
    g = np.zeros((n, n), np.float64)
    idx = np.arange(n)
    for t, kt in enumerate(k):
        np.add.at(g, (idx, np.clip(idx + t - r, 0, n - 1)), kt)
    return g.astype(np.float32)


def gaussian_blur(x: torch.Tensor, sigma: float, truncate: float = 4.0) -> torch.Tensor:
    """Gaussian blur of (..., H, W, C), scipy/skimage 'nearest' semantics:
    the banded-matrix form of the JAX package (``_sep_blur_matmul``) at
    every size; below 16 px the JAX package sums taps instead, which agrees
    to about 1e-7."""
    if sigma <= 0:
        return x
    h, w = x.shape[-3], x.shape[-2]
    gh = on_device(x.device, nearest_blur_matrix, h, float(sigma), float(truncate))
    gw = on_device(x.device, nearest_blur_matrix, w, float(sigma), float(truncate))
    return matmul_w(gw, matmul_h(gh, x))


# ---------------------------------------------------------------------------
# defocus disk and cv2.filter2D (reflect-101 border)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def disk_kernel(radius: int, alias_blur: float = 0.1) -> np.ndarray:
    """Defocus disk kernel (reference corruptions.py:26-37): a binary disk,
    normalized, then smoothed as cv2.GaussianBlur does (reflect-101)."""
    if radius <= 8:
        coords = np.arange(-8, 8 + 1)
        ksize = 3
    else:
        coords = np.arange(-radius, radius + 1)
        ksize = 5
    xg, yg = np.meshgrid(coords, coords)
    aliased = np.array((xg**2 + yg**2) <= radius**2, dtype=np.float64)
    aliased /= aliased.sum()
    half = (ksize - 1) // 2
    t = np.arange(-half, half + 1, dtype=np.float64)
    g = np.exp(-0.5 * (t / alias_blur) ** 2)
    g /= g.sum()
    pad = np.pad(aliased, half, mode="reflect")
    tmp = np.zeros_like(aliased)
    for i, gv in enumerate(g):
        tmp += gv * pad[i : i + aliased.shape[0], half : half + aliased.shape[1]]
    out = np.zeros_like(aliased)
    pad = np.pad(tmp, half, mode="reflect")
    for i, gv in enumerate(g):
        out += gv * pad[half : half + aliased.shape[0], i : i + aliased.shape[1]]
    return out.astype(np.float32)


def _refl101(j: np.ndarray, n: int) -> np.ndarray:
    """cv2 BORDER_REFLECT_101 index map (edge not repeated): …3 2 1 |0 1 2
    … n-1| n-2 n-3…"""
    if n == 1:
        return np.zeros_like(j)
    m = 2 * (n - 1)
    j = np.abs(j) % m
    return np.where(j >= n, m - j, j)


@functools.lru_cache(maxsize=None)
def reflect101_matrix(n: int, taps_bytes: bytes) -> np.ndarray:
    """(n, n) matrix of a 1-D correlation with reflect-101 border:
    out[i] = Σ_t taps[t]·x[refl101(i + t - r)]."""
    taps = np.frombuffer(taps_bytes, np.float64)
    r = (len(taps) - 1) // 2
    g = np.zeros((n, n), np.float64)
    idx = np.arange(n)
    for t, kt in enumerate(taps):
        np.add.at(g, (idx, _refl101(idx + t - r, n)), kt)
    return g.astype(np.float32)


@functools.lru_cache(maxsize=None)
def filter2d_svd_terms(kernel_bytes: bytes, kh: int, kw: int) -> tuple:
    """Separable decomposition K = Σ_k u_k v_kᵀ (float64 SVD; terms with
    σ ≤ σ₀·1e-9 dropped: the disk kernels are exactly low-rank, radius 6 is
    rank 5 of 17)."""
    k = np.frombuffer(kernel_bytes, np.float64).reshape(kh, kw)
    u, s, vt = np.linalg.svd(k)
    keep = np.nonzero(s > (s[0] * 1e-9 if s[0] > 0 else 0))[0]
    return tuple(((u[:, i] * s[i]).tobytes(), vt[i].tobytes()) for i in keep)


def filter2d_same(x: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """2-D correlation of (..., H, W, C) per channel with cv2's reflect-101
    border (cv2.filter2D): Σ over the kernel's SVD terms of a banded
    H-product and a banded W-product, the JAX package's form at 16 px and
    up, used here at every size."""
    h, w = x.shape[-3], x.shape[-2]
    terms = filter2d_svd_terms(kernel.astype(np.float64).tobytes(), *kernel.shape)
    out = None
    for ub, vb in terms:
        gh = on_device(x.device, reflect101_matrix, h, ub)
        gw = on_device(x.device, reflect101_matrix, w, vb)
        y = matmul_w(gw, matmul_h(gh, x))
        out = y if out is None else out + y
    return torch.zeros_like(x) if out is None else out.to(x.dtype)


# ---------------------------------------------------------------------------
# motion blur taps (ImageMagick MotionBlurImage)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def motion_blur_offsets(radius: float, sigma: float, angle_deg: float):
    """ImageMagick MotionBlurImage kernel: gaussian-weighted taps marching
    along a line at ``angle``; width per GetOptimalKernelWidth1D, taps at
    integer steps (i·cos, i·sin). Returns (dx, dy, w)."""
    if sigma <= 0:
        width = int(2 * math.ceil(radius) + 1)
    else:
        alpha = 1.0 / (2.0 * sigma * sigma)
        beta = 1.0 / (math.sqrt(2 * math.pi) * sigma)
        width = 5
        while True:
            value = beta * math.exp(-alpha * ((width - 1) / 2.0) ** 2)
            if value < 1e-6:  # MagickEpsilon-scale cutoff
                break
            width += 2
            if width > 255:
                break
    n = (width + 1) // 2 if radius <= 0 else int(radius) + 1
    n = max(n, 3)
    i = np.arange(n, dtype=np.float64)
    if sigma > 0:
        w = np.exp(-0.5 * (i / sigma) ** 2)
    else:
        w = np.ones_like(i)
    w /= w.sum()
    theta = math.radians(angle_deg)
    dx = np.round(i * math.cos(theta)).astype(np.int32)
    dy = np.round(i * math.sin(theta)).astype(np.int32)
    return dx, dy, w.astype(np.float32)


def motion_blur(x: torch.Tensor, radius: float, sigma: float, angle_deg: float) -> torch.Tensor:
    """Directional blur of (..., H, W, C) at one angle, edge-clamped: the
    direct per-angle tap sum, f32 in tap order. The oracle of the motion-tap
    kernel (``robustart_torch.ops.motion``) in the tests."""
    dx, dy, w = motion_blur_offsets(float(radius), float(sigma), float(angle_deg))
    h, wd = x.shape[-3], x.shape[-2]
    rows = torch.arange(h, device=x.device)
    cols = torch.arange(wd, device=x.device)
    out = torch.zeros_like(x)
    for ddx, ddy, wv in zip(dx, dy, w):
        shifted = x.index_select(-3, (rows + int(ddy)).clamp(0, h - 1))
        shifted = shifted.index_select(-2, (cols + int(ddx)).clamp(0, wd - 1))
        out = out + float(wv) * shifted
    return out


def rgb_to_gray(x: torch.Tensor) -> torch.Tensor:
    """cv2.cvtColor RGB2GRAY weights (snow, reference corruptions.py:308):
    (..., 3) → (...), summed in channel order."""
    return x[..., 0] * 0.299 + x[..., 1] * 0.587 + x[..., 2] * 0.114


# ---------------------------------------------------------------------------
# colour space (skimage rgb2hsv / hsv2rgb formulas)
# ---------------------------------------------------------------------------


def rgb_to_hsv(x: torch.Tensor) -> torch.Tensor:
    """(..., 3) RGB in [0, 1] → (..., 3) HSV, each in [0, 1]. The hue's
    ``% 1`` is Python's (negative hues wrap up), as ``jnp``'s, and its ``/ 6``
    is :func:`div_const`: on uint8 images many outputs of :func:`hsv_to_rgb`
    land exactly on a level, where an ulp of hue moves the later floor."""
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    delta = maxc - minc
    s = torch.where(maxc > 0, delta / torch.clamp_min(maxc, 1e-12), 0.0)
    safe = torch.clamp_min(delta, 1e-12)
    rc = (maxc - r) / safe
    gc = (maxc - g) / safe
    bc = (maxc - b) / safe
    h = torch.where(r == maxc, bc - gc,
                    torch.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(delta == 0, 0.0, torch.remainder(div_const(h, 6.0), 1.0))
    return torch.stack([h, s, maxc], dim=-1)


def hsv_to_rgb(x: torch.Tensor) -> torch.Tensor:
    """(..., 3) HSV → (..., 3) RGB, the six sectors of skimage's hsv2rgb;
    ``1 − s·f`` and ``1 − s·(1 − f)`` each rounded once (:func:`fma`), as
    the JAX package's program computes them."""
    h, s, v = x[..., 0], x[..., 1], x[..., 2]
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * fma(-s, f, 1.0)
    t = v * fma(-s, 1.0 - f, 1.0)
    i = i.to(torch.int32) % 6

    def sector(*vals):
        out = vals[5]
        for k in range(4, -1, -1):
            out = torch.where(i == k, vals[k], out)
        return out

    return torch.stack([sector(v, q, p, p, t, v), sector(t, v, v, q, p, p),
                        sector(p, p, t, v, v, q)], dim=-1)


# ---------------------------------------------------------------------------
# PIL resampling matrices (Pillow Resample.c)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def pil_box_matrix(in_size: int, out_size: int) -> np.ndarray:
    """Dense (out_size, in_size) 1-D resampling matrix of PIL's box filter:
    output i's centre (i + 0.5)·scale, taps at the input pixels' centres
    j + 0.5 in (-0.5, 0.5]·max(scale, 1) of it, weights normalized; built
    in float64, returned in float32."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    sup = 0.5 * filterscale
    w = np.zeros((out_size, in_size), dtype=np.float64)
    for i in range(out_size):
        center = (i + 0.5) * scale
        jmin = max(int(center - sup + 0.5), 0)
        jmax = min(int(center + sup + 0.5), in_size)
        d = (np.arange(jmin, jmax, dtype=np.float64) + 0.5 - center) / filterscale
        vals = ((d > -0.5) & (d <= 0.5)).astype(np.float64)
        total = vals.sum()
        if total != 0:
            vals /= total
        w[i, jmin:jmax] = vals
    return w.astype(np.float32)
