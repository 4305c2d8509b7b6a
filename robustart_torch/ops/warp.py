"""Bilinear warp with scipy's 'reflect' border (kernel K2).

Counterpart of ``robustart_tpu/ops/pallas_warp.py::warp_banded_pallas`` (the
Pallas TPU kernel, ``pl.pallas_call`` at :172) and of the gather form of
``robustart_tpu/ops/image.py::map_coordinates_bilinear_reflect`` (:615-638),
which elastic_transform runs twice per image. The hand-written CUDA kernel
is ``csrc/warp_bilinear.cu``; :func:`warp_bilinear_reference` is its plain
PyTorch version, the gather form step by step.

The wrapper takes the plain version only for tensors on the CPU (the tests);
a CUDA tensor launches the kernel or raises. The kernel takes no band: it
reflects any overhang (period 2n), so it serves every severity, where the
TPU kernel served only those with a static band and a symmetric pad.
:func:`warp_plan` is how a call runs on the card: one launch, a thread a
pixel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from robustart_torch.ops import build


def _check(img, cy, cx) -> None:
    if img.ndim != 4:
        raise ValueError(f"img must be (B, H, W, C), got {tuple(img.shape)}")
    if cy.shape != img.shape[:3] or cx.shape != img.shape[:3]:
        raise ValueError(f"coords must be {tuple(img.shape[:3])}, got "
                         f"{tuple(cy.shape)} and {tuple(cx.shape)}")
    for t, what in ((img, "img"), (cy, "coords_y"), (cx, "coords_x")):
        if t.dtype != torch.float32:
            raise TypeError(f"{what} must be float32, not {t.dtype}")


# the kernel's block, and the pixels each of its threads samples (the
# defaults of csrc/warp_bilinear.cu's kThreads and WARP_PIXELS)
WARP_THREADS = 256
WARP_PIXELS = 3


def warp_plan(b: int, h: int, w: int, c: int) -> dict:
    """How :func:`warp_bilinear` runs an image batch (B, H, W, C) on the
    card (``csrc/warp_bilinear.cu``): one launch of ``grid`` = (blocks an
    image, B) blocks of ``threads``, block x of image n taking its
    ``threads`` · ``pixels`` pixels from x · that on in row-major order,
    ``pixels`` a thread, ``threads`` apart. Raises for what the kernel does
    not take."""
    if b <= 0 or h <= 0 or w <= 0 or c <= 0:
        raise ValueError(f"B, H, W and C must be positive, got {b}, {h}, {w}, {c}")
    if b > 65535:
        raise ValueError(f"batch {b} exceeds the kernel's grid limit 65535")
    per_block = WARP_THREADS * WARP_PIXELS
    return {"launches": 1, "threads": WARP_THREADS, "pixels": WARP_PIXELS,
            "grid": (-(-h * w // per_block), b)}


@functools.lru_cache(maxsize=None)
def _launcher():
    p = ctypes.c_void_p
    return build.bind("warp_bilinear", "warp_bilinear_launch",
                      [p, p, p, p, ctypes.c_longlong] + [ctypes.c_int] * 3 + [p])


def warp_bilinear(img: torch.Tensor, coords_y: torch.Tensor,
                  coords_x: torch.Tensor) -> torch.Tensor:
    """Sample each image of ``img`` (B, H, W, C) f32 at ``(coords_y,
    coords_x)`` (B, H, W) f32, bilinearly, scipy 'reflect' outside the
    image: ``scipy.ndimage.map_coordinates(order=1, mode='reflect')`` per
    image and channel. CUDA tensors run the kernel by :func:`warp_plan`
    (one launch a call, counted in ``warp_bilinear.launches``); CPU tensors
    run the plain version."""
    _check(img, coords_y, coords_x)
    if img.device.type == "cpu":
        return warp_bilinear_reference(img, coords_y, coords_x)
    for t, what in ((img, "img"), (coords_y, "coords_y"), (coords_x, "coords_x")):
        build.check_cuda_tensor(t, what, torch.float32)
    out = torch.empty_like(img)
    if out.numel() == 0:
        return out
    b, h, w, c = img.shape
    warp_plan(b, h, w, c)  # raises for what the kernel does not take
    build.launch(_launcher(), img.device, img.data_ptr(), coords_y.data_ptr(),
                 coords_x.data_ptr(), out.data_ptr(), b, h, w, c)
    warp_bilinear.launches += 1
    return out


warp_bilinear.launches = 0


def _reflect(idx: torch.Tensor, n: int) -> torch.Tensor:
    """scipy 'reflect' (d c b a | a b c d | d c b a), period 2n."""
    idx = torch.remainder(idx, 2 * n)
    return torch.where(idx >= n, 2 * n - 1 - idx, idx)


def warp_bilinear_reference(img: torch.Tensor, coords_y: torch.Tensor,
                            coords_x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`warp_bilinear`: the gather form of
    the JAX package, one rounding per step in its order."""
    _check(img, coords_y, coords_x)
    b, h, w, c = img.shape
    y0 = torch.floor(coords_y)
    x0 = torch.floor(coords_x)
    fy = (coords_y - y0)[..., None]
    fx = (coords_x - x0)[..., None]
    y0i, x0i = y0.to(torch.int64), x0.to(torch.int64)
    flat = img.reshape(b, h * w, c)

    def at(yy, xx):
        idx = (_reflect(yy, h) * w + _reflect(xx, w)).reshape(b, h * w, 1)
        return torch.gather(flat, 1, idx.expand(b, h * w, c)).reshape(b, h, w, c)

    top = at(y0i, x0i) * (1 - fx) + at(y0i, x0i + 1) * fx
    bot = at(y0i + 1, x0i) * (1 - fx) + at(y0i + 1, x0i + 1) * fx
    return top * (1 - fy) + bot * fy
