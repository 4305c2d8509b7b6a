"""Motion taps, glass shuffle and chamfer propagation (kernels K3, K4, K5).

Counterpart of ``robustart_tpu/ops/pallas_motion.py``:

- K3 :func:`motion_taps` replaces ``motion_taps_pallas`` (``pl.pallas_call``
  at :114): per image, a weighted sum of edge-clamped shifted copies, with
  the tap rows picked from the (angles, T) table of :func:`angle_tap_table`
  by :func:`motion_blur_bank`. motion_blur runs it at C = 3 and snow's layer
  at C = 1. Source ``csrc/motion_taps.cu``.
- K4 :func:`glass_shuffle` replaces ``glass_shuffle_pallas`` (:219): one
  glass_blur pass, each interior pixel taking the neighbour its code names.
  Source ``csrc/glass_shuffle.cu``.
- K5 :func:`chamfer` replaces ``chamfer_pallas`` (:278): capped chamfer
  distance propagation, spatter's water branch. Source ``csrc/chamfer.cu``;
  :func:`chamfer_plan` says how a shape runs.

Each wrapper takes a whole batch in one launch (K5: one a call where a map
fits a cluster's shared memory, else one a round) and counts its launches
in ``<wrapper>.launches``. It takes its plain
PyTorch version (``*_reference``) only for tensors on the CPU; a CUDA tensor
launches the kernel or raises.

Tap order: the JAX package's CPU path for ``motion_blur_bank`` sums the
union of all angles' taps in sorted-offset order (``ops/image.py`` :549-565);
K3 and its plain version sum each angle's own taps in kernel order, as the
TPU kernel does. The two agree to about 2e-7.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from robustart_torch.ops import build
from robustart_torch.ops.image import motion_blur_offsets, on_device

# the 5x5 chamfer mask's weights (the kernel takes them from the host, as
# float32 values) and its (dy, dx, weight) offsets in the order of
# jax_kernels._CHAMFER_OFFSETS
CHAMFER_WEIGHTS = (1.0, math.sqrt(2.0), math.sqrt(5.0))
CHAMFER_OFFSETS = tuple(
    (dy, dx, w)
    for w, pairs in zip(CHAMFER_WEIGHTS, (
        ((0, 1), (0, -1), (1, 0), (-1, 0)),
        ((1, 1), (1, -1), (-1, 1), (-1, -1)),
        ((1, 2), (1, -2), (-1, 2), (-1, -2), (2, 1), (2, -1), (-2, 1), (-2, -1)),
    ))
    for dy, dx in pairs
)
MAX_TAPS = 64  # csrc/motion_taps.cu: kMaxTaps

_P = ctypes.c_void_p
_I = ctypes.c_int


def _check_batch(x: torch.Tensor, ndim: int, what: str) -> None:
    if x.ndim != ndim:
        raise ValueError(f"{what} must have {ndim} dims, got {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"{what} must be float32, not {x.dtype}")
    if x.device.type == "cuda" and x.shape[0] > 65535:
        raise ValueError(f"batch {x.shape[0]} exceeds the kernel's grid limit 65535")


# ---------------------------------------------------------------------------
# K3: motion taps
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _motion_launcher():
    return build.bind("motion_taps", "motion_taps_launch",
                      [_P] * 5 + [ctypes.c_longlong] + [_I] * 4 + [_P])


def _check_taps(img, dy, dx, wt) -> None:
    _check_batch(img, 4, "img")
    if img.shape[-1] not in (1, 3):
        raise ValueError(f"motion taps take C in (1, 3), got {img.shape[-1]}")
    b = img.shape[0]
    if dy.ndim != 2 or dy.shape[0] != b or dy.shape != dx.shape or dy.shape != wt.shape:
        raise ValueError(f"tap rows must be (B={b}, T) alike, got {tuple(dy.shape)}, "
                         f"{tuple(dx.shape)}, {tuple(wt.shape)}")
    if dy.shape[1] > MAX_TAPS:
        raise ValueError(f"{dy.shape[1]} taps exceed the kernel's {MAX_TAPS}")
    if dy.dtype != torch.int32 or dx.dtype != torch.int32 or wt.dtype != torch.float32:
        raise TypeError("dy, dx must be int32 and wt float32")


def motion_taps(img: torch.Tensor, dy: torch.Tensor, dx: torch.Tensor,
                wt: torch.Tensor) -> torch.Tensor:
    """Σ_t wt[b, t] · img[b, clamp(i + dy[b, t]), clamp(j + dx[b, t])] for
    ``img`` (B, H, W, C) f32 with C in {1, 3} and tap rows (B, T): int32
    dy, dx and f32 wt. CUDA tensors run K3 (counted in
    ``motion_taps.launches``); CPU tensors run the plain version."""
    _check_taps(img, dy, dx, wt)
    if img.device.type == "cpu":
        return motion_taps_reference(img, dy, dx, wt)
    build.check_cuda_tensor(img, "img", torch.float32)
    build.check_cuda_tensor(dy, "dy", torch.int32)
    build.check_cuda_tensor(dx, "dx", torch.int32)
    build.check_cuda_tensor(wt, "wt", torch.float32)
    b, h, w, c = img.shape
    out = torch.empty_like(img)
    if out.numel() == 0:
        return out
    build.launch(_motion_launcher(), img.device, img.data_ptr(), dy.data_ptr(),
                 dx.data_ptr(), wt.data_ptr(), out.data_ptr(), b, h, w, c, dy.shape[1])
    motion_taps.launches += 1
    return out


motion_taps.launches = 0


def motion_taps_reference(img: torch.Tensor, dy: torch.Tensor, dx: torch.Tensor,
                          wt: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`motion_taps`: the same sum from 0 in
    tap order, one rounding per multiply and per add."""
    _check_taps(img, dy, dx, wt)
    b, h, w, c = img.shape
    rows = torch.arange(h, device=img.device).view(1, h, 1)
    cols = torch.arange(w, device=img.device).view(1, 1, w)
    flat = img.reshape(b, h * w, c)
    out = torch.zeros_like(img)
    for t in range(dy.shape[1]):
        yy = (rows + dy[:, t].view(b, 1, 1)).clamp(0, h - 1)
        xx = (cols + dx[:, t].view(b, 1, 1)).clamp(0, w - 1)
        idx = (yy * w + xx).reshape(b, h * w, 1).expand(b, h * w, c)
        tap = torch.gather(flat, 1, idx).reshape(b, h, w, c)
        out = out + wt[:, t].view(b, 1, 1, 1) * tap
    return out


@functools.lru_cache(maxsize=None)
def angle_tap_table(radius: float, sigma: float, angles: tuple):
    """(A, T) dy/dx/weight tables, one row per bank angle, zero-padded to
    the most taps; plus the (py, px) reach of the offsets."""
    rows = [motion_blur_offsets(radius, sigma, a) for a in angles]
    t_max = max(len(w) for _, _, w in rows)
    a = len(angles)
    dy = np.zeros((a, t_max), np.int32)
    dx = np.zeros((a, t_max), np.int32)
    wt = np.zeros((a, t_max), np.float32)
    for i, (dx_r, dy_r, w_r) in enumerate(rows):
        dy[i, :len(w_r)] = dy_r
        dx[i, :len(w_r)] = dx_r
        wt[i, :len(w_r)] = w_r
    return dy, dx, wt, int(np.abs(dy).max()), int(np.abs(dx).max())


def _table(i: int, radius: float, sigma: float, angles: tuple) -> np.ndarray:
    return angle_tap_table(radius, sigma, angles)[i]


def tap_rows(idx: torch.Tensor, radius: float, sigma: float, angles: tuple):
    """(dy, dx, wt) tap rows (B, T) of bank angles ``idx`` (B,), picked from
    the angle table on ``idx``'s device."""
    key = (float(radius), float(sigma), tuple(float(a) for a in angles))
    idx = idx.to(torch.int64)
    return tuple(on_device(idx.device, _table, i, *key)[idx] for i in range(3))


def motion_blur_bank(x: torch.Tensor, idx: torch.Tensor, radius: float,
                     sigma: float, angles: tuple) -> torch.Tensor:
    """Motion blur of each image of ``x`` (B, H, W, C) at bank angle
    ``idx[b]`` (int, (B,)): the tap rows are picked from the angle table on
    the device, then one K3 call blurs the batch."""
    return motion_taps(x, *tap_rows(idx.to(x.device), radius, sigma, angles))


# ---------------------------------------------------------------------------
# K4: glass shuffle
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _glass_launcher():
    return build.bind("glass_shuffle", "glass_shuffle_launch",
                      [_P] * 3 + [ctypes.c_longlong] + [_I] * 4 + [_P])


def _check_glass(x, code, d) -> None:
    _check_batch(x, 4, "x")
    if code.shape != x.shape[:3] or code.dtype != torch.uint8:
        raise ValueError(f"code must be uint8 {tuple(x.shape[:3])}, got "
                         f"{code.dtype} {tuple(code.shape)}")
    if not 1 <= int(d) <= 8:
        raise ValueError(f"d must be in [1, 8] (a code is one byte), got {d}")


def glass_shuffle(x: torch.Tensor, code: torch.Tensor, d: int) -> torch.Tensor:
    """One glass_blur pass over ``x`` (B, H, W, C) f32: each interior pixel
    (``d < i < H-d``, ``d < j < W-d``) takes ``x[i+a, j+b]``, with
    ``code = (a+d)·2d + (b+d)`` (uint8, (B, H, W)), a and b in [-d, d);
    other pixels keep x. CUDA tensors run K4 (counted in
    ``glass_shuffle.launches``); CPU tensors run the plain version."""
    _check_glass(x, code, d)
    if x.device.type == "cpu":
        return glass_shuffle_reference(x, code, d)
    build.check_cuda_tensor(x, "x", torch.float32)
    build.check_cuda_tensor(code, "code", torch.uint8)
    b, h, w, c = x.shape
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    build.launch(_glass_launcher(), x.device, x.data_ptr(), code.data_ptr(),
                 out.data_ptr(), b, h, w, c, int(d))
    glass_shuffle.launches += 1
    return out


glass_shuffle.launches = 0


def glass_shuffle_reference(x: torch.Tensor, code: torch.Tensor, d: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`glass_shuffle` (a gather; exact)."""
    _check_glass(x, code, d)
    b, h, w, c = x.shape
    rows = torch.arange(h, device=x.device).view(1, h, 1)
    cols = torch.arange(w, device=x.device).view(1, 1, w)
    k = code.to(torch.int64)
    interior = (rows > d) & (rows < h - d) & (cols > d) & (cols < w - d)
    si = torch.where(interior, (rows + k // (2 * d) - d).clamp(0, h - 1), rows)
    sj = torch.where(interior, (cols + k % (2 * d) - d).clamp(0, w - 1), cols)
    idx = (si * w + sj).reshape(b, h * w, 1).expand(b, h * w, c)
    return torch.gather(x.reshape(b, h * w, c), 1, idx).reshape(b, h, w, c)


# ---------------------------------------------------------------------------
# K5: chamfer distance propagation
# ---------------------------------------------------------------------------


# the cluster route's arithmetic (csrc/chamfer.cu): output rows a thread
# computes a round, its most threads a block, buffer columns left of the
# image, a block's most dynamic shared memory, the cluster sizes it tries
CHAMFER_STRIP = 14
CHAMFER_THREADS = 512
CHAMFER_PAD = 4
CHAMFER_SMEM = 232_448
CHAMFER_CLUSTERS = (1, 2, 4, 8)


def chamfer_plan(b: int, h: int, w: int, iters: int) -> dict:
    """How :func:`chamfer` runs maps (B, H, W) for ``iters`` rounds on the
    card (``csrc/chamfer.cu``), chosen by shape.

    ``"cluster"``, one launch a call: the least cluster size n of
    :data:`CHAMFER_CLUSTERS` whose ``band`` of ceil(H / n) rows (at least 2
    where n > 1), with 2 halo rows above and below, fits two f32 buffers of
    ``wp`` = 4·ceil(W / 4) + 8 columns in a block's shared memory
    (``smem`` bytes, 16 of them the two mbarriers); ``groups`` of 4 columns
    × ``strips`` of :data:`CHAMFER_STRIP` rows are a band's work items, on
    ``threads`` (at most :data:`CHAMFER_THREADS`); ``grid`` (n, B).
    ``"rounds"``, ``iters`` launches of a thread a pixel, for maps whose band
    fits no cluster of 8 (about 465² and above). ``launches`` is what a call
    issues. Raises for what neither takes."""
    if b <= 0 or h <= 0 or w <= 0:
        raise ValueError(f"B, H and W must be positive, got {b}, {h}, {w}")
    if b > 65535:
        raise ValueError(f"batch {b} exceeds the kernel's grid limit 65535")
    if int(iters) < 1:
        raise ValueError(f"iters must be at least 1, got {iters}")
    groups = -(-w // 4)
    wp = CHAMFER_PAD + 4 * groups + 4
    for n in CHAMFER_CLUSTERS:
        band = -(-h // n)
        smem = 2 * (band + 4) * wp * 4 + 16
        if smem <= CHAMFER_SMEM and (n == 1 or band >= 2):
            break
    else:
        return {"route": "rounds", "launches": int(iters), "threads": 256,
                "grid": (-(-h * w // 256), b)}
    strips = -(-band // CHAMFER_STRIP)
    threads = min(CHAMFER_THREADS, -(-groups * strips // 32) * 32)
    return {"route": "cluster", "launches": 1, "cluster": n, "band": band, "wp": wp,
            "groups": groups, "strips": strips, "threads": threads, "smem": smem,
            "grid": (n, b)}


@functools.lru_cache(maxsize=None)
def _chamfer_round_launcher():
    return build.bind("chamfer", "chamfer_round_launch",
                      [_P, _P, ctypes.c_longlong] + [_I] * 2 + [ctypes.c_float] * 4 + [_P])


@functools.lru_cache(maxsize=None)
def _chamfer_cluster_launcher():
    return build.bind("chamfer", "chamfer_cluster_launch",
                      [_P, _P, ctypes.c_longlong] + [_I] * 2 + [ctypes.c_float] * 4
                      + [_I] * 8 + [_P])


def chamfer(dist0: torch.Tensor, cap: float, iters: int) -> torch.Tensor:
    """``iters`` rounds of capped chamfer min-propagation over maps
    ``dist0`` (B, H, W) f32 (5x5 mask, weights 1, √2, √5; a neighbour
    outside the image counts as ``cap``). CUDA tensors run K5 by
    :func:`chamfer_plan`'s route: one launch a call (a cluster holds each
    map in shared memory for all rounds), or one a round for maps too large
    for that; each launch is counted in ``chamfer.launches`` as it is
    issued. CPU tensors run the plain version."""
    _check_batch(dist0, 3, "dist0")
    if int(iters) < 1:
        raise ValueError(f"iters must be at least 1, got {iters}")
    if dist0.device.type == "cpu":
        return chamfer_reference(dist0, cap, iters)
    build.check_cuda_tensor(dist0, "dist0", torch.float32)
    out = torch.empty_like(dist0)
    if dist0.numel() == 0:
        return out
    b, h, w = dist0.shape
    plan = chamfer_plan(b, h, w, int(iters))
    if plan["route"] == "cluster":
        build.launch(_chamfer_cluster_launcher(), dist0.device, dist0.data_ptr(), out.data_ptr(),
                     b, h, w, float(cap), *CHAMFER_WEIGHTS, int(iters), plan["cluster"],
                     plan["band"], plan["wp"], plan["groups"], plan["strips"], plan["threads"],
                     plan["smem"])
        chamfer.launches += 1
        return out
    # the rounds alternate between out and a scratch map, the last writing out
    maps = (out, torch.empty_like(dist0))
    src = dist0
    for r in range(int(iters)):
        dst = maps[(int(iters) - 1 - r) % 2]
        build.launch(_chamfer_round_launcher(), dist0.device, src.data_ptr(), dst.data_ptr(), b,
                     h, w, float(cap), *CHAMFER_WEIGHTS)
        chamfer.launches += 1
        src = dst
    return out


chamfer.launches = 0


def chamfer_reference(dist0: torch.Tensor, cap: float, iters: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`chamfer`, as ``jax_kernels.
    _chamfer_distance`` writes it: the map padded with ``cap``, so an
    outside neighbour offers ``cap + w``, which the final ``min(·, cap)``
    makes the kernel's ``cap``. min is exact, so the two agree bitwise."""
    _check_batch(dist0, 3, "dist0")
    b, h, w = dist0.shape
    dist = dist0
    for _ in range(int(iters)):
        p = F.pad(dist, (2, 2, 2, 2), value=float(cap))
        best = dist
        for dy, dx, wt in CHAMFER_OFFSETS:
            shifted = p[:, 2 + dy:2 + dy + h, 2 + dx:2 + dx + w]
            best = torch.minimum(best, shifted + float(np.float32(wt)))
        dist = torch.clamp_max(best, float(cap))
    return dist
