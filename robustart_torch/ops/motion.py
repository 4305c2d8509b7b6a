"""Motion taps, glass shuffle and chamfer propagation (kernels K3, K4, K5).

Counterpart of ``robustart_tpu/ops/pallas_motion.py``:

- K3 :func:`motion_taps` replaces ``motion_taps_pallas`` (``pl.pallas_call``
  at :114): per image, a weighted sum of edge-clamped shifted copies, with
  the tap rows picked from the (angles, T) table of :func:`angle_tap_table`
  by :func:`motion_blur_bank`. motion_blur runs it at C = 3 and snow's layer
  at C = 1. Source ``csrc/motion_taps.cu``; :func:`motion_plan` says how a
  shape runs.
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
# K3's grid (csrc/motion_taps.cu): persistent blocks of MOTION_THREADS walk
# runs of MOTION_TILE (rows, columns) output tiles; a tile's source box takes
# at most MOTION_BOX_BYTES of shared memory (two a block), else its image
# gathers. A block holds the boxes and MOTION_BLOCK_BYTES more (its static
# arrays and the 1 KB the runtime keeps), of an SM's MOTION_SM_BYTES; ptxas
# leaves registers for MOTION_MIN_BLOCKS[C] blocks an SM.
MOTION_THREADS = 256
MOTION_TILE = (32, 32)
MOTION_BOX_BYTES = 32 * 1024
MOTION_BLOCK_BYTES = 2176 + 1024
MOTION_SM_BYTES = 233_472
MOTION_MIN_BLOCKS = {1: 6, 3: 4}

_P = ctypes.c_void_p
_I = ctypes.c_int


def _check_batch(x: torch.Tensor, ndim: int, what: str, grid_y: bool = True) -> None:
    if x.ndim != ndim:
        raise ValueError(f"{what} must have {ndim} dims, got {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"{what} must be float32, not {x.dtype}")
    if grid_y and x.device.type == "cuda" and x.shape[0] > 65535:
        raise ValueError(f"batch {x.shape[0]} exceeds the kernel's grid limit 65535")


# ---------------------------------------------------------------------------
# K3: motion taps
# ---------------------------------------------------------------------------


def motion_plan(b: int, h: int, w: int, c: int, reach: tuple | None = None,
                sms: int = 132) -> dict:
    """How :func:`motion_taps` runs a batch (B, H, W, C) on the card
    (``csrc/motion_taps.cu``): one launch of ``grid`` = (blocks,) persistent
    blocks of ``threads``, block k walking tiles [k · total // blocks,
    (k + 1) · total // blocks) of the ``total`` = B · tiles output tiles of
    ``tile`` size, in order (image, tile row, tile column; ``tiles`` =
    (rows, columns) an image); a thread computes ``pixels`` of one column, 8
    rows apart. A tile's source box (the full tile widened by the span of
    its image's dy and dx, channel-interleaved) is filled in shared memory
    where it fits ``box_bytes``, else the image's tiles gather from global
    memory; its rows are padded to 16 bytes, the copy engine's unit.
    ``box_bytes`` is :data:`MOTION_BOX_BYTES`, or less where ``reach`` =
    (span of dy, span of dx), each the largest max − min over any tap row
    (:func:`tap_spans`), says every box is smaller; then ``map`` = (rows,
    pitch in floats) is one box that holds every image's, in which a tile
    inside the image comes by one tensor copy ((0, 0): none). A block holds
    two boxes; ``blocks`` is what ``sms`` SMs hold at once
    (``per_sm``, by registers, threads and shared memory), at most
    ``total``. Raises for what the kernel does not take."""
    if b <= 0 or h <= 0 or w <= 0:
        raise ValueError(f"B, H and W must be positive, got {b}, {h}, {w}")
    if c not in (1, 3):
        raise ValueError(f"motion taps take C in (1, 3), got {c}")
    if h > 2**29 or w > 2**29:
        raise ValueError(f"H {h} or W {w} exceeds the kernel's 2^29")
    th, tw = MOTION_TILE
    tiles = (-(-h // th), -(-w // tw))
    total = b * tiles[0] * tiles[1]
    if total >= 2**31:
        raise ValueError(f"{total} tiles exceed the kernel's 2^31 - 1")
    box, rows, pitch = MOTION_BOX_BYTES, 0, 0
    if reach is not None:
        # a box row: (columns) · C floats after a shift of up to 3, padded
        # to 16 bytes; a box on 128 bytes, the tensor copy's alignment
        sy, sx = (min(int(s), 2 * n) for s, n in zip(reach, (h, w)))
        rows, pitch = th + sy, ((tw + sx) * c + 6) // 4 * 4
        need = -(-rows * pitch * 4 // 128) * 128
        if need <= MOTION_BOX_BYTES and max(rows, pitch) <= 256:
            box = need
        else:
            rows = pitch = 0
    per_sm = min(MOTION_MIN_BLOCKS[c], 2048 // MOTION_THREADS,
                 MOTION_SM_BYTES // (2 * box + MOTION_BLOCK_BYTES))
    return {"launches": 1, "threads": MOTION_THREADS, "tile": MOTION_TILE, "tiles": tiles,
            "total": total, "pixels": th * tw // MOTION_THREADS, "per_sm": per_sm,
            "grid": (min(total, sms * per_sm),), "box_bytes": box, "map": (rows, pitch)}


def tile_box(dy: torch.Tensor, dx: torch.Tensor, tile: tuple, h: int, w: int) -> tuple:
    """The source box of the output tile at ``tile`` = (r0, c0) for one tap
    row (dy, dx (T,) int): (y0, x0, rows, columns) in unclamped
    coordinates, as the kernel forms it (offsets clamped to [-H, H] ×
    [-W, W] first; a partial tile's box is a full tile's)."""
    r0, c0 = tile
    th, tw = MOTION_TILE
    if dy.numel() == 0:
        return r0, c0, th, tw
    y, x = dy.to(torch.int64).clamp(-h, h), dx.to(torch.int64).clamp(-w, w)
    lo_y, lo_x = int(y.min()), int(x.min())
    return (r0 + lo_y, c0 + lo_x, th + int(y.max()) - lo_y, tw + int(x.max()) - lo_x)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _motion_launcher():
    return build.bind("motion_taps", "motion_taps_launch",
                      [_P] * 5 + [ctypes.c_longlong] + [_I] * 8 + [_P])


def _check_taps(img, dy, dx, wt) -> None:
    _check_batch(img, 4, "img", grid_y=False)
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
                wt: torch.Tensor, reach: tuple | None = None) -> torch.Tensor:
    """Σ_t wt[b, t] · img[b, clamp(i + dy[b, t]), clamp(j + dx[b, t])] for
    ``img`` (B, H, W, C) f32 with C in {1, 3} and tap rows (B, T): int32
    dy, dx and f32 wt. CUDA tensors run K3 by :func:`motion_plan` (one
    launch a call, counted in ``motion_taps.launches``; ``reach``, the rows'
    spans, only sizes the box budget and the tensor copy's box: an image
    whose box exceeds them gathers or copies by rows); CPU tensors run the
    plain version."""
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
    plan = motion_plan(b, h, w, c, reach, _sms(img.device.index or 0))
    build.launch(_motion_launcher(), img.device, img.data_ptr(), dy.data_ptr(),
                 dx.data_ptr(), wt.data_ptr(), out.data_ptr(), b, h, w, c, dy.shape[1],
                 plan["box_bytes"], plan["grid"][0], *plan["map"])
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


@functools.lru_cache(maxsize=None)
def tap_spans(radius: float, sigma: float, angles: tuple) -> tuple[int, int]:
    """(span of dy, span of dx) of the angle table: the largest max − min
    of any row's offsets, the zero padding included (the ``reach`` of
    :func:`motion_plan`)."""
    dy, dx = angle_tap_table(radius, sigma, angles)[:2]
    return (int((dy.max(1) - dy.min(1)).max()), int((dx.max(1) - dx.min(1)).max()))


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
    key = (float(radius), float(sigma), tuple(float(a) for a in angles))
    return motion_taps(x, *tap_rows(idx.to(x.device), *key), reach=tap_spans(*key))


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
