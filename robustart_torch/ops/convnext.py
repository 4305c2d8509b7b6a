"""ConvNeXt's depthwise 7×7 convolution + LayerNorm (kernel K11).

Counterpart of ``robustart_tpu/ops/pallas_convnext.py::dwconv_ln_pallas``
(the Pallas TPU kernel, ``pl.pallas_call`` at :84):

    y = LN(dwconv7×7(x) + b)·gamma + beta        per pixel over C, eps 1e-6

on NHWC x in bf16 or f32 with f32 weights, the 49 taps accumulated in f32
with zero padding of 3, and the LN statistics taken in two passes (mean,
then the mean of (y − mean)²), as the Pallas kernel does (:57-75).
:func:`dwconv_ln_reference` is its plain PyTorch version, the kernel's steps
in its tap order; it is not the JAX package's XLA reference, which rounds
the convolution's output to x's type (:43-49).

The hand-written CUDA kernel is ``csrc/dwconv_ln.cu``; :func:`dwconv_plan`
is the arithmetic of one launch (band, column tiles, channel split, ring,
shared bytes, grid), testable on the CPU. The wrapper takes the plain
version only for tensors on the CPU; a CUDA tensor launches the kernel or
raises. The JAX package's ``ConvNeXtBlock`` resolves ``block_impl="auto"``
to its XLA form because of a TPU measurement (``models/convnext.py:88-95``);
the port's ``auto`` runs this kernel on CUDA tensors.

The weights are in the layout of ``nn.Conv2d(C, C, 7, groups=C)``:
(C, 1, 7, 7), the JAX package's (7, 7, 1, C) transposed. The kernel reads
that layout as it is; only the plain version transposes it (:func:`_taps`).
"""

from __future__ import annotations

import ctypes
import functools
import itertools

import torch

from robustart_torch.ops import build
from robustart_torch.ops.plain_grad import plain_grad

EPS = 1e-6
MAX_CHANNELS = 1024
# csrc/dwconv_ln.cu: a thread computes 2 rows × PATCH columns of two channels
PATCH = 7
PATCH_ROWS = 2
MAX_THREADS = 256
MAX_BAND = 28  # output rows a block, at most
SPLIT_ABOVE = 512  # channels beyond which a pixel's channels take two blocks of a cluster
SMEM_LIMIT = 232448  # bytes of shared memory a block may have on sm_90


def _taps(w: torch.Tensor) -> torch.Tensor:
    """(C, 1, 7, 7) → (49, C) f32: tap di·7 + dj, then channel."""
    if w.ndim != 4 or tuple(w.shape[1:]) != (1, 7, 7):
        raise ValueError(f"w must be (C, 1, 7, 7), got {tuple(w.shape)}")
    return w.reshape(w.shape[0], 49).t().float().contiguous()


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=256)
def dwconv_plan(n: int, h: int, w: int, c: int, dtype: torch.dtype) -> dict:
    """The arithmetic of one :func:`dwconv_ln` launch on the card
    (``csrc/dwconv_ln.cu``) for x (N, H, W, C) of ``dtype``:

    - ``cluster``: blocks that share a pixel's channels, 1 for C ≤ 512, else
      2 (the first takes ``c0`` channels, C/2 rounded up to 32, the second
      the rest); ``pairs`` = c0/2 channel pairs, one a thread, and
      ``lanes``, the 32 or 16 lanes whose pairs reduce a pixel together;
    - ``groups`` of :data:`PATCH` output columns a block (threads =
      groups · pairs ≤ :data:`MAX_THREADS`) and ``tiles`` of ``tile`` =
      groups · PATCH columns across W, each staged with 3 columns of halo
      on either side;
    - ``band``: output rows a block (even, at most :data:`MAX_BAND`), and
      ``bands`` down H;
    - ``ring``: input rows staged in shared memory, each in ``boxes`` TMA
      boxes of 256 bytes of channels by ``tile`` + 6 columns: 10 rows (the
      next patch's in flight) where they fit, else 8, and then the most
      column groups that fit; ``smem`` bytes (the ring and its mbarriers,
      the butterflies' partials, the pixel totals and the cluster peer's,
      128 bytes of alignment) and ``grid``, one block per (image, band,
      tile, cluster rank).

    Raises for what the kernel does not take: an empty axis, C not a
    multiple of 32 up to :data:`MAX_CHANNELS`, another type than bf16 or
    f32, or more than 2³¹ − 1 blocks. One dict per argument set, cached
    (every forward asks again): callers read it."""
    if n <= 0 or h <= 0 or w <= 0:
        raise ValueError(f"N, H and W must be positive, got {n}, {h}, {w}")
    if c <= 0 or c % 32 or c > MAX_CHANNELS:
        raise ValueError(f"the kernel takes C a multiple of 32 up to {MAX_CHANNELS}, got {c}")
    if dtype not in build.DTYPE_CODE:
        raise TypeError(f"x must be bfloat16 or float32, not {dtype}")
    cluster = 1 if c <= SPLIT_ABOVE else 2
    c0 = c if cluster == 1 else _cdiv(c, 64) * 32
    pairs = c0 // 2
    lanes = 32 if pairs % 32 == 0 else 16
    band = _cdiv(_cdiv(h, _cdiv(h, MAX_BAND)), PATCH_ROWS) * PATCH_ROWS
    bands = _cdiv(h, band)
    size = 2 if dtype == torch.bfloat16 else 4
    boxes = _cdiv(c0 * size, 256)
    # a ring of 10 rows where one fits, then the most column groups
    for ring, groups in itertools.product(
            (10, 8), range(max(1, min(MAX_THREADS // pairs, _cdiv(w, PATCH))), 0, -1)):
        threads = groups * pairs
        smem = (128 + ring * (boxes * (groups * PATCH + 6) * 256 + 8) + 16
                + 4 * 2 * (groups * 16 * (pairs // lanes) + threads // lanes * 16 + groups * 16))
        if smem <= SMEM_LIMIT:
            break
    else:  # unreachable for C ≤ 1024: the 8-row f32 ring of 512 channels is 213 KB
        raise ValueError(f"no ring of input rows fits {SMEM_LIMIT} bytes at C {c}")
    tile = groups * PATCH
    tiles = _cdiv(w, tile)
    grid = cluster * tiles * bands * n
    if grid > 2 ** 31 - 1:
        raise ValueError(f"{grid} blocks: more than the 2^31 - 1 a launch takes")
    return {"cluster": cluster, "c0": c0, "pairs": pairs, "lanes": lanes, "groups": groups,
            "tile": tile, "tiles": tiles, "band": band, "bands": bands, "ring": ring,
            "boxes": boxes, "threads": threads, "smem": smem, "grid": grid}


def dwconv_ln_reference(x, w, b, gamma, beta, eps: float = EPS) -> torch.Tensor:
    """Plain version of :func:`dwconv_ln`, the Pallas kernel's steps: the
    padded input in f32, ``acc + x_shifted·w`` over the taps dj-outer, + b,
    mean, mean of squared deviations, normalize, scale and shift in f32,
    one cast."""
    n, h, wd, c = x.shape
    taps = _taps(w)
    xp = torch.nn.functional.pad(x.float(), (0, 0, 3, 3, 3, 3))
    acc = torch.zeros((n, h, wd, c), dtype=torch.float32, device=x.device)
    for dj in range(7):
        xs = xp[:, :, dj:dj + wd]
        for di in range(7):
            acc = acc + xs[:, di:di + h] * taps[di * 7 + dj]
    acc = acc + b.float()
    mean = acc.mean(-1, keepdim=True)
    var = torch.square(acc - mean).mean(-1, keepdim=True)
    y = (acc - mean) * torch.rsqrt(var + eps)
    return (y * gamma.float() + beta.float()).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _launcher():
    p, i = ctypes.c_void_p, ctypes.c_int
    return build.bind("dwconv_ln", "dwconv_ln_launch",
                      [p] * 6 + [i] * 15 + [ctypes.c_float, i, p])


def dwconv_ln(x, w, b, gamma, beta, eps: float = EPS) -> torch.Tensor:
    """K11: ``LN(dwconv7×7(x) + b)·gamma + beta`` for x (N, H, W, C) in bf16
    or f32, w (C, 1, 7, 7), b, gamma, beta (C,), all parameters taken in
    f32. CUDA tensors run ``csrc/dwconv_ln.cu`` (counted in
    ``dwconv_ln.launches``), differentiable as the plain version
    (``ops/plain_grad.py``, the JAX package's vjp of its reference); CPU
    tensors run the plain version."""
    if x.ndim != 4:
        raise ValueError(f"x must be (N, H, W, C), got {tuple(x.shape)}")
    c = x.shape[-1]
    if w.shape[0] != c or any(tuple(t.shape) != (c,) for t in (b, gamma, beta)):
        raise ValueError(f"w must be ({c}, 1, 7, 7) and b, gamma, beta ({c},)")
    if x.device.type == "cpu":
        return dwconv_ln_reference(x, w, b, gamma, beta, eps)
    if x.dtype not in build.DTYPE_CODE:
        raise TypeError(f"x must be bfloat16 or float32, not {x.dtype}")
    if tuple(w.shape) != (c, 1, 7, 7):
        raise ValueError(f"w must be ({c}, 1, 7, 7), got {tuple(w.shape)}")
    return plain_grad(lambda *t: _dwconv_ln_launch(*t, eps),
                      lambda *t: dwconv_ln_reference(*t, eps), x, w, b, gamma, beta)


def _dwconv_ln_launch(x, w, b, gamma, beta, eps: float) -> torch.Tensor:
    """One launch of ``csrc/dwconv_ln.cu`` on CUDA tensors."""
    n, h, wd, c = x.shape
    if x.numel() == 0:
        return torch.empty_like(x)
    plan = dwconv_plan(n, h, wd, c, x.dtype)
    params = [t.float().contiguous() for t in (w, b, gamma, beta)]
    build.check_cuda_tensor(x, "x", x.dtype)
    for t, what in zip(params, ("w", "b", "gamma", "beta")):
        build.check_cuda_tensor(t, what, torch.float32)
        if t.device != x.device:
            raise ValueError(f"{what} must be on {x.device}, not {t.device}")
    if x.data_ptr() % 16:  # TMA reads x, and the weights come in 16-byte pieces
        x = x.clone()
    if params[0].data_ptr() % 16:
        params[0] = params[0].clone()
    out = torch.empty_like(x)
    build.launch(_launcher(), x.device, x.data_ptr(), *(t.data_ptr() for t in params),
                 out.data_ptr(), n, h, wd, c,
                 *(plan[k] for k in ("c0", "pairs", "lanes", "groups", "tiles", "band", "bands",
                                     "cluster", "ring", "boxes", "smem")),
                 float(eps), build.DTYPE_CODE[x.dtype])
    dwconv_ln.launches += 1
    return out


dwconv_ln.launches = 0
