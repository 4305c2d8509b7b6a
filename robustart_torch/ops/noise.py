"""Fused noise corruption + uint8 requantize + normalize (kernel K1).

Counterpart of ``robustart_tpu/ops/pallas_noise.py::fused_noise_normalize``
(the Pallas TPU kernel, ``pl.pallas_call`` at :141). The ImageNet-C noise
family's whole pre-model chain runs in one pass over a uint8 batch:

    u8 · (1/255) → noise → clip [0,1] → floor(·255) → (k/255 − µ_c)/σ_c

or, with ``output='centered_u8'``, the int8 grid ``k − 128`` that an int8
stem takes. The hand-written CUDA kernel is ``csrc/fused_noise.cu``; this
module builds it on first use (``robustart_torch.ops.build``), launches it
for CUDA tensors, and holds its plain PyTorch twin,
:func:`fused_noise_normalize_reference`, which draws the
same Philox4x32-10 bits with integer tensor ops. The wrapper takes the twin
only for tensors on the CPU (the tests); a CUDA tensor launches the kernel or
raises.

The random stream differs from the TPU kernel's by design: the TPU seeds
program ``i`` with ``seed + i``, so seed ``s`` image ``i+1`` repeats seed
``s+1`` image ``i``. Here Philox is keyed on ``(seed, image index)`` and
counts element pairs, so consecutive seeds share no stream.

``shot_noise`` in this kernel is the TPU kernel's Gaussian approximation of
Poisson(x·c)/c (std √(x/c)), not the exact sampler the ImageNet-C solver
uses (``robustart_torch.noise.corruptions.shot_noise``).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Sequence

import torch

from robustart_torch.models.layers import IMAGENET_MEAN, IMAGENET_STD
from robustart_torch.ops import build

NOISE_MODES = ("gaussian_noise", "speckle_noise", "impulse_noise", "shot_noise")
OUTPUTS = ("normalized", "centered_u8")
_OUT_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_INV255 = 1.0 / 255.0


# ---------------------------------------------------------------------------
# the CUDA kernel: build, bind, launch
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _launcher():
    """The C entry point of ``csrc/fused_noise.cu``, built for sm_90a at
    first use (``robustart_torch.ops.build``)."""
    return build.bind(
        "fused_noise", "fused_noise_launch",
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
         ctypes.c_uint, ctypes.c_int, ctypes.c_int]
        + [ctypes.c_float] * 9
        + [ctypes.c_int, ctypes.c_void_p],
    )


def _check_args(images_u8, seed, noise, output, out_dtype) -> None:
    if not isinstance(images_u8, torch.Tensor) or images_u8.dtype != torch.uint8:
        raise TypeError("images_u8 must be a uint8 tensor")
    if images_u8.ndim != 4 or images_u8.shape[-1] != 3:
        raise ValueError(f"expected (B, H, W, 3), got {tuple(images_u8.shape)}")
    if not 0 <= int(seed) <= _MASK32:
        raise ValueError(f"seed must fit in 32 bits, got {seed}")
    if noise not in NOISE_MODES:
        raise ValueError(f"unknown noise {noise!r}; one of {NOISE_MODES}")
    if output not in OUTPUTS:
        raise ValueError(f"unknown output {output!r}; one of {OUTPUTS}")
    want = (torch.int8,) if output == "centered_u8" else (torch.float32, torch.bfloat16)
    if out_dtype not in want:
        raise ValueError(f"output={output!r} takes out_dtype in {want}, got {out_dtype}")


def fused_noise_normalize(
    images_u8: torch.Tensor,
    seed: int,
    *,
    noise: str = "gaussian_noise",
    sigma: float = 0.18,
    mean: Sequence[float] = IMAGENET_MEAN,
    std: Sequence[float] = IMAGENET_STD,
    out_dtype: torch.dtype = torch.bfloat16,
    output: str = "normalized",
) -> torch.Tensor:
    """(B, H, W, 3) uint8 → (B, H, W, 3) ``out_dtype``, corrupted and
    normalized (or the int8 grid ``k − 128`` with ``output='centered_u8'``).

    ``sigma`` is the noise parameter: the std for gaussian/speckle, the
    salt-and-pepper amount for impulse, the photon count c for shot.
    ``seed`` is a 32-bit key; image ``b`` of the batch draws stream
    ``(seed, b)``. CUDA tensors run the kernel (counted in
    ``fused_noise_normalize.launches``); CPU tensors run the plain version.
    """
    _check_args(images_u8, seed, noise, output, out_dtype)
    dev = images_u8.device
    if dev.type == "cpu":
        return fused_noise_normalize_reference(
            images_u8, seed, noise=noise, sigma=sigma, mean=mean, std=std,
            out_dtype=out_dtype, output=output,
        )
    if dev.type != "cuda":
        raise ValueError(f"fused_noise_normalize runs on cuda or cpu, not {dev}")
    if not images_u8.is_contiguous():
        raise ValueError("images_u8 must be contiguous (NHWC)")
    b = images_u8.shape[0]
    n = images_u8[0].numel()
    if b > 65535:
        raise ValueError(f"batch {b} exceeds the kernel's grid limit 65535")
    out = torch.empty(images_u8.shape, dtype=out_dtype, device=dev)
    if out.numel() == 0:
        return out
    vec = (
        n % 4 == 0
        and images_u8.data_ptr() % 4 == 0
        and out.data_ptr() % (4 * out.element_size()) == 0
    )
    build.launch(
        _launcher(), dev, images_u8.data_ptr(), out.data_ptr(), b, n, int(seed),
        NOISE_MODES.index(noise), _OUT_KIND[out_dtype],
        float(sigma), sigma / 2, 1.0 - sigma / 2,
        *(float(v) for v in mean), *(float(v) for v in std), int(vec),
    )
    fused_noise_normalize.launches += 1
    return out


fused_noise_normalize.launches = 0


# ---------------------------------------------------------------------------
# the plain PyTorch version: same generator, same arithmetic
# ---------------------------------------------------------------------------


def _mulhilo(a: int, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit words of the 64-bit product of the constant ``a`` and
    the uint32 values in int64 ``b``, from 16-bit halves so that no
    intermediate leaves int64."""
    a_lo, a_hi = a & 0xFFFF, a >> 16
    b_lo, b_hi = b & 0xFFFF, b >> 16
    ll, lh, hl, hh = a_lo * b_lo, a_lo * b_hi, a_hi * b_lo, a_hi * b_hi
    mid = (ll >> 16) + (lh & 0xFFFF) + (hl & 0xFFFF)
    lo = ((mid & 0xFFFF) << 16) | (ll & 0xFFFF)
    hi = hh + (lh >> 16) + (hl >> 16) + (mid >> 16)
    return hi, lo


def philox4x32_10(counter, key) -> tuple[torch.Tensor, ...]:
    """Philox4x32-10 (Salmon et al., SC'11) on int64 tensors holding uint32
    values: ``counter`` is four broadcastable words, ``key`` two."""
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64) for c in counter)
    k0, k1 = (torch.as_tensor(k, dtype=torch.int64) for k in key)
    for _ in range(10):
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _PHILOX_W[0]) & _MASK32
        k1 = (k1 + _PHILOX_W[1]) & _MASK32
    return c0, c1, c2, c3


def philox_bits(seed: int, batch: int, n: int, device="cpu") -> torch.Tensor:
    """The kernel's random words: int64 (batch, n, 2) of uint32 values.

    Element ``e`` of image ``b`` takes words (x, y) of
    ``philox((e//2, 0, 0, 0), (seed, b))`` for even ``e`` and (z, w) for
    odd ``e``.
    """
    pairs = (n + 1) // 2
    ctr = torch.arange(pairs, dtype=torch.int64, device=device).unsqueeze(0)
    img = torch.arange(batch, dtype=torch.int64, device=device).unsqueeze(1)
    zero = torch.zeros((), dtype=torch.int64, device=device)
    seed_t = torch.full((), int(seed), dtype=torch.int64, device=device)
    x, y, z, w = philox4x32_10((ctr, zero, zero, zero), (seed_t, img))
    w1 = torch.stack([x, z], dim=-1).reshape(batch, 2 * pairs)[:, :n]
    w2 = torch.stack([y, w], dim=-1).reshape(batch, 2 * pairs)[:, :n]
    return torch.stack([w1, w2], dim=-1)


def _uniform24(bits: torch.Tensor) -> torch.Tensor:
    """uint32 → float32 uniform in (0, 1): top 24 bits, never exactly 0."""
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24)) + (0.5 / (1 << 24))


def _box_muller(w1: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    r = torch.sqrt(-2.0 * torch.log(_uniform24(w1)))
    return r * torch.cos((2.0 * math.pi) * _uniform24(w2))


def fused_noise_normalize_reference(
    images_u8: torch.Tensor,
    seed: int,
    *,
    noise: str = "gaussian_noise",
    sigma: float = 0.18,
    mean: Sequence[float] = IMAGENET_MEAN,
    std: Sequence[float] = IMAGENET_STD,
    out_dtype: torch.dtype = torch.bfloat16,
    output: str = "normalized",
    bits=None,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_noise_normalize`.

    Draws the kernel's Philox words bit for bit and repeats its float steps
    one rounding at a time. ``bits`` (int, broadcastable to
    ``images_u8.shape + (2,)``, uint32 values) replaces the generator, so a
    test can feed the TPU interpreter's all-zero draws.
    """
    _check_args(images_u8, seed, noise, output, out_dtype)
    dev = images_u8.device
    b = images_u8.shape[0]
    n = images_u8[0].numel()
    if bits is None:
        bits = philox_bits(seed, b, n, dev)
    else:
        bits = torch.as_tensor(bits, dtype=torch.int64, device=dev)
        bits = bits.expand(*images_u8.shape, 2).reshape(b, n, 2)
    w1, w2 = bits[..., 0], bits[..., 1]
    x = images_u8.reshape(b, n).to(torch.float32) * _INV255
    if noise == "gaussian_noise":
        x = x + sigma * _box_muller(w1, w2)
    elif noise == "speckle_noise":
        x = x + x * (sigma * _box_muller(w1, w2))
    elif noise == "impulse_noise":
        u = _uniform24(w1)
        x = torch.where(u < sigma / 2, 0.0, x)
        x = torch.where(u > 1.0 - sigma / 2, 1.0, x)
    else:  # shot_noise, Gaussian approximation
        x = x + torch.sqrt(torch.clamp_min(x, 0.0) / sigma) * _box_muller(w1, w2)
    k = torch.floor(torch.clamp(x, 0.0, 1.0) * 255.0)
    if output == "centered_u8":
        return (k.to(torch.int32) - 128).to(torch.int8).reshape(images_u8.shape)
    ch = torch.arange(n, device=dev) % 3
    mean_v = torch.tensor([float(v) for v in mean], dtype=torch.float32, device=dev)[ch]
    std_v = torch.tensor([float(v) for v in std], dtype=torch.float32, device=dev)[ch]
    out = (k * _INV255 - mean_v) / std_v
    return out.to(out_dtype).reshape(images_u8.shape)
