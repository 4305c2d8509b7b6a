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

The hand-written CUDA kernel is ``csrc/dwconv_ln.cu``. The wrapper takes the
plain version only for tensors on the CPU; a CUDA tensor launches the kernel
or raises. The JAX package's ``ConvNeXtBlock`` resolves ``block_impl="auto"``
to its XLA form because of a TPU measurement (``models/convnext.py:88-95``);
the port's ``auto`` runs this kernel on CUDA tensors.

The weights are in the layout of ``nn.Conv2d(C, C, 7, groups=C)``:
(C, 1, 7, 7), the JAX package's (7, 7, 1, C) transposed.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from robustart_torch.ops import build

EPS = 1e-6
MAX_CHANNELS = 1024  # one thread a channel in a block


def _taps(w: torch.Tensor) -> torch.Tensor:
    """(C, 1, 7, 7) → (49, C) f32: tap di·7 + dj, then channel."""
    if w.ndim != 4 or tuple(w.shape[1:]) != (1, 7, 7):
        raise ValueError(f"w must be (C, 1, 7, 7), got {tuple(w.shape)}")
    return w.reshape(w.shape[0], 49).t().float().contiguous()


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
                      [p] * 6 + [i] * 4 + [ctypes.c_float, i, p])


def dwconv_ln(x, w, b, gamma, beta, eps: float = EPS) -> torch.Tensor:
    """K11: ``LN(dwconv7×7(x) + b)·gamma + beta`` for x (N, H, W, C) in bf16
    or f32, w (C, 1, 7, 7), b, gamma, beta (C,), all parameters taken in
    f32. CUDA tensors run ``csrc/dwconv_ln.cu`` (counted in
    ``dwconv_ln.launches``); CPU tensors run the plain version."""
    if x.ndim != 4:
        raise ValueError(f"x must be (N, H, W, C), got {tuple(x.shape)}")
    c = x.shape[-1]
    if w.shape[0] != c or any(tuple(t.shape) != (c,) for t in (b, gamma, beta)):
        raise ValueError(f"w must be ({c}, 1, 7, 7) and b, gamma, beta ({c},)")
    if x.device.type == "cpu":
        return dwconv_ln_reference(x, w, b, gamma, beta, eps)
    if x.dtype not in build.DTYPE_CODE:
        raise TypeError(f"x must be bfloat16 or float32, not {x.dtype}")
    if c % 32 or c > MAX_CHANNELS:
        raise ValueError(f"the kernel takes C a multiple of 32 up to {MAX_CHANNELS}, got {c}")
    params = [_taps(w)] + [t.float().contiguous() for t in (b, gamma, beta)]
    build.check_cuda_tensor(x, "x", x.dtype)
    for t, what in zip(params, ("w", "b", "gamma", "beta")):
        build.check_cuda_tensor(t, what, torch.float32)
        if t.device != x.device:
            raise ValueError(f"{what} must be on {x.device}, not {t.device}")
    out = torch.empty_like(x)
    n, h, wd, _ = x.shape
    if out.numel() == 0:
        return out
    build.launch(_launcher(), x.device, x.data_ptr(), *(t.data_ptr() for t in params),
                 out.data_ptr(), n, h, wd, c, float(eps), build.DTYPE_CODE[x.dtype])
    dwconv_ln.launches += 1
    return out


dwconv_ln.launches = 0
