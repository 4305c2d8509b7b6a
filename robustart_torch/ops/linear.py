"""Fused linear layer ``epilogue(prologue(x) · Wᵀ)``: the product inside the
transformer block kernels K6 (``ops/attention.py::window_block``) and K7
(``ops/mlp.py::mlp``).

The hand-written CUDA kernel is ``csrc/linear_fused.cu``;
:func:`linear_fused_reference` is its plain PyTorch version. The wrapper
takes the plain version only for tensors on the CPU; a CUDA tensor launches
the kernel or raises. Launches are counted by the K6 and K7 wrappers that
call it, once per call of theirs.

Weights are in nn.Linear's (out, in) layout: the transpose of the JAX
package's Dense kernels.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from robustart_torch.ops import build


def layer_norm_f32(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   eps: float) -> torch.Tensor:
    """LayerNorm over the last axis with f32 statistics, var = E[x²] − μ²
    (``robustart_tpu/ops/pallas_attention.py::_ln_f32``); returns f32."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True) - mu * mu
    y = (xf - mu) * torch.rsqrt(var + eps)
    return y * weight.float() + bias.float()


def linear_fused_reference(x, w, bias, *, ln=None, eps: float = 1e-6,
                           gelu: bool = False, gamma=None, residual=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`linear_fused`: the LN prologue cast to
    x's type, the product of the working-type values with f32 accumulation,
    then + bias, exact-erf GELU, · gamma, + residual in f32 and one cast."""
    dtype = x.dtype
    if ln is not None:
        x = layer_norm_f32(x, ln[0], ln[1], eps).to(dtype)
    y = torch.matmul(x.float(), w.to(dtype).float().t()) + bias.float()
    if gelu:
        y = torch.nn.functional.gelu(y)
    if gamma is not None:
        y = y * gamma.float()
    if residual is not None:
        y = y + residual.float()
    return y.to(dtype)


@functools.lru_cache(maxsize=None)
def _launcher():
    p = ctypes.c_void_p
    return build.bind("linear_fused", "linear_fused_launch",
                      [p] * 7 + [ctypes.c_float, p, ctypes.c_longlong] + [ctypes.c_int] * 4
                      + [p])


def linear_fused(x, w, bias, *, ln=None, eps: float = 1e-6, gelu: bool = False,
                 gamma=None, residual=None) -> torch.Tensor:
    """``out = T(gelu?(LN?(x) · wᵀ + bias) · gamma + residual)`` for x (M, K)
    and w (N, K) of one type T (bf16 or f32); bias (N,), gamma (N,) or None,
    ``ln = (weight, bias)`` (K,) and the sums in f32; residual (M, N) of
    type T or None. CPU tensors run the plain version."""
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[1]:
        raise ValueError(f"x (M, K) and w (N, K) expected, got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    m, k = x.shape
    n = w.shape[0]
    if residual is not None and tuple(residual.shape) != (m, n):
        raise ValueError(f"residual must be {(m, n)}, got {tuple(residual.shape)}")
    if tuple(bias.shape) != (n,) or (gamma is not None and tuple(gamma.shape) != (n,)) or (
            ln is not None and any(tuple(t.shape) != (k,) for t in ln)):
        raise ValueError(f"bias and gamma must be ({n},) and the LN parameters ({k},)")
    if x.device.type == "cpu":
        return linear_fused_reference(x, w, bias, ln=ln, eps=eps, gelu=gelu, gamma=gamma,
                                      residual=residual)
    if x.dtype not in build.DTYPE_CODE:
        raise TypeError(f"x must be bfloat16 or float32, not {x.dtype}")
    if k % 32:
        raise ValueError(f"the kernel takes K a multiple of 32, got {k}")
    tensors = [(x, "x", x.dtype), (w, "w", x.dtype), (bias, "bias", torch.float32)]
    if residual is not None:
        tensors.append((residual, "residual", x.dtype))
    if gamma is not None:
        tensors.append((gamma, "gamma", torch.float32))
    if ln is not None:
        tensors += [(ln[0], "ln weight", torch.float32), (ln[1], "ln bias", torch.float32)]
    for t, what, dtype in tensors:
        build.check_cuda_tensor(t, what, dtype)
    for t, what in ((x, "x"), (w, "w")):
        build.check_aligned(t, what)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0:
        return out

    def ptr(t):
        return None if t is None else t.data_ptr()

    ln_w, ln_b = (None, None) if ln is None else ln
    build.launch(_launcher(), x.device, x.data_ptr(), w.data_ptr(), bias.data_ptr(),
                 ptr(residual), ptr(gamma), ptr(ln_w), ptr(ln_b), float(eps), out.data_ptr(), m, n, k,
                 int(gelu), build.DTYPE_CODE[x.dtype])
    return out
