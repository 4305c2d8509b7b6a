"""Fused transformer and ConvNeXt MLP (kernel K7) and MLP-Mixer's
token-mixing MLP (kernel K10).

Counterpart of ``robustart_tpu/ops/pallas_mlp.py::mlp_pallas`` (the Pallas
TPU kernel, ``pl.pallas_call`` at :200):

    y = [LN →] act(x·W1ᵀ + b1)·W2ᵀ + b2 [· gamma] [+ residual]

with ``act`` one of the JAX package's four (``pallas_mlp.py::_act_fn``):
``gelu``, ``gelu_tanh``, ``quick_gelu`` (CLIP) and ``relu``; an unknown
name raises the JAX package's ValueError. The plain version's gelu takes the
exact erf, the kernels' the TPU kernel's polynomial (within 1.5e-7).
:func:`mlp_reference` is its plain PyTorch version, ``pallas_mlp.py:68-86``
step by step. On CUDA tensors :func:`mlp` runs the
hand-written kernel ``csrc/linear_fused.cu`` twice: fc1 with the LN prologue
and the activation epilogue, then fc2 with the bias, ConvNeXt's layer-scale
``gamma`` and the ``residual``: the raw pre-norm x (the ViT and Swin form)
or ConvNeXt's block input, added after the layer-scale as
``(acc + b2)·gamma + residual`` in f32 with one cast. The (M, F) hidden goes through device memory in this version; the TPU
kernel keeps it in VMEM. CPU tensors run the plain version.

Weights are in nn.Linear's (out, in) layout: W1 (F, C), W2 (C, F), the
transposes of the JAX package's; biases, gamma and LN parameters f32.

K10, :func:`token_mlp`, is the counterpart of
``robustart_tpu/ops/pallas_mlp.py::token_mlp_pallas`` (``pl.pallas_call`` at
:461), forward only: the same MLP along the token axis of (B, T, C), with
W1 (H, T) and W2 (T, H) (timm's ``mlp_tokens.fc1/fc2``), b2 indexed by the
token. On CUDA tensors it runs ``csrc/token_mlp.cu`` in one launch that
keeps the (B, C, T) transpose and the (B, C, H) hidden on the chip, as the
TPU kernel does; :func:`token_mlp_reference` is its plain version.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from robustart_torch.ops import build
from robustart_torch.ops.linear import (ACT_CODE, ACTIVATIONS, activation, layer_norm_f32,
                                        linear_fused, linear_fused_reference)

MAX_TOKENS = 256  # the kernel holds a block's (T, 64) tile and y in one SM


def _check(x, act, residual) -> None:
    if act not in ACTIVATIONS:
        raise ValueError(f"unknown act {act!r}")
    if x.ndim < 2:
        raise ValueError(f"x must be (..., C), got {tuple(x.shape)}")
    if residual is not None and residual.shape != x.shape:
        raise ValueError(f"residual must have x's shape {tuple(x.shape)}, "
                         f"got {tuple(residual.shape)}")


def mlp_reference(x, w1, b1, w2, b2, ln=None, ln_eps: float = 1e-6, residual=None,
                  act: str = "gelu", gamma=None) -> torch.Tensor:
    """Plain version of :func:`mlp`: the LN prologue cast to x's type, fc1
    with f32 accumulation + b1, the activation, cast, fc2 + b2 [· gamma]
    [+ residual] in f32, one cast."""
    _check(x, act, residual)
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    res = None if residual is None else residual.reshape(x2.shape)
    h = linear_fused_reference(x2, w1, b1, ln=ln, eps=ln_eps, act=act)
    y = linear_fused_reference(h, w2, b2, gamma=gamma, residual=res)
    return y.reshape(shape)


def mlp(x, w1, b1, w2, b2, ln=None, ln_eps: float = 1e-6, residual=None, act: str = "gelu",
        gamma=None) -> torch.Tensor:
    """K7 on x (..., C) in bf16 or f32. ``ln = (weight, bias)``: x is the
    pre-norm input; ``gamma`` (C,) scales fc2's output and ``residual``
    (x's shape and type) is added after it. CUDA tensors run the kernel
    (counted in ``mlp.launches``, once a call); CPU tensors run the plain
    version."""
    if x.device.type == "cpu":
        return mlp_reference(x, w1, b1, w2, b2, ln, ln_eps, residual, act, gamma)
    _check(x, act, residual)
    out = fused_mlp(x, w1, b1, w2, b2, ln, ln_eps, residual, gamma, act)
    mlp.launches += 1
    return out


mlp.launches = 0


def fused_mlp(x, w1, b1, w2, b2, ln, ln_eps: float, residual=None, gamma=None,
              act: str = "gelu") -> torch.Tensor:
    """The two launches of K7 on CUDA tensors (on CPU tensors, the plain
    version of each: the tests check the composition there)."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    if ln is not None:
        ln = (ln[0].float(), ln[1].float())
    res = None if residual is None else residual.reshape(x2.shape)
    h = linear_fused(x2, w1.to(x.dtype), b1.float(), ln=ln, eps=ln_eps, act=act)
    y = linear_fused(h, w2.to(x.dtype), b2.float(),
                     gamma=None if gamma is None else gamma.float(), residual=res)
    return y.reshape(shape)


def _check_token(x, w1, b1, w2, b2, act, shortcut, residual_input) -> None:
    if act not in ACTIVATIONS:
        raise ValueError(f"unknown act {act!r}")
    if x.ndim != 3:
        raise ValueError(f"x must be (B, T, C), got {tuple(x.shape)}")
    t = x.shape[1]
    h = w1.shape[0]
    if (tuple(w1.shape) != (h, t) or tuple(w2.shape) != (t, h) or tuple(b1.shape) != (h,)
            or tuple(b2.shape) != (t,)):
        raise ValueError(f"w1 must be (H, {t}), w2 ({t}, H), b1 (H,) and b2 ({t},); got "
                         f"{tuple(w1.shape)}, {tuple(w2.shape)}, {tuple(b1.shape)}, "
                         f"{tuple(b2.shape)}")
    if shortcut is not None and (residual_input or shortcut.shape != x.shape):
        raise ValueError("shortcut must have x's shape, and excludes residual_input")


def token_mlp_reference(x, w1, b1, w2, b2, shortcut=None, act: str = "gelu", ln=None,
                        ln_eps: float = 1e-6, residual_input: bool = False) -> torch.Tensor:
    """Plain version of :func:`token_mlp`: the LN prologue over C cast to x's
    type, ``u = x̂ᵀ·W1ᵀ + b1`` (B, C, H) with f32 accumulation, the
    activation, cast, ``y = W2·act(u)ᵀ + b2[t]`` (B, T, C) in f32, + the raw pre-norm x
    (``residual_input``) or ``shortcut`` in f32, one cast
    (``pallas_mlp.py::_token_mlp_kernel``, :392-428)."""
    _check_token(x, w1, b1, w2, b2, act, shortcut, residual_input)
    dtype = x.dtype
    xn = x if ln is None else layer_norm_f32(x, ln[0], ln[1], ln_eps).to(dtype)
    u = torch.matmul(xn.float().transpose(1, 2), w1.to(dtype).float().t()) + b1.float()
    a = activation(u, act).to(dtype)
    y = torch.matmul(w2.to(dtype).float(), a.float().transpose(1, 2)) + b2.float()[:, None]
    res = x if residual_input else shortcut
    if res is not None:
        y = y + res.float()
    return y.to(dtype)


@functools.lru_cache(maxsize=None)
def _token_launcher():
    p, i = ctypes.c_void_p, ctypes.c_int
    return build.bind("token_mlp", "token_mlp_launch",
                      [p] * 8 + [ctypes.c_float, p] + [i] * 6 + [p])


def token_mlp(x, w1, b1, w2, b2, shortcut=None, act: str = "gelu", ln=None,
              ln_eps: float = 1e-6, residual_input: bool = False) -> torch.Tensor:
    """K10 on x (B, T, C) in bf16 or f32: the MLP over the token axis,
    W1 (H, T), W2 (T, H) in x's type or cast to it, b1 (H,), b2 (T,), with
    any of the four activations.
    ``ln = (weight, bias)`` (C,): x is the pre-norm input;
    ``residual_input`` adds that raw x, ``shortcut`` (x's shape) another
    tensor. CUDA tensors run ``csrc/token_mlp.cu`` (counted in
    ``token_mlp.launches``); CPU tensors run the plain version."""
    if x.device.type == "cpu":
        return token_mlp_reference(x, w1, b1, w2, b2, shortcut, act, ln, ln_eps,
                                   residual_input)
    _check_token(x, w1, b1, w2, b2, act, shortcut, residual_input)
    if x.dtype not in build.DTYPE_CODE:
        raise TypeError(f"x must be bfloat16 or float32, not {x.dtype}")
    b, t, c = x.shape
    if t > MAX_TOKENS:
        raise ValueError(f"the kernel takes at most {MAX_TOKENS} tokens, got {t}")
    w1, w2 = w1.to(x.dtype).contiguous(), w2.to(x.dtype).contiguous()
    b1, b2 = b1.float().contiguous(), b2.float().contiguous()
    tensors = [(x, "x", x.dtype), (w1, "w1", x.dtype), (w2, "w2", x.dtype),
               (b1, "b1", torch.float32), (b2, "b2", torch.float32)]
    if shortcut is not None:
        tensors.append((shortcut, "shortcut", x.dtype))
    if ln is not None:
        ln = (ln[0].float().contiguous(), ln[1].float().contiguous())
        if any(tuple(v.shape) != (c,) for v in ln):
            raise ValueError(f"the LN parameters must be ({c},)")
        tensors += [(ln[0], "ln weight", torch.float32), (ln[1], "ln bias", torch.float32)]
    for v, what, dtype in tensors:
        build.check_cuda_tensor(v, what, dtype)
        if v.device != x.device:
            raise ValueError(f"{what} must be on {x.device}, not {v.device}")
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    res = x if residual_input else shortcut
    ln_w, ln_b = (None, None) if ln is None else (ln[0].data_ptr(), ln[1].data_ptr())
    build.launch(_token_launcher(), x.device, x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                 w2.data_ptr(), b2.data_ptr(), None if res is None else res.data_ptr(), ln_w,
                 ln_b, float(ln_eps), out.data_ptr(), b, t, c, w1.shape[0], ACT_CODE[act],
                 build.DTYPE_CODE[x.dtype])
    token_mlp.launches += 1
    return out


token_mlp.launches = 0
