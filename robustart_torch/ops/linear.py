"""Fused linear layer ``epilogue(prologue(x) · Wᵀ)``: the product inside the
transformer block kernels K6 (``ops/attention.py::window_block``) and K7
(``ops/mlp.py::mlp``).

The hand-written CUDA kernel is ``csrc/linear_fused.cu`` (bf16: TMA, a ring
of mbarriers and ``wgmma``; f32: CUDA cores); :func:`linear_fused_reference`
is its plain PyTorch version. The wrapper takes the plain version only for
tensors on the CPU; a CUDA tensor launches the kernel or raises. Launches
are counted by the K6 and K7 wrappers that call it, once per call of theirs;
``linear_fused.launches`` and ``layer_norm.launches`` count every launch of
the two entries, from which K10's route over the product
(``ops/mlp.py::token_product``) counts its own.
:func:`gemm_plan` is the tile arithmetic around the kernel.

The activations are the JAX package's four (``pallas_mlp.py::_act_fn``),
named as there; :data:`ACT_CODE` gives the kernel's code of each
(``csrc/activation.cuh``). One more epilogue form serves the dense block
(K12, ``ops/densenet.py``): with ``scale``, ``relu(acc·scale + bias)`` per
column, a folded BatchNorm then ReLU (bf16 on the card, kernel code
:data:`SCALE_RELU`).

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


# the kernel's code of each activation (csrc/activation.cuh); None: no activation
ACT_CODE = {None: 0, "gelu": 1, "gelu_tanh": 2, "quick_gelu": 3, "relu": 4}
ACTIVATIONS = tuple(name for name in ACT_CODE if name is not None)
# the kernel's code of the scale form relu(acc·scale + bias) (csrc/linear_fused.cu)
SCALE_RELU = 5
# the product's tiles (csrc/linear_fused.cu): output tiles of 128 × 128, K
# in steps of 64; TMA's boxes of A and W are 64 (K) × 128 (rows)
TILE_ROWS, TILE_K = 128, 64
# TMA moves rows whose byte stride is a multiple of 16
_ROW_ALIGN = 16


def check_act(act: str | None) -> None:
    """Raise the JAX package's ValueError for an activation it does not know."""
    if act not in ACT_CODE:
        raise ValueError(f"unknown act {act!r}")


def activation(y: torch.Tensor, act: str | None) -> torch.Tensor:
    """``act`` of f32 ``y`` as the JAX package's ``_act_fn`` computes it:
    gelu with the exact erf, gelu_tanh, quick_gelu x·σ(1.702x) (CLIP), relu."""
    check_act(act)
    if act == "gelu":
        return torch.nn.functional.gelu(y)
    if act == "gelu_tanh":
        return torch.nn.functional.gelu(y, approximate="tanh")
    if act == "quick_gelu":
        return y * torch.sigmoid(1.702 * y)
    if act == "relu":
        return torch.relu(y)
    return y


def linear_fused_reference(x, w, bias, *, ln=None, eps: float = 1e-6,
                           act: str | None = None, gamma=None, residual=None,
                           scale=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`linear_fused`: the LN prologue cast to
    x's type, the product of the working-type values with f32 accumulation,
    then · scale, + bias, the activation, · gamma, + residual in f32 and one
    cast."""
    dtype = x.dtype
    if ln is not None:
        x = layer_norm_f32(x, ln[0], ln[1], eps).to(dtype)
    y = torch.matmul(x.float(), w.to(dtype).float().t())
    if scale is not None:
        y = y * scale.float()
    y = activation(y + bias.float(), act)
    if gamma is not None:
        y = y * gamma.float()
    if residual is not None:
        y = y + residual.float()
    return y.to(dtype)


def gemm_plan(m: int, n: int, k: int, itemsize: int) -> dict:
    """The tile arithmetic of one ``linear_fused`` launch on x (M, K) and
    w (N, K) of ``itemsize`` bytes: the TMA box of A and W (``box``: K
    values × rows; the tensor maps are (K, rows) innermost first, rows
    K·itemsize bytes apart) and the 128 × 128 output ``tiles`` along N and
    M. bf16 walks them with a persistent grid of one block an SM, f32 with
    one block a tile. K (and in bf16 N, whose output TMA stores) must make
    16-byte rows; TMA zero-fills the ragged tiles of M, N and K on loads and
    clips them on stores. The kernel refuses a box or tiling that is not its
    own."""
    if k <= 0 or (k * itemsize) % _ROW_ALIGN or k % 8:
        raise ValueError(f"the kernel takes K a multiple of 8 (16-byte rows), got {k}")
    if itemsize == 2 and n % 8:
        raise ValueError(f"the bf16 kernel takes N a multiple of 8 (TMA stores 16-byte rows), "
                         f"got {n}")
    tiles = (-(-n // TILE_ROWS), -(-m // TILE_ROWS))
    if tiles[1] > 65535:
        raise ValueError(f"the kernel takes at most {65535 * TILE_ROWS} rows, got {m}")
    return {"box": (TILE_K, TILE_ROWS), "tiles": tiles}


@functools.lru_cache(maxsize=None)
def _launcher():
    p, i = ctypes.c_void_p, ctypes.c_int
    return build.bind("linear_fused", "linear_fused_launch",
                      [p] * 7 + [ctypes.c_float, p, p, ctypes.c_longlong] + [i] * 8 + [p])


@functools.lru_cache(maxsize=None)
def _ln_launcher():
    p, i = ctypes.c_void_p, ctypes.c_int
    return build.bind("linear_fused", "layer_norm_launch",
                      [p, p, p, ctypes.c_float, p, ctypes.c_longlong, i, i, p])


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """``T(LN(x))`` over the last axis of x (M, K) of type T (bf16 or f32),
    any K, with f32 statistics and parameters: the LayerNorm pass of
    ``csrc/linear_fused.cu`` on its own, one warp a row. CPU tensors run
    the plain version, :func:`layer_norm_f32` cast to T. Each launch is
    counted in ``layer_norm.launches``."""
    if x.ndim != 2 or tuple(weight.shape) != (x.shape[1],) or tuple(bias.shape) != (x.shape[1],):
        raise ValueError(f"x (M, K) and LN parameters (K,) expected, got {tuple(x.shape)}, "
                         f"{tuple(weight.shape)} and {tuple(bias.shape)}")
    if x.device.type == "cpu":
        return layer_norm_f32(x, weight, bias, eps).to(x.dtype)
    if x.dtype not in build.DTYPE_CODE:
        raise TypeError(f"x must be bfloat16 or float32, not {x.dtype}")
    weight, bias = weight.float().contiguous(), bias.float().contiguous()
    for t, what, dtype in ((x, "x", x.dtype), (weight, "ln weight", torch.float32),
                           (bias, "ln bias", torch.float32)):
        build.check_cuda_tensor(t, what, dtype)
    out = torch.empty_like(x)
    build.launch(_ln_launcher(), x.device, x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
                 float(eps), out.data_ptr(), x.shape[0], x.shape[1], build.DTYPE_CODE[x.dtype])
    layer_norm.launches += 1
    return out


layer_norm.launches = 0


def linear_fused(x, w, bias, *, ln=None, eps: float = 1e-6, act: str | None = None,
                 gamma=None, residual=None, scale=None) -> torch.Tensor:
    """``out = T(act(LN?(x) · wᵀ + bias) · gamma + residual)`` for x (M, K)
    and w (N, K) of one type T (bf16 or f32); bias (N,), gamma (N,) or None,
    ``ln = (weight, bias)`` (K,) and the sums in f32; ``act`` one of
    :data:`ACTIVATIONS` or None; residual (M, N) of type T or None. Or, with
    ``scale`` (N,) f32, the dense block's form ``out = T(relu(x · wᵀ · scale
    + bias))``: act "relu", no LN, gamma or residual, bf16 on the card. CPU
    tensors run the plain version; each launch is counted in
    ``linear_fused.launches``."""
    check_act(act)
    if scale is not None and (act != "relu" or ln is not None or gamma is not None
                              or residual is not None):
        raise ValueError("the scale form is relu(acc·scale + bias) alone: act 'relu', "
                         "no ln, gamma or residual")
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[1]:
        raise ValueError(f"x (M, K) and w (N, K) expected, got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    m, k = x.shape
    n = w.shape[0]
    if residual is not None and tuple(residual.shape) != (m, n):
        raise ValueError(f"residual must be {(m, n)}, got {tuple(residual.shape)}")
    if any(t is not None and tuple(t.shape) != (n,) for t in (bias, gamma, scale)) or (
            ln is not None and any(tuple(t.shape) != (k,) for t in ln)):
        raise ValueError(f"bias, gamma and scale must be ({n},) and the LN parameters ({k},)")
    if x.device.type == "cpu":
        return linear_fused_reference(x, w, bias, ln=ln, eps=eps, act=act, gamma=gamma,
                                      residual=residual, scale=scale)
    if x.dtype not in build.DTYPE_CODE:
        raise TypeError(f"x must be bfloat16 or float32, not {x.dtype}")
    if scale is not None:
        if x.dtype != torch.bfloat16:
            raise TypeError(f"the scale form runs in bfloat16 on the card, not {x.dtype}")
        gamma = scale  # the kernel reads the scale in gamma's place
    plan = gemm_plan(m, n, k, x.element_size())
    tensors = [(x, "x", x.dtype), (w, "w", x.dtype), (bias, "bias", torch.float32)]
    if residual is not None:
        tensors.append((residual, "residual", x.dtype))
    if gamma is not None:
        tensors.append((gamma, "gamma", torch.float32))
    if ln is not None:
        tensors += [(ln[0], "ln weight", torch.float32), (ln[1], "ln bias", torch.float32)]
    for t, what, dtype in tensors:
        build.check_cuda_tensor(t, what, dtype)
    for t, what in ((x, "x"), (w, "w"), (bias, "bias"), (gamma, "gamma"),
                    (residual, "residual")) + (
            () if ln is None else ((ln[0], "ln weight"), (ln[1], "ln bias"))):
        if t is not None:
            build.check_aligned(t, what)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0:
        return out
    # the bf16 LayerNorm pass's output, which the product then reads
    xn = torch.empty_like(x) if ln is not None and x.dtype == torch.bfloat16 else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    ln_w, ln_b = (None, None) if ln is None else ln
    build.launch(_launcher(), x.device, x.data_ptr(), w.data_ptr(), bias.data_ptr(),
                 ptr(residual), ptr(gamma), ptr(ln_w), ptr(ln_b), float(eps), out.data_ptr(),
                 ptr(xn), m, n, k, ACT_CODE[act] if scale is None else SCALE_RELU,
                 build.DTYPE_CODE[x.dtype], *plan["box"],
                 *plan["tiles"])
    linear_fused.launches += 1
    return out


linear_fused.launches = 0
