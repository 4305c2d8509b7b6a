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
token. On CUDA tensors it runs ``csrc/token_mlp.cu``, which keeps the
(B, C, T) transpose and the (B, C, H) hidden on the chip, as the TPU kernel
does: in bf16 a statistics pass and the fused MLP (two chained ``wgmma``
products, the hidden in registers) on the weights :func:`pack_token_weights`
pads, with :func:`token_plan` the tile arithmetic; in f32 one launch on the
CUDA cores. Both hold yᵀ for all tokens of a block at once, so they take
at most :data:`MAX_TOKENS`; above that (Mixer-B/16 at 384 px: 576 tokens)
:func:`token_plan` routes a call over ``csrc/linear_fused.cu``'s product
instead (:func:`token_product`). :func:`token_mlp_reference` is its plain
version.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from robustart_torch.ops import build
from robustart_torch.ops.linear import (ACT_CODE, ACTIVATIONS, activation, gemm_plan,
                                        layer_norm, layer_norm_f32, linear_fused,
                                        linear_fused_reference)

# K10's bf16 kernel holds yᵀ (64 channels × Tp tokens) in a warpgroup's
# registers as the N of one wgmma, whose largest N is 256; its f32 kernel
# takes as many. More tokens take the route over the product.
MAX_TOKENS = 256
# the product route's token padding: the product's K and N in 16-byte rows
TOKEN_ALIGN = 16
# the widths Tp the bf16 kernel is compiled for (the second product's N, an
# immediate of the instruction; multiples of its K step of 16)
TOKEN_WIDTHS = (64, 128, 208, 256)
TOKEN_CHANNELS = 128  # channels a block: two consumer warpgroups of 64
TOKEN_HIDDEN = 64  # hidden units a chunk, and Hp's multiple


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


def token_plan(b: int, t: int, c: int, h: int) -> dict:
    """How one :func:`token_mlp` call runs on the card at x (B, T, C) and
    hidden width H, chosen by T.

    ``"fused"`` (T ≤ :data:`MAX_TOKENS`), ``csrc/token_mlp.cu``; its bf16
    tile arithmetic: ``tp``, the compiled width T is zero-padded to (the
    smallest of :data:`TOKEN_WIDTHS` that holds it: the first product's K
    in steps of 16 and the second's N), ``hp``, H rounded up to the hidden
    ``chunks`` of :data:`TOKEN_HIDDEN`, the ``channel_tiles`` of
    :data:`TOKEN_CHANNELS` and the ``grid`` (channel tiles, B). Any C: the
    kernel loads and stores x in 16-byte vectors where C % 8 == 0, element
    by element otherwise.

    ``"product"`` (more tokens), :func:`token_product`: the LN pass over C,
    then fc1 and fc2 on ``csrc/linear_fused.cu``'s product over the ``rows``
    B·C of the transposed x, T zero-padded to ``tp``, a multiple of
    :data:`TOKEN_ALIGN`, and H to ``hp`` as above; ``tiles``, the two
    products' 128 × 128 output tiles (:func:`gemm_plan`).

    Both take the weights :func:`pack_token_weights` pads to (Hp, Tp) and
    (Tp, Hp). Raises for an empty axis or more than 65,535 images."""
    if t <= 0 or b <= 0 or c <= 0 or h <= 0:
        raise ValueError(f"B, T, C and H must be positive, got {b}, {t}, {c}, {h}")
    if b > 65535:
        raise ValueError(f"the kernel takes at most 65535 images, got {b}")
    hp = -(-h // TOKEN_HIDDEN) * TOKEN_HIDDEN
    if t > MAX_TOKENS:
        tp = -(-t // TOKEN_ALIGN) * TOKEN_ALIGN
        return {"route": "product", "tp": tp, "hp": hp, "rows": b * c,
                "tiles": (gemm_plan(b * c, hp, tp, 2)["tiles"],
                          gemm_plan(b * c, tp, hp, 2)["tiles"])}
    tp = next(w for w in TOKEN_WIDTHS if t <= w)
    tiles = -(-c // TOKEN_CHANNELS)
    return {"route": "fused", "tp": tp, "hp": hp, "chunks": hp // TOKEN_HIDDEN,
            "channel_tiles": tiles, "grid": (tiles, b)}


def pack_token_weights(w1: torch.Tensor, w2: torch.Tensor,
                       dtype: torch.dtype = torch.bfloat16) -> tuple[torch.Tensor, torch.Tensor]:
    """K10's weights as the bf16 kernel and the product route read them:
    W1 (H, T) as (Hp, Tp) and W2 (T, H) as (Tp, Hp) of ``dtype``
    (:func:`token_plan`), row-major, the padding exact zeros. Row-major is
    the layout the TMA boxes read: TMA lays each box into shared memory in
    the 128-byte swizzle itself. A model packs once in bf16
    (``models/mlp_mixer.py``); the f32 product route packs at each call."""
    h, t = w1.shape
    if w1.ndim != 2 or tuple(w2.shape) != (t, h):
        raise ValueError(f"w1 (H, T) and w2 (T, H) expected, got {tuple(w1.shape)} and "
                         f"{tuple(w2.shape)}")
    plan = token_plan(1, t, 1, h)
    pad = torch.nn.functional.pad
    return (pad(w1.to(dtype), (0, plan["tp"] - t, 0, plan["hp"] - h)).contiguous(),
            pad(w2.to(dtype), (0, plan["hp"] - h, 0, plan["tp"] - t)).contiguous())


def _check_packed(packed, t: int, h: int) -> None:
    """Raise unless ``packed`` is :func:`pack_token_weights`' pair for T
    tokens and H hidden units."""
    plan = token_plan(1, t, 1, h)
    want = ((plan["hp"], plan["tp"]), (plan["tp"], plan["hp"]))
    if (len(packed) != 2 or tuple(tuple(w.shape) for w in packed) != want
            or any(w.dtype != torch.bfloat16 for w in packed)):
        raise ValueError(f"packed weights must be pack_token_weights' bf16 W1 {want[0]} and "
                         f"W2 {want[1]}, got "
                         f"{[(tuple(w.shape), w.dtype) for w in packed]}")


@functools.lru_cache(maxsize=None)
def _token_launcher():
    p, i = ctypes.c_void_p, ctypes.c_int
    return build.bind("token_mlp", "token_mlp_f32_launch",
                      [p] * 8 + [ctypes.c_float, p] + [i] * 5 + [p])


@functools.lru_cache(maxsize=None)
def _stats_launcher():
    p = ctypes.c_void_p
    return build.bind("token_mlp", "token_stats_launch",
                      [p, ctypes.c_float, p, ctypes.c_longlong, ctypes.c_int, p])


@functools.lru_cache(maxsize=None)
def _fused_launcher():
    p, i = ctypes.c_void_p, ctypes.c_int
    return build.bind("token_mlp", "token_mlp_bf16_launch", [p] * 10 + [i] * 7 + [p])


def token_stats(x: torch.Tensor, eps: float) -> torch.Tensor:
    """The bf16 kernel's first launch on x (B, T, C): (B·T, 2) f32, the
    mean and 1/√(var + eps) of each token over C. Not counted: it is part of
    a :func:`token_mlp` call."""
    b, t, c = x.shape
    stats = torch.empty((b * t, 2), dtype=torch.float32, device=x.device)
    build.launch(_stats_launcher(), x.device, x.data_ptr(), float(eps), stats.data_ptr(), b * t,
                 c)
    return stats


def token_fused(x, packed, b1, b2, plan: dict, h: int, res=None, ln=None, stats=None,
                act: str = "gelu") -> torch.Tensor:
    """The bf16 kernel's second launch, the fused MLP, on checked tensors:
    ``packed`` from :func:`pack_token_weights`, ``ln`` and ``stats`` (from
    :func:`token_stats`) both or neither. Not counted: it is part of a
    :func:`token_mlp` call."""
    b, t, c = x.shape
    out = torch.empty_like(x)

    def ptr(v):
        return None if v is None else v.data_ptr()

    ln_w, ln_b = (None, None) if ln is None else ln
    build.launch(_fused_launcher(), x.device, x.data_ptr(), packed[0].data_ptr(), b1.data_ptr(),
                 packed[1].data_ptr(), b2.data_ptr(), ptr(res), ptr(ln_w), ptr(ln_b), ptr(stats),
                 out.data_ptr(), b, t, c, h, plan["tp"], plan["hp"], ACT_CODE[act])
    return out


def token_product(x, packed, b1, b2, plan: dict, res=None, ln=None, ln_eps: float = 1e-6,
                  act: str = "gelu") -> torch.Tensor:
    """K10's route over the product (:func:`token_plan`'s ``"product"``) on
    x (B, T, C): ``T(LN(x))`` over C by ``linear_fused.cu``'s LN pass (where
    ``ln``), the transpose to (B·C, Tp) with the padded tokens zero, fc1 +
    b1 and the activation on ``packed[0]`` (Hp, Tp), fc2 + b2 + the
    transposed residual ``res`` on ``packed[1]`` (Tp, Hp), each one launch
    of the product with its f32 epilogue and one cast, then the transpose
    back. The transposes are torch's layout work. The padding is exact: a
    padded token is zero in x and in W1, a padded hidden unit's W1 row and
    b1 are zero (every activation is 0 at 0) and its W2 column too. The
    launches, as the LN pass's and the product's wrappers count them where
    they launch, go to ``token_mlp.product_launches``. On CPU tensors each
    step runs its plain version (the tests check the composition there) and
    none launches."""
    b, t, c = x.shape
    tp, hp = plan["tp"], plan["hp"]
    pad = torch.nn.functional.pad

    def tokens_last(v):
        return pad(v.transpose(1, 2), (0, tp - t)).reshape(b * c, tp).contiguous()

    before = layer_norm.launches + linear_fused.launches
    xn = x if ln is None else layer_norm(x.reshape(b * t, c), ln[0], ln[1],
                                         ln_eps).reshape(b, t, c)
    a = linear_fused(tokens_last(xn), packed[0], pad(b1.float(), (0, hp - b1.shape[0])), act=act)
    yt = linear_fused(a, packed[1], pad(b2.float(), (0, tp - t)),
                      residual=None if res is None else tokens_last(res))
    token_mlp.product_launches += layer_norm.launches + linear_fused.launches - before
    return yt.reshape(b, c, tp)[:, :, :t].transpose(1, 2).contiguous()


def token_mlp(x, w1, b1, w2, b2, shortcut=None, act: str = "gelu", ln=None,
              ln_eps: float = 1e-6, residual_input: bool = False, packed=None) -> torch.Tensor:
    """K10 on x (B, T, C) in bf16 or f32: the MLP over the token axis,
    W1 (H, T), W2 (T, H) in x's type or cast to it, b1 (H,), b2 (T,), with
    any of the four activations.
    ``ln = (weight, bias)`` (C,): x is the pre-norm input;
    ``residual_input`` adds that raw x, ``shortcut`` (x's shape) another
    tensor. ``packed``: :func:`pack_token_weights` of W1 and W2, made once
    by a model (checked against x's T and W1's H here; made here when
    None). CUDA tensors run :func:`token_plan`'s route, counted in
    ``token_mlp.launches`` once a call: up to :data:`MAX_TOKENS` tokens
    ``csrc/token_mlp.cu`` (in bf16 the statistics pass, where ``ln``, and
    the fused MLP on the packed weights; in f32 one launch on the unpacked
    ones); above, :func:`token_product` (the launches it issues also in
    ``token_mlp.product_launches``; in f32 on weights padded at the call).
    CPU tensors run the plain version."""
    _check_token(x, w1, b1, w2, b2, act, shortcut, residual_input)
    b, t, c = x.shape
    h = w1.shape[0]
    if packed is not None:
        _check_packed(packed, t, h)
    if x.device.type == "cpu":
        return token_mlp_reference(x, w1, b1, w2, b2, shortcut, act, ln, ln_eps,
                                   residual_input)
    if x.dtype not in build.DTYPE_CODE:
        raise TypeError(f"x must be bfloat16 or float32, not {x.dtype}")
    if x.numel() == 0:
        return torch.empty_like(x)
    plan = token_plan(b, t, c, h)
    b1, b2 = b1.float().contiguous(), b2.float().contiguous()
    if b1.data_ptr() % 16:  # the bf16 kernel loads b1 by TMA, from a 16-byte boundary
        b1 = b1.clone()
    tensors = [(x, "x", x.dtype), (b1, "b1", torch.float32), (b2, "b2", torch.float32)]
    if x.dtype == torch.bfloat16:
        if packed is None:
            packed = pack_token_weights(w1, w2)
        tensors += [(packed[0], "packed w1", x.dtype), (packed[1], "packed w2", x.dtype)]
    else:
        w1, w2 = w1.to(x.dtype).contiguous(), w2.to(x.dtype).contiguous()
        tensors += [(w1, "w1", x.dtype), (w2, "w2", x.dtype)]
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
    res = x if residual_input else shortcut
    if plan["route"] == "product":
        if x.dtype != torch.bfloat16:
            packed = pack_token_weights(w1, w2, x.dtype)
        out = token_product(x, packed, b1, b2, plan, res, ln, ln_eps, act)
    elif x.dtype == torch.bfloat16:
        stats = None if ln is None else token_stats(x, ln_eps)
        out = token_fused(x, packed, b1, b2, plan, h, res, ln, stats, act)
    else:
        out = torch.empty_like(x)
        ln_w, ln_b = (None, None) if ln is None else (ln[0].data_ptr(), ln[1].data_ptr())
        build.launch(_token_launcher(), x.device, x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                     w2.data_ptr(), b2.data_ptr(), None if res is None else res.data_ptr(),
                     ln_w, ln_b, float(ln_eps), out.data_ptr(), b, t, c, h, ACT_CODE[act])
    token_mlp.launches += 1
    return out


token_mlp.launches = 0
token_mlp.product_launches = 0
