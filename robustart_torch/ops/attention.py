"""Attention kernels: K8 (:func:`mha`), K9 (:func:`window_mha`) and K6
(:func:`window_block`).

Counterparts of ``robustart_tpu/ops/pallas_attention.py``:

- :func:`mha` is ``mha_pallas`` (the Pallas TPU kernel, ``pl.pallas_call``
  at :52): ``softmax(Q·Kᵀ/√d)·V`` per (image, head) on (B, N, H, D), q·scale
  and the scores in f32, P cast to V's type. :func:`mha_reference` is its
  plain version (the JAX package names none: the Pallas kernel's steps; at
  f32 it is the einsum form of ``models/vit.py:145-155``).
- :func:`window_mha` is ``window_mha_pallas`` (:203), Swin's window
  attention: ``softmax(q·scale·kᵀ + rel_bias + mask)·V`` per (window, head)
  with f32 scores (kernel :125-153), the (H, N, N) relative-position bias
  and the (nW, N, N) shift mask of each window position (windows
  image-major, window b taking mask b % nW). :func:`window_mha_reference`
  is its plain version.
- :func:`window_block` is ``window_block_pallas`` (:628): the whole attention
  half ``x + proj(attn(LN(x)))``, relative-position bias and shift mask
  included. :func:`window_block_reference` is its plain version with the
  semantics of the JAX reference (:312-347), which casts q·scale and the
  scores to the working type before adding the f32 bias and mask: at Swin's
  head width 32 the scale 1/√32 is not exact in bf16, so the kernel rounds
  q·scale too. :func:`window_block_qkv` is the same kernel on the packed
  (3C, C) q/k/v weights, as ``nn.Linear(C, 3C)`` holds them (ViT and Swin).

Hand-written CUDA kernels: ``csrc/attention_core.cu`` (K8, K9, and step (b)
of K6) and ``csrc/linear_fused.cu`` (K6's LN + q/k/v product and its proj +
residual product). A wrapper takes the plain version only for tensors on the
CPU; a CUDA tensor launches the kernels or raises. On CUDA the head width is
32 or 64 and a window or image holds at most 256 tokens; the plain versions
take any.

Weights are in nn.Linear's (out, in) layout (the transpose of the JAX
package's), biases, LN parameters, bias and mask f32.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from robustart_torch.ops import build
from robustart_torch.ops.linear import layer_norm_f32, linear_fused

HEAD_DIMS = (32, 64)  # the head widths the kernel takes: Swin's and ViT's
MAX_TOKENS = 256  # keys a block holds in shared memory (197 at B/16, 49 a Swin window)
# the JAX policy's weight budget per head group (bytes of the TPU's VMEM):
# kept only so that the branch rule below is the JAX package's
_JAX_WEIGHT_BUDGET = 5 * 2**20


def block_kernel_head_groups(c: int, num_heads: int, itemsize: int) -> int | None:
    """The JAX package's whole-block policy (``pallas_attention.py:807-826``):
    the head-group count of the fused block kernel at width ``c``, or None
    where it has none. ViT's ``EncoderBlock`` and Swin's ``SwinBlock`` take
    the fused branch (K6) where this is not None: C % 128 == 0 and
    lane-aligned head groups. ViT-B → 1 (bf16) or 2 (f32); DeiT-Tiny
    (C = 192) and Swin-T's first two stages (C = 96, 192) → None. The port
    has no use for the count itself, which sizes VMEM blocks on the TPU."""
    if c % 128:
        return None
    d = c // num_heads
    g = 1
    while g <= num_heads:
        if (4 * c * c * itemsize) // g <= _JAX_WEIGHT_BUDGET:
            gc = (num_heads // g) * d
            return g if gc % 128 == 0 else None
        g *= 2
        if g <= num_heads and num_heads % g:
            return None
    return None


def _softmax_f32(s: torch.Tensor) -> torch.Tensor:
    """Row softmax as the kernels take it: max-subtract, exp, divide."""
    p = torch.exp(s - s.amax(-1, keepdim=True))
    return p / p.sum(-1, keepdim=True)


def attention_core_reference(q, k, v, rel_bias=None, mask=None, *, num_windows: int = 1,
                             round_scores: bool = False) -> torch.Tensor:
    """Plain version of the attention core on (B, N, H, D). Scores
    ``(q·scale)·kᵀ`` in f32 (K8, K9); with ``round_scores`` (K6) q·scale is
    cast to the working type before the product and the scores after it.
    Then + rel_bias (H, N, N) (or (H, 1, 1)) and + the mask (nW, N, N) of
    each window position in f32, f32 softmax, P cast to V's type, P·V with
    f32 accumulation, one cast."""
    dtype = q.dtype
    b, n, h, _ = q.shape
    qs = q.float() * (1.0 / math.sqrt(q.shape[-1]))
    if round_scores:
        qs = qs.to(dtype).float()
    s = torch.einsum("bqhd,bkhd->bhqk", qs, k.float())
    if round_scores:
        s = s.to(dtype).float()
    if rel_bias is not None:
        s = s + rel_bias[None].float()
    if mask is not None:
        s = s.reshape(b // num_windows, num_windows, h, n, n) + mask[None, :, None].float()
        s = s.reshape(b, h, n, n)
    p = _softmax_f32(s).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p.float(), v.float()).to(dtype).contiguous()


@functools.lru_cache(maxsize=None)
def _launcher():
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    return build.bind("attention_core", "attention_core_launch",
                      [p] * 6 + [i] * 5 + [ll] * 4 + [f, f, i, i, p])


def _plane(t, shape, what: str, device) -> torch.Tensor | None:
    """A bias or mask as the kernel reads it: f32, contiguous, ``shape``
    (an (H, 1, 1) bias is broadcast to (H, N, N))."""
    if t is None:
        return None
    if t.ndim == 3 and t.shape[0] == shape[0] and t.shape[1:] == (1, 1):
        t = t.expand(shape)
    if tuple(t.shape) != shape:
        raise ValueError(f"{what} must be {shape}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{what} must be on {device}, not {t.device}")
    return t.float().contiguous()


def attention_core(q, k, v, rel_bias=None, mask=None, *, num_windows: int = 1,
                   round_scores: bool = False) -> torch.Tensor:
    """softmax(q·kᵀ/√D + rel_bias + mask)·v for q, k, v (B, N, H, D) of one
    type and one layout, contiguous over (H, D) and strided over tokens and
    images (the views of a packed q/k/v product qualify); rel_bias
    (H, N, N) or (H, 1, 1), mask (nW, N, N) with B a multiple of nW, both
    optional. ``round_scores`` takes K6's definition of the scores. Returns
    a contiguous (B, N, H, D). CPU tensors run the plain version."""
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must be one (B, N, H, D) shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, n, h, d = q.shape
    if mask is not None and b % num_windows:
        raise ValueError(f"{b} windows are not a multiple of num_windows {num_windows}")
    if q.device.type == "cpu":
        return attention_core_reference(q, k, v, rel_bias, mask, num_windows=num_windows,
                                        round_scores=round_scores)
    if q.dtype not in build.DTYPE_CODE:
        raise TypeError(f"q must be bfloat16 or float32, not {q.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head dim {HEAD_DIMS}, got {d}")
    if n > MAX_TOKENS:
        raise ValueError(f"the kernel holds at most {MAX_TOKENS} tokens, got {n}")
    for t, what in ((q, "q"), (k, "k"), (v, "v")):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{what} must be on {q.device} as {q.dtype}")
        if t.stride() != q.stride() or t.stride(3) != 1 or t.stride(2) != d:
            raise ValueError(f"{what} must be (B, N, H, D) with H·D contiguous and the "
                             f"strides of q, got {t.stride()}")
        build.check_aligned(t, what)
    bias = _plane(rel_bias, (h, n, n), "rel_bias", q.device)
    mask = _plane(mask, (num_windows, n, n), "mask", q.device)
    out = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    scale = 1.0 / math.sqrt(d)
    # where q is scaled (see attention_core.cu): bf16 K8/K9 scale the f32
    # product, f32 and K6 scale q before it
    pre = q.dtype == torch.float32 or round_scores
    q_scale, s_scale = (scale, 1.0) if pre else (1.0, scale)
    build.launch(_launcher(), q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 out.data_ptr(), None if bias is None else bias.data_ptr(),
                 None if mask is None else mask.data_ptr(), b, n, h, d, num_windows,
                 q.stride(1), q.stride(0), h * d, n * h * d, q_scale, s_scale,
                 int(round_scores), build.DTYPE_CODE[q.dtype])
    return out


def mha_reference(q, k, v) -> torch.Tensor:
    """Plain PyTorch version of :func:`mha`, the Pallas kernel's steps
    (``pallas_attention.py:26-40``): q·scale and scores in f32."""
    return attention_core_reference(q, k, v)


def mha(q, k, v) -> torch.Tensor:
    """K8: (B, N, H, D) q/k/v → (B, N, H, D) attention output. CUDA tensors
    run ``csrc/attention_core.cu`` (counted in ``mha.launches``); CPU
    tensors run the plain version."""
    if q.device.type == "cpu":
        return mha_reference(q, k, v)
    out = attention_core(q, k, v)
    mha.launches += 1
    return out


mha.launches = 0


def window_mha_reference(q, k, v, rel_bias, mask=None, *, num_windows: int = 1) -> torch.Tensor:
    """Plain PyTorch version of :func:`window_mha`, the Pallas kernel's
    steps (``pallas_attention.py:125-153``): q·scale and the scores in f32,
    + bias, + mask, f32 softmax, P cast to V's type."""
    return attention_core_reference(q, k, v, rel_bias, mask, num_windows=num_windows)


def window_mha(q, k, v, rel_bias, mask=None, *, num_windows: int = 1) -> torch.Tensor:
    """K9: Swin's window attention on q/k/v (B·nW, N, H, D), rel_bias
    (H, N, N) f32, mask (nW, N, N) f32 or None. CUDA tensors run
    ``csrc/attention_core.cu`` (counted in ``window_mha.launches``); CPU
    tensors run the plain version."""
    if q.device.type == "cpu":
        return window_mha_reference(q, k, v, rel_bias, mask, num_windows=num_windows)
    out = attention_core(q, k, v, rel_bias, mask, num_windows=num_windows)
    window_mha.launches += 1
    return out


window_mha.launches = 0


def window_block_reference(x, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, wp, bp,
                           rel_bias=None, mask=None, *, num_heads: int | None = None,
                           num_windows: int = 1, eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version of :func:`window_block`, step by step as the
    JAX reference (``pallas_attention.py:312-347``): LN cast to x's type,
    each branch product + bias in f32 and cast, ``(q·scale)`` cast, scores
    in the working type, + bias (and the mask of each window position) in
    f32, f32 softmax cast, P·V, proj + bias + x in f32, one cast.

    x: (B·nW, N, C); rel_bias (H, N, N) or (H, 1, 1); mask (nW, N, N)."""
    bnw, n, c = x.shape
    h = _heads(rel_bias, num_heads)
    d = c // h
    dtype = x.dtype
    xn = layer_norm_f32(x, ln_scale, ln_bias, eps).to(dtype)

    def branch(w, b):
        out = torch.matmul(xn.float(), w.to(dtype).float().t())
        if b is not None:
            out = out + b.float()
        return out.to(dtype).reshape(bnw, n, h, d)

    out = attention_core_reference(branch(wq, bq), branch(wk, bk), branch(wv, bv), rel_bias,
                                   mask, num_windows=num_windows, round_scores=True)
    y = torch.matmul(out.reshape(bnw, n, c).float(), wp.to(dtype).float().t()) + bp.float()
    return (x.float() + y).to(dtype)


def _heads(rel_bias, num_heads) -> int:
    if rel_bias is not None:
        if num_heads is not None and num_heads != rel_bias.shape[0]:
            raise ValueError(f"num_heads {num_heads} disagrees with rel_bias "
                             f"{tuple(rel_bias.shape)}")
        return rel_bias.shape[0]
    if num_heads is None:
        raise ValueError("num_heads is needed when rel_bias is None")
    return num_heads


def window_block(x, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, wp, bp, rel_bias=None,
                 mask=None, *, num_heads: int | None = None, num_windows: int = 1,
                 eps: float = 1e-5) -> torch.Tensor:
    """K6: ``x + proj(attn(LN(x)))`` for x (B·nW, N, C) in bf16 or f32,
    w{q,k,v,p} (C, C) of x's type in (out, in) layout, biases (C,) f32
    (bq/bk/bv may be None: no q/k/v bias), ``num_heads`` heads (or
    ``rel_bias.shape[0]``), rel_bias (H, N, N) or (H, 1, 1) and mask
    (nW, N, N) f32 or None.

    CUDA tensors concatenate the q/k/v weights and biases and run
    :func:`window_block_qkv`. CPU tensors run the plain version."""
    if x.device.type == "cpu":
        return window_block_reference(x, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, wp, bp,
                                      rel_bias, mask, num_heads=num_heads,
                                      num_windows=num_windows, eps=eps)
    b_qkv = None
    if any(t is not None for t in (bq, bk, bv)):
        zero = torch.zeros(x.shape[-1], dtype=torch.float32, device=x.device)
        b_qkv = torch.cat([zero if t is None else t.float() for t in (bq, bk, bv)])
    return window_block_qkv(x, ln_scale, ln_bias, torch.cat([wq, wk, wv]), b_qkv, wp, bp,
                            rel_bias, mask, num_heads=_heads(rel_bias, num_heads),
                            num_windows=num_windows, eps=eps)


window_block.launches = 0


def window_block_qkv(x, ln_scale, ln_bias, w_qkv, b_qkv, wp, bp, rel_bias=None, mask=None, *,
                     num_heads: int, num_windows: int = 1, eps: float = 1e-5) -> torch.Tensor:
    """K6 on the q/k/v weights packed (3C, C) and biases packed (3C,) (or
    None), as ``nn.Linear(C, 3C)`` holds them: the entry ViT's
    ``EncoderBlock`` and Swin's ``SwinBlock`` call, with no copy of the
    weights. CUDA tensors run :func:`fused_window_block`, counted once a
    call in ``window_block.launches``; CPU tensors run the plain version."""
    c = x.shape[-1]
    if tuple(w_qkv.shape) != (3 * c, c):
        raise ValueError(f"w_qkv must be {(3 * c, c)}, got {tuple(w_qkv.shape)}")
    if x.device.type == "cpu":
        wq, wk, wv = w_qkv.split(c)
        bq, bk, bv = (None,) * 3 if b_qkv is None else b_qkv.split(c)
        return window_block_reference(x, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, wp, bp,
                                      rel_bias, mask, num_heads=num_heads,
                                      num_windows=num_windows, eps=eps)
    out = fused_window_block(x, ln_scale, ln_bias, w_qkv, b_qkv, wp, bp, rel_bias, mask,
                             num_heads=num_heads, num_windows=num_windows, eps=eps)
    window_block.launches += 1
    return out


def fused_window_block(x, ln_scale, ln_bias, w_qkv, b_qkv, wp, bp, rel_bias=None, mask=None,
                       *, num_heads: int, num_windows: int = 1, eps: float) -> torch.Tensor:
    """The three launches of K6 on CUDA tensors: (a) ``linear_fused`` with
    the LN prologue over the packed q/k/v weights, (b) the attention core on
    the packed output's views with the bias and mask, q·scale and the
    scores rounded as the reference rounds them, (c) ``linear_fused`` with
    the proj weights and x as the residual. On CPU tensors, the plain
    version of each step: the tests check the composition there."""
    b, n, c = x.shape
    if b_qkv is None:
        b_qkv = torch.zeros(3 * c, dtype=torch.float32, device=x.device)
    x2 = x.reshape(b * n, c)
    qkv = linear_fused(x2, w_qkv.to(x.dtype), b_qkv.float(),
                       ln=(ln_scale.float(), ln_bias.float()), eps=eps)
    qkv = qkv.view(b, n, 3, num_heads, c // num_heads)
    attn = attention_core(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], rel_bias, mask,
                          num_windows=num_windows, round_scores=True)
    out = linear_fused(attn.view(b * n, c), wp.to(x.dtype), bp.float(), residual=x2)
    return out.view(b, n, c)
