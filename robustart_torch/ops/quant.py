"""int8 post-training-quantization primitives (counterpart of
``robustart_tpu/ops/quant.py``).

The recipe of the int8 eval path (:mod:`robustart_torch.models.quantize`,
``quantize_vit``, ``quantize_swin``): eval-mode BatchNorm folded into each
convolution, symmetric per-output-channel int8 weights, static per-tensor
activation scales from calibration amax, activations requantized by round
half to even (``torch.round``, as ``jnp.round``) and clamped to ±127.

Every product is int8 × int8 → int32 through ``torch._int_mm``: cuBLASLt's
int8 GEMM on CUDA, an exact integer product on the CPU. So the int32
accumulators equal the JAX package's ``preferred_element_type=int32``
convolutions and dots bit for bit, on either device:

- a 1×1 stride-1 convolution is one product on the (B·H·W, Cin) view; a
  strided 1×1 slices first;
- a k×k convolution builds its im2col with ``F.pad`` and ``Tensor.unfold``
  (``F.unfold`` refuses int8), the columns in HWIO order (kh, kw, cin);
- K is zero-padded to a multiple of 8 (:data:`K_ALIGN`; the stem's
  7·7·3 = 147 → 152), and on CUDA M to more than 16: cuBLASLt's int8
  GEMM takes nothing else, and the zeros add nothing to an int32 sum;
- ``groups > 1`` (ResNeXt) runs on a block-diagonal weight: exact for the
  same reason, at ``groups`` times the multiply-adds of the grouped
  convolution (the zeros are multiplied too).

The JAX package computes these in XLA (``lax.conv_general_dilated``,
``lax.dot_general``), not in a Pallas kernel: they are not a TPU kernel's
port. A convolution's int8 weight is HWIO, as the JAX package's, packed
once by :func:`pack_conv` into the (Cout, K) layout the product takes; a
dense layer's int8 weight is (N, K), nn.Linear's layout, which is that
layout already.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

K_ALIGN = 8  # cuBLASLt's int8 GEMM: K and N multiples of 8
MIN_ROWS = 17  # and M above 16


def fold_conv_bn(kernel, gamma, beta, mean, var, eps: float = 1e-5):
    """Fold an eval-mode BatchNorm into the bias-free convolution before it.

    kernel: (kh, kw, cin, cout) HWIO. Returns (folded_kernel, bias) with
    ``conv(x, folded) + bias == BN(conv(x, kernel))`` (in float)."""
    inv = gamma / torch.sqrt(var + eps)
    return kernel * inv, beta - mean * inv


def quantize_weight_per_channel(kernel: torch.Tensor, num_bits: int = 8):
    """Symmetric quantization per output channel, the last axis (an HWIO
    kernel, or a dense layer's (K, N)). Returns (w_int8, scale[cout]) with
    ``w ≈ w_int8 · scale``."""
    qmax = 2 ** (num_bits - 1) - 1
    amax = kernel.abs().amax(dim=tuple(range(kernel.ndim - 1)))
    scale = torch.clamp_min(amax, 1e-12) / qmax
    w_q = torch.clamp(torch.round(kernel / scale), -qmax, qmax)
    return w_q.to(torch.int8), scale


def requantize(x: torch.Tensor, inv_scale: float) -> torch.Tensor:
    """float activation → int8 at ``scale`` (x ≈ out·scale): round half to
    even, clamp to ±127."""
    return torch.clamp(torch.round(x * inv_scale), -127, 127).to(torch.int8)


def int_mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a (M, K) int8 · w (N, Kp)ᵀ int8 → (M, N) int32, with Kp ≥ K the
    weight's padded width (a is zero-padded to it). On CUDA, M ≤ 16 is
    padded with zero rows; N must be a multiple of 8 there."""
    m, k = a.shape
    if k != w.shape[1]:
        a = F.pad(a, (0, w.shape[1] - k))
    if a.device.type == "cuda" and m < MIN_ROWS:
        a = F.pad(a, (0, 0, 0, MIN_ROWS - m))
    return torch._int_mm(a.contiguous(), w.t())[:m]


def pack_conv(w: torch.Tensor, groups: int = 1) -> torch.Tensor:
    """An HWIO int8 kernel (kh, kw, cin/groups, cout) → the (cout, Kp)
    int8 matrix :func:`conv_i8_packed` multiplies by: K = kh·kw·cin in HWIO
    order, zero-padded to a multiple of :data:`K_ALIGN`; with ``groups > 1``
    block-diagonal over the groups."""
    kh, kw, cig, cout = w.shape
    if groups > 1:
        full = w.new_zeros((kh, kw, cig * groups, cout))
        og = cout // groups
        for g in range(groups):
            full[:, :, g * cig:(g + 1) * cig, g * og:(g + 1) * og] = w[..., g * og:(g + 1) * og]
        w = full
    k = kh * kw * w.shape[2]
    return F.pad(w.reshape(k, cout).t(), (0, -k % K_ALIGN)).contiguous()


def im2col(x: torch.Tensor, k: int, stride: int, padding: int, width: int) -> torch.Tensor:
    """(B, H, W, C) int8 → (B·Ho·Wo, width) int8 patches, each row
    (kh, kw, c)-ordered and zero-padded from k·k·C to ``width`` (the input
    zero-padded by ``padding``)."""
    if padding:
        x = F.pad(x, (0, 0, padding, padding, padding, padding))
    patches = x.unfold(1, k, stride).unfold(2, k, stride)  # (B, Ho, Wo, C, k, k)
    b, ho, wo, c = patches.shape[:4]
    cols = x.new_empty((b * ho * wo, width))
    kk = k * k * c
    if width > kk:
        cols[:, kk:] = 0
    cols[:, :kk].view(b, ho, wo, k, k, c).copy_(patches.permute(0, 1, 2, 4, 5, 3))
    return cols


def conv_i8_packed(x: torch.Tensor, w: torch.Tensor, k: int, stride: int = 1,
                   padding: int = 0) -> torch.Tensor:
    """int8 NHWC convolution → (B, Ho, Wo, Cout) int32 accumulators, on a
    kernel of size ``k`` packed by :func:`pack_conv`."""
    if k == 1 and padding == 0:
        if stride > 1:
            x = x[:, ::stride, ::stride]
        b, ho, wo, c = x.shape
        a = x.reshape(-1, c)
    else:
        a = im2col(x, k, stride, padding, w.shape[1])
        b = x.shape[0]
        ho = (x.shape[1] + 2 * padding - k) // stride + 1
        wo = (x.shape[2] + 2 * padding - k) // stride + 1
    return int_mm(a, w).view(b, ho, wo, -1)


def conv_i8(x: torch.Tensor, w: torch.Tensor, stride: int = 1, padding: int = 0,
            groups: int = 1) -> torch.Tensor:
    """int8 NHWC convolution with an int8 HWIO kernel → int32 accumulators
    (packs ``w`` on each call; a model packs once and calls
    :func:`conv_i8_packed`)."""
    return conv_i8_packed(x, pack_conv(w, groups), w.shape[0], stride, padding)


def maxpool_i8(x: torch.Tensor, window: int = 3, stride: int = 2,
               padding: int = 1) -> torch.Tensor:
    """3×3/2 max-pool on int8 NHWC, padded with −128 (the max is monotone,
    so it commutes with the requantize before it)."""
    x = F.pad(x, (0, 0, padding, padding, padding, padding), value=-128)
    return x.unfold(1, window, stride).unfold(2, window, stride).amax(dim=(-2, -1))


def ln_f32(x: torch.Tensor, p: dict, eps: float = 1e-6,
           out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """LayerNorm over the last axis with f32 statistics, var = E[(x − μ)²],
    ``p`` a ``{"scale", "bias"}`` dict: the transformer int8 families' LN,
    each with its model's eps (ViT 1e-6, Swin 1e-5)."""
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    y = (x - mu) / torch.sqrt(var + eps) * p["scale"] + p["bias"]
    return y.to(out_dtype)


def dense_i8(x_i8: torch.Tensor, entry: dict, s_in: float) -> torch.Tensor:
    """int8 × int8 → int32 dense over the last axis with per-output-channel
    dequant: ``(x_i8 · entry['w']ᵀ) · (s_in · entry['sw']) [+ entry['b']]``,
    ``entry['w']`` (N, K) int8; ``entry['b']`` may be None (Swin's patch
    merging)."""
    lead = x_i8.shape[:-1]
    y = int_mm(x_i8.reshape(-1, x_i8.shape[-1]), entry["w"]).float()
    y = y.view(*lead, -1) * (s_in * entry["sw"])
    b = entry.get("b")
    return y if b is None else y + b
