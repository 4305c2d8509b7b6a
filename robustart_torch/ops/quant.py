"""int8 post-training-quantization primitives (counterpart of
``robustart_tpu/ops/quant.py``).

The recipe of the int8 eval path (:mod:`robustart_torch.models.quantize`
and the ``models/quantize_*.py`` of the other families): eval-mode
BatchNorm folded into each convolution, symmetric per-output-channel int8
weights, static per-tensor activation scales from calibration amax,
activations requantized by round half to even (``torch.round``, as
``jnp.round``) and clamped to ±127.

Every product is int8 × int8 → int32 through ``torch._int_mm``: cuBLASLt's
int8 GEMM on CUDA, an exact integer product on the CPU. So the int32
accumulators equal the JAX package's ``preferred_element_type=int32``
convolutions and dots bit for bit, on either device:

- a 1×1 stride-1 convolution is one product on the (B·H·W, Cin) view; a
  strided 1×1 slices first;
- a k×k convolution builds its im2col with ``F.pad`` and ``Tensor.unfold``
  (``F.unfold`` refuses int8), the columns in HWIO order (kh, kw, cin);
- K and N are zero-padded to multiples of 8 (:data:`K_ALIGN`: the stem's
  7·7·3 = 147 → 152, the Mixer's 196 tokens → 200, ShuffleNetV2 x2.0's 244
  and 122 channels), and on CUDA M to more than 16: cuBLASLt's int8 GEMM
  takes nothing else, the zeros add nothing to an int32 sum, and the
  padded outputs are sliced off. An (N, K) that cuBLASLt has no kernel
  for is computed with N padded further (:func:`int_mm`).

A grouped convolution (``groups > 1``: ResNeXt, RegNet, and the depthwise
convolutions of MobileNet, EfficientNet and ShuffleNet) takes one of two
routes (:func:`pack_conv`):

- ``"grouped"``, where k²·(Cin/groups)·127² < 2²⁴ (:func:`grouped_exact`):
  a float32 grouped convolution of the int8 values (cuDNN on CUDA, TF32
  off). Every product and every partial sum is then an integer below 2²⁴,
  exact in float32 in any order of summation, so the result as int32
  equals the int32 accumulators bitwise, at the work of the grouped
  convolution;
- ``"product"`` otherwise: one product on a block-diagonal weight, exact
  for the same reason as any product, at ``groups`` times the
  multiply-adds of the grouped convolution and ``groups`` times its
  im2col bytes (a depthwise convolution at 112², B = 128, would need
  several hundred MB).

The JAX package computes these in XLA (``lax.conv_general_dilated``,
``lax.dot_general``), not in a Pallas kernel: they are not a TPU kernel's
port. A convolution's int8 weight is HWIO, as the JAX package's, packed
once by :func:`pack_conv` into the form :func:`conv_i8_packed` takes; a
dense layer's int8 weight is (N, K), nn.Linear's layout, which is that
layout already.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

K_ALIGN = 8  # cuBLASLt's int8 GEMM: K and N multiples of 8
MIN_ROWS = 17  # and M above 16
# and for a few (N, K) it has no kernel at all (on the H100: N = 72 at K = 32,
# RegNetY-3200M's first 1×1); those take N padded to a multiple of this
N_REFUSED_ALIGN = 32
EXACT_F32 = 2 ** 24  # integers below it are exact in float32


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
    """a (M, K) int8 · w (N, Kw)ᵀ int8 → (M, N) int32, with Kw ≥ K (a is
    zero-padded to it). Kw and N are zero-padded to multiples of
    :data:`K_ALIGN` where they are not (the padded outputs sliced off), and
    on CUDA M ≤ 16 with zero rows. A shape cuBLASLt refuses
    (``CUBLAS_STATUS_NOT_SUPPORTED``: it has no kernel for it) is computed
    again with N zero-padded to a multiple of :data:`N_REFUSED_ALIGN`: the
    same integers, one more call."""
    m, k = a.shape
    n, kw = w.shape
    if kw % K_ALIGN or n % K_ALIGN:
        w = F.pad(w, (0, -kw % K_ALIGN, 0, -n % K_ALIGN))
    if k != w.shape[1]:
        a = F.pad(a, (0, w.shape[1] - k))
    if a.device.type == "cuda" and m < MIN_ROWS:
        a = F.pad(a, (0, 0, 0, MIN_ROWS - m))
    a = a.contiguous()
    try:
        out = torch._int_mm(a, w.t())
    except RuntimeError as exc:
        if "CUBLAS_STATUS_NOT_SUPPORTED" not in str(exc) or w.shape[0] % N_REFUSED_ALIGN == 0:
            raise
        w = F.pad(w, (0, 0, 0, -w.shape[0] % N_REFUSED_ALIGN))
        out = torch._int_mm(a, w.t())
    out = out[:m]
    return out if w.shape[0] == n else out[:, :n]


def grouped_exact(k: int, cin_per_group: int) -> bool:
    """True where a k×k convolution over ``cin_per_group`` int8 channels a
    group keeps every partial sum below 2²⁴ in magnitude (|x|, |w| ≤ 127),
    so that float32 computes it exactly."""
    return k * k * cin_per_group * 127 * 127 < EXACT_F32


@dataclasses.dataclass
class PackedConv:
    """An int8 convolution's weight in the form its route takes: for
    ``"product"`` the (Cout, Kp) int8 matrix, for ``"grouped"`` the OIHW
    float32 kernel of the int8 values."""

    k: int
    groups: int
    route: str
    weight: torch.Tensor


def pack_conv(w: torch.Tensor, groups: int = 1, route: str | None = None) -> PackedConv:
    """An HWIO int8 kernel (kh, kw, cin/groups, cout) → its
    :class:`PackedConv`. ``route`` (default: ``"grouped"`` where ``groups >
    1`` and :func:`grouped_exact`, else ``"product"``): ``"product"`` packs
    the (cout, Kp) int8 matrix, K = kh·kw·cin in HWIO order zero-padded to
    a multiple of :data:`K_ALIGN`, block-diagonal over the groups where
    ``groups > 1``; ``"grouped"`` keeps the OIHW float32 kernel."""
    kh, kw, cig, cout = w.shape
    if route is None:
        route = "grouped" if groups > 1 and grouped_exact(kh, cig) else "product"
    if route == "grouped":
        if not grouped_exact(kh, cig):
            raise ValueError(f"a {kh}x{kw} convolution over {cig} channels a group is not "
                             "exact in float32")
        return PackedConv(kh, groups, route, w.permute(3, 2, 0, 1).float().contiguous())
    if route != "product":
        raise ValueError(f"unknown route {route!r}")
    if groups > 1:
        full = w.new_zeros((kh, kw, cig * groups, cout))
        og = cout // groups
        for g in range(groups):
            full[:, :, g * cig:(g + 1) * cig, g * og:(g + 1) * og] = w[..., g * og:(g + 1) * og]
        w = full
    k = kh * kw * w.shape[2]
    return PackedConv(kh, groups, route,
                      F.pad(w.reshape(k, cout).t(), (0, -k % K_ALIGN)).contiguous())


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


def conv_i8_packed(x: torch.Tensor, p: PackedConv, stride: int = 1,
                   padding: int = 0) -> torch.Tensor:
    """int8 NHWC convolution → (B, Ho, Wo, Cout) int32 accumulators, on a
    kernel packed by :func:`pack_conv`."""
    if p.route == "grouped":
        # exact in float32 (grouped_exact) on a direct or implicit-GEMM
        # algorithm, TF32 off; cuDNN's heuristics pick one (no autotuning,
        # which may pick an FFT), and round() takes back any error below half
        # a level
        with torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled, benchmark=False,
                                        deterministic=True, allow_tf32=False):
            y = F.conv2d(x.permute(0, 3, 1, 2).float(), p.weight, None, stride, padding,
                         groups=p.groups)
        return torch.round(y).to(torch.int32).permute(0, 2, 3, 1)
    k = p.k
    if k == 1 and padding == 0:
        if stride > 1:
            x = x[:, ::stride, ::stride]
        b, ho, wo, c = x.shape
        a = x.reshape(-1, c)
    else:
        a = im2col(x, k, stride, padding, p.weight.shape[1])
        b = x.shape[0]
        ho = (x.shape[1] + 2 * padding - k) // stride + 1
        wo = (x.shape[2] + 2 * padding - k) // stride + 1
    return int_mm(a, p.weight).reshape(b, ho, wo, -1)


def conv_i8(x: torch.Tensor, w: torch.Tensor, stride: int = 1, padding: int = 0,
            groups: int = 1, route: str | None = None) -> torch.Tensor:
    """int8 NHWC convolution with an int8 HWIO kernel → int32 accumulators
    (packs ``w`` on each call, on ``route`` as :func:`pack_conv` picks it; a
    model packs once and calls :func:`conv_i8_packed`)."""
    return conv_i8_packed(x, pack_conv(w, groups, route), stride, padding)


def maxpool_i8(x: torch.Tensor, window: int = 3, stride: int = 2,
               padding: int = 1) -> torch.Tensor:
    """3×3/2 max-pool on int8 NHWC, padded with −128 (the max is monotone,
    so it commutes with the requantize before it)."""
    x = F.pad(x, (0, 0, padding, padding, padding, padding), value=-128)
    return x.unfold(1, window, stride).unfold(2, window, stride).amax(dim=(-2, -1))


def ln_f32(x: torch.Tensor, p: dict, eps: float = 1e-6,
           out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """LayerNorm over the last axis with f32 statistics, var = E[(x − μ)²],
    ``p`` a ``{"scale", "bias"}`` dict: the int8 families' LN, each with its
    model's eps (ViT, ConvNeXt, Mixer 1e-6, Swin 1e-5)."""
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
    y = y.reshape(*lead, -1) * (s_in * entry["sw"])
    b = entry.get("b")
    return y if b is None else y + b
