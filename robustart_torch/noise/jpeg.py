"""JPEG round trip as libjpeg's integer transcode, bit-exact against PIL.

Counterpart of ``robustart_tpu/noise/corruptions/jpeg_jax.py``. The
reference's jpeg_compression saves and reloads each image through PIL's JPEG
codec at quality ``QUALITY_BY_SEVERITY[severity - 1]``. Entropy coding is
lossless, so the pixels that come back are those of the transcode:

    RGB -> YCbCr (jccolor.c) -> 4:2:0 downsample (jcsample.c h2v2)
        -> per plane: level shift, islow integer FDCT (jfdctint.c),
           quantize (jcdctmgr.c), dequantize, islow integer IDCT (jidctint.c)
        -> 4:2:0 fancy upsample (jdsample.c h2v2_fancy_upsample)
        -> YCbCr -> RGB (jdcolor.c)

Every stage is libjpeg's fixed-point arithmetic in int32 tensors, on any
device. Sizes that are not multiples of 16 follow the codec's edges: the
encoder pads the image to the 16-pixel MCU grid by repeating its last row
and column, except that the chroma planes' bottom padding repeats the last
*downsampled* row; the decoder upsamples only the real ``ceil(H/2) ×
ceil(W/2)`` chroma region.

libjpeg computes in 32-bit integers; the largest intermediate here is about
8.3e8, 2.6× below 2^31. ``>>`` on a signed tensor is an arithmetic shift
and the quantizer's quotient truncates, as libjpeg's.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from robustart_torch.ops.image import div_const, on_device

# reference corruptions.py:375
QUALITY_BY_SEVERITY = (25, 18, 15, 10, 7)

# Annex K base tables in natural (row-major) order (jcparam.c
# std_luminance_quant_tbl / std_chrominance_quant_tbl)
_STD_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61,
    12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56,
    14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77,
    24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101,
    72, 92, 95, 98, 112, 100, 103, 99], np.int64).reshape(8, 8)
_STD_CHROMA = np.array([
    17, 18, 24, 47, 99, 99, 99, 99,
    18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99,
    47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99], np.int64).reshape(8, 8)


@functools.lru_cache(maxsize=None)
def quant_table(chroma: bool, quality: int) -> np.ndarray:
    """jcparam.c jpeg_quality_scaling + jpeg_add_quant_table: the (8, 8)
    int32 table of one plane at ``quality``."""
    base = _STD_CHROMA if chroma else _STD_LUMA
    quality = max(1, min(100, int(quality)))
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((base * scale + 50) // 100, 1, 255).astype(np.int32)


# jfdctint.c / jidctint.c fixed-point constants (CONST_BITS = 13)
_CB = 13  # CONST_BITS
_PB = 2   # PASS1_BITS
_F_0_298631336 = 2446
_F_0_390180644 = 3196
_F_0_541196100 = 4433
_F_0_765366865 = 6270
_F_0_899976223 = 7373
_F_1_175875602 = 9633
_F_1_501321110 = 12299
_F_1_847759065 = 15137
_F_1_961570560 = 16069
_F_2_053119869 = 16819
_F_2_562915447 = 20995
_F_3_072711026 = 25172


def _descale(x: torch.Tensor, n: int) -> torch.Tensor:
    """jpegint.h DESCALE: round to nearest by an arithmetic right shift."""
    return (x + (1 << (n - 1))) >> n


def _fdct_pass(d: torch.Tensor, first: bool) -> torch.Tensor:
    """One 1-D pass of jfdctint.c jpeg_fdct_islow over the last axis (8)."""
    d0, d1, d2, d3, d4, d5, d6, d7 = d.unbind(-1)
    tmp0 = d0 + d7; tmp7 = d0 - d7
    tmp1 = d1 + d6; tmp6 = d1 - d6
    tmp2 = d2 + d5; tmp5 = d2 - d5
    tmp3 = d3 + d4; tmp4 = d3 - d4
    tmp10 = tmp0 + tmp3; tmp13 = tmp0 - tmp3
    tmp11 = tmp1 + tmp2; tmp12 = tmp1 - tmp2
    if first:
        o0 = (tmp10 + tmp11) << _PB
        o4 = (tmp10 - tmp11) << _PB
        ds = _CB - _PB
    else:
        o0 = _descale(tmp10 + tmp11, _PB)
        o4 = _descale(tmp10 - tmp11, _PB)
        ds = _CB + _PB
    z1 = (tmp12 + tmp13) * _F_0_541196100
    o2 = _descale(z1 + tmp13 * _F_0_765366865, ds)
    o6 = _descale(z1 - tmp12 * _F_1_847759065, ds)
    z1 = tmp4 + tmp7; z2 = tmp5 + tmp6
    z3 = tmp4 + tmp6; z4 = tmp5 + tmp7
    z5 = (z3 + z4) * _F_1_175875602
    t4 = tmp4 * _F_0_298631336; t5 = tmp5 * _F_2_053119869
    t6 = tmp6 * _F_3_072711026; t7 = tmp7 * _F_1_501321110
    z1 = z1 * (-_F_0_899976223); z2 = z2 * (-_F_2_562915447)
    z3 = z3 * (-_F_1_961570560) + z5; z4 = z4 * (-_F_0_390180644) + z5
    o7 = _descale(t4 + z1 + z3, ds)
    o5 = _descale(t5 + z2 + z4, ds)
    o3 = _descale(t6 + z2 + z3, ds)
    o1 = _descale(t7 + z1 + z4, ds)
    return torch.stack([o0, o1, o2, o3, o4, o5, o6, o7], dim=-1)


def _idct_pass(d: torch.Tensor, first: bool) -> torch.Tensor:
    """One 1-D pass of jidctint.c jpeg_idct_islow over the last axis (8)."""
    d0, d1, d2, d3, d4, d5, d6, d7 = d.unbind(-1)
    z1 = (d2 + d6) * _F_0_541196100
    tmp2 = z1 + d6 * (-_F_1_847759065)
    tmp3 = z1 + d2 * _F_0_765366865
    tmp0 = (d0 + d4) << _CB
    tmp1 = (d0 - d4) << _CB
    t10 = tmp0 + tmp3; t13 = tmp0 - tmp3
    t11 = tmp1 + tmp2; t12 = tmp1 - tmp2
    tmp0 = d7; tmp1 = d5; tmp2 = d3; tmp3 = d1
    z1 = tmp0 + tmp3; z2 = tmp1 + tmp2
    z3 = tmp0 + tmp2; z4 = tmp1 + tmp3
    z5 = (z3 + z4) * _F_1_175875602
    tmp0 = tmp0 * _F_0_298631336; tmp1 = tmp1 * _F_2_053119869
    tmp2 = tmp2 * _F_3_072711026; tmp3 = tmp3 * _F_1_501321110
    z1 = z1 * (-_F_0_899976223); z2 = z2 * (-_F_2_562915447)
    z3 = z3 * (-_F_1_961570560) + z5; z4 = z4 * (-_F_0_390180644) + z5
    tmp0 = tmp0 + z1 + z3; tmp1 = tmp1 + z2 + z4
    tmp2 = tmp2 + z2 + z3; tmp3 = tmp3 + z1 + z4
    ds = (_CB - _PB) if first else (_CB + _PB + 3)
    o0 = _descale(t10 + tmp3, ds); o7 = _descale(t10 - tmp3, ds)
    o1 = _descale(t11 + tmp2, ds); o6 = _descale(t11 - tmp2, ds)
    o2 = _descale(t12 + tmp1, ds); o5 = _descale(t12 - tmp1, ds)
    o3 = _descale(t13 + tmp0, ds); o4 = _descale(t13 - tmp0, ds)
    return torch.stack([o0, o1, o2, o3, o4, o5, o6, o7], dim=-1)


def dct_roundtrip_plane(p: torch.Tensor, chroma: bool, quality: int) -> torch.Tensor:
    """FDCT → quantize → dequantize → IDCT of one plane: (..., H, W) int32
    samples 0..255, H and W multiples of 8, to the same clipped to 0..255."""
    *lead, h, w = p.shape
    b = p.reshape(*lead, h // 8, 8, w // 8, 8) - 128
    # FDCT pass 1 transforms each row (the last axis), pass 2 each column (-3)
    b = _fdct_pass(b, True)
    b = _fdct_pass(b.transpose(-3, -1), False).transpose(-3, -1)
    # quantize (jcdctmgr.c): divisor q << 3, rounded half away from zero
    q = on_device(p.device, quant_table, chroma, quality)[:, None, :]
    qq = q << 3
    r = torch.div(b.abs() + (qq >> 1), qq, rounding_mode="trunc")
    b = torch.where(b < 0, -r, r) * q
    # IDCT pass 1 = columns, pass 2 = rows (jidctint.c)
    b = _idct_pass(b.transpose(-3, -1), True).transpose(-3, -1)
    b = _idct_pass(b, False) + 128
    return torch.clamp(b.reshape(*lead, h, w), 0, 255)


_SCALEBITS = 16
_ONE_HALF = 1 << (_SCALEBITS - 1)
_CBCR_OFF = 128 << _SCALEBITS


def _fix(x: float) -> int:
    return int(x * (1 << _SCALEBITS) + 0.5)


def rgb_to_ycc(rgb: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """jccolor.c rgb_ycc_convert of (..., 3) int32: the (...) Y, Cb, Cr."""
    r, g, b = rgb.unbind(-1)
    y = (_fix(0.29900) * r + _fix(0.58700) * g + _fix(0.11400) * b
         + _ONE_HALF) >> _SCALEBITS
    cb = (-_fix(0.16874) * r - _fix(0.33126) * g + _fix(0.50000) * b
          + _CBCR_OFF + _ONE_HALF - 1) >> _SCALEBITS
    cr = (_fix(0.50000) * r - _fix(0.41869) * g - _fix(0.08131) * b
          + _CBCR_OFF + _ONE_HALF - 1) >> _SCALEBITS
    return y, cb, cr


def ycc_to_rgb(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor) -> torch.Tensor:
    """jdcolor.c ycc_rgb_convert: (...) Y, Cb, Cr → (..., 3) in 0..255."""
    cb = cb - 128
    cr = cr - 128
    r = y + ((_fix(1.40200) * cr + _ONE_HALF) >> _SCALEBITS)
    b = y + ((_fix(1.77200) * cb + _ONE_HALF) >> _SCALEBITS)
    g = y + ((-_fix(0.34414) * cb - _fix(0.71414) * cr + _ONE_HALF) >> _SCALEBITS)
    return torch.clamp(torch.stack([r, g, b], dim=-1), 0, 255)


def h2v2_down(p: torch.Tensor) -> torch.Tensor:
    """jcsample.c h2v2_downsample: the 2 × 2 sum of (..., H, W), biased 1
    and 2 in turn along a row, over 4."""
    *lead, h, w = p.shape
    q = p.reshape(*lead, h // 2, 2, w // 2, 2).sum((-3, -1), dtype=torch.int32)
    bias = 1 + (torch.arange(w // 2, device=p.device, dtype=torch.int32) % 2)
    return (q + bias) >> 2


def h2v2_fancy_up(p: torch.Tensor) -> torch.Tensor:
    """jdsample.c h2v2_fancy_upsample: the integer triangle filter, (..., h,
    w) → (..., 2h, 2w), with the first and last rows and columns special at
    the plane's boundary (callers pass the real chroma region)."""
    *lead, h, w = p.shape
    near = torch.repeat_interleave(p, 2, dim=-2)
    far_even = torch.cat([p[..., :1, :], p[..., :-1, :]], dim=-2)
    far_odd = torch.cat([p[..., 1:, :], p[..., -1:, :]], dim=-2)
    far = torch.stack([far_even, far_odd], dim=-2).reshape(*lead, 2 * h, w)
    cs = 3 * near + far  # the column sums
    left = torch.cat([cs[..., :1], cs[..., :-1]], dim=-1)
    right = torch.cat([cs[..., 1:], cs[..., -1:]], dim=-1)
    even = (3 * cs + left + 8) >> 4
    odd = (3 * cs + right + 7) >> 4
    even = torch.cat([(cs[..., :1] * 4 + 8) >> 4, even[..., 1:]], dim=-1)
    odd = torch.cat([odd[..., :-1], (cs[..., -1:] * 4 + 7) >> 4], dim=-1)
    return torch.stack([even, odd], dim=-1).reshape(*lead, 2 * h, 2 * w)


def pad_edge_2d(p: torch.Tensor, h_to: int, w_to: int) -> torch.Tensor:
    """Pad the last two axes to (h_to, w_to) by repeating the last row and
    column."""
    h, w = p.shape[-2:]
    rows = torch.arange(h_to, device=p.device).clamp_max(h - 1)
    cols = torch.arange(w_to, device=p.device).clamp_max(w - 1)
    return p.index_select(-2, rows).index_select(-1, cols)


def jpeg_roundtrip_u8(rgb: torch.Tensor, quality: int) -> torch.Tensor:
    """The pixels of a JPEG save and load at ``quality``: (..., H, W, 3)
    integer samples 0..255 → int32 samples 0..255, bitwise those of
    ``np.asarray(Image.open(saved_jpeg))``."""
    rgb = rgb.to(torch.int32)
    h, w = rgb.shape[-3:-1]
    h16, w16 = -(-h // 16) * 16, -(-w // 16) * 16
    ch, cw = -(-h // 2), -(-w // 2)  # the real downsampled chroma size

    # the encoder pads the input to the MCU grid by edge replication
    rgbp = pad_edge_2d(rgb.movedim(-1, -3), h16, w16).movedim(-3, -1)
    y, cb, cr = rgb_to_ycc(rgbp)
    y2 = dct_roundtrip_plane(y, False, quality)[..., :h, :w]
    chans = []
    for c in (cb, cr):
        cd = h2v2_down(c)  # (..., h16 / 2, w16 / 2)
        if ch < h16 // 2:
            # the bottom chroma padding repeats the last downsampled row
            cd = pad_edge_2d(cd[..., :ch, :], h16 // 2, w16 // 2)
        c2 = dct_roundtrip_plane(cd, True, quality)[..., :ch, :cw]
        chans.append(h2v2_fancy_up(c2)[..., :h, :w])
    return ycc_to_rgb(y2, chans[0], chans[1])


def jpeg_compression(x: torch.Tensor, severity: int = 1, *, generator=None) -> torch.Tensor:
    """The reference's JPEG round trip of a batch (B, H, W, 3) of [0, 1]
    images, deterministic (``generator`` unused). ``round(x·255)`` recovers
    each uint8 level exactly from ``level / 255`` in float32.

    The levels come back through :func:`div_const`, the JAX package's
    ``/ 255.0`` as XLA compiles it, so the image is bitwise the JAX
    package's; ``floor(·255)`` of it gives back every level.
    """
    u8 = torch.round(x * 255.0).to(torch.int32)
    out = jpeg_roundtrip_u8(u8, QUALITY_BY_SEVERITY[severity - 1])
    return div_const(out.to(torch.float32), 255.0)
