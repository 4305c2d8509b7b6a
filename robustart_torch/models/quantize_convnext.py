"""int8 post-training quantization of ConvNeXt (V1 and V2) for eval.

Counterpart of ``robustart_tpu/models/quantize_convnext.py``. The pointwise
MLPs (pwconv1, pwconv2), the 2×2/2 downsample convolutions and the 4×4
stem run int8 × int8 → int32; V1's LayerScale γ is folded into pwconv2
before its weights are quantized; V2's GRN, the GELUs, the LayerNorms and
the residual adds stay float, bf16 where the JAX package's int8 forward
keeps them in bf16. The stem is exact on the uint8 grid (``quantize.py``).

Each block's 7×7 depthwise convolution + LayerNorm stays float, bf16 in and
out, as in the JAX package (which computes it by its XLA reference,
``dwconv_ln_reference``): here it is kernel K11, ``ops/convnext.py::
dwconv_ln`` (``csrc/dwconv_ln.cu``) on CUDA tensors and its plain version
on the CPU, the same function in f32 arithmetic (K11 does not round the
convolution to bf16 before the LayerNorm, as the JAX reference does).
Calibration runs the plain version in float32, as the JAX package's runs
its reference.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from robustart_torch.models.convnext import ConvNeXt
from robustart_torch.models.quantize_net import (
    Int8Ops,
    QuantizedNet,
    biased,
    dense_entry,
    linear,
)
from robustart_torch.models.quantize_vit import norm_entry
from robustart_torch.ops.convnext import dwconv_ln, dwconv_ln_reference
from robustart_torch.ops.quant import ln_f32

LN_EPS = 1e-6


def _grn(x: torch.Tensor, p: dict) -> torch.Tensor:
    """ConvNeXt-V2's GRN in f32 on NHWC x, the result in x's type (JAX
    ``quantize_convnext.py::_grn``)."""
    xf = x.float()
    gx = torch.sqrt((xf * xf).sum(dim=(1, 2), keepdim=True) + 1e-12)
    nx = gx / (gx.mean(dim=-1, keepdim=True) + 1e-6)
    return (p["gamma"] * (xf * nx) + p["beta"] + xf).to(x.dtype)


def _spec(module: ConvNeXt):
    """(depths, use_grn)."""
    return tuple(len(stage) for stage in module.stages), module.stages[0][0].grn is not None


def _forward(ops: Int8Ops, spec, x: torch.Tensor) -> torch.Tensor:
    depths, use_grn = spec
    qp = ops.qp
    adt = torch.float32 if ops.calib else torch.bfloat16
    x = ln_f32(ops.stem(x, "stem_conv", 4, 0), qp["stem_norm"], LN_EPS, adt)
    for si, depth in enumerate(depths):
        if si > 0:
            # downsample: LN, then the 2×2/2 convolution (int8: requantized after the LN)
            site = f"down{si}_in"
            y = ops.record(site, ln_f32(x, qp[f"downsample_norm{si}"], LN_EPS))
            x = ops.conv(y, f"downsample_conv{si}", 2, site=site).to(adt)
        for di in range(depth):
            pre = f"stage{si}_block{di}"
            dw, nrm = qp[f"{pre}/dwconv"], qp[f"{pre}/norm"]
            y = (dwconv_ln_reference if ops.calib else dwconv_ln)(
                x, dw["w"], dw["b"], nrm["scale"], nrm["bias"], LN_EPS)
            h = F.gelu(ops.dense(y, f"{pre}.fc1_in", f"{pre}/pwconv1", adt)).to(adt)
            if use_grn:
                h = _grn(h, qp[f"{pre}/grn"])
            # pwconv2 carries V1's folded LayerScale γ
            x = x + ops.dense(h, f"{pre}.fc2_in", f"{pre}/pwconv2", adt)
    x = ln_f32(x.float().mean(dim=(1, 2)), qp["head_norm"], LN_EPS)
    return linear(x, qp["head"])


def _convs(spec) -> list:
    return [("stem_conv", 1)] + [(f"downsample_conv{si}", 1) for si in range(1, len(spec[0]))]


def _dense(spec) -> list:
    return [f"stage{si}_block{di}/pwconv{j}" for si, depth in enumerate(spec[0])
            for di in range(depth) for j in (1, 2)]


@dataclasses.dataclass
class QuantizedConvNeXt(QuantizedNet):
    """int8 eval-only ConvNeXt (V1 and V2)."""

    stem_key = "stem_conv"
    spec_of = staticmethod(_spec)
    conv_list = staticmethod(_convs)
    dense_list = staticmethod(_dense)
    forward_fn = staticmethod(_forward)


@torch.no_grad()
def quantize_convnext(clf, calib_images, calib_batch_size: int = 64) -> QuantizedConvNeXt:
    """Build the int8 eval path from a float ConvNeXt :class:`Classifier`
    (V1, V2, ``convnext_base_cvst``), on its device."""
    module = clf.model
    if not isinstance(module, ConvNeXt):
        raise ValueError(f"quantize_convnext supports ConvNeXt; got {type(module).__name__}")
    (stem, stem_norm), *downs = module.downsample_layers
    qp = {"stem_conv": biased(stem), "stem_norm": norm_entry(stem_norm),
          "head_norm": norm_entry(module.norm), "head": dense_entry(module.head)}
    for si, (norm, down) in enumerate(downs, start=1):
        qp[f"downsample_norm{si}"] = norm_entry(norm)
        qp[f"downsample_conv{si}"] = biased(down)
    for si, stage in enumerate(module.stages):
        for di, blk in enumerate(stage):
            pre = f"stage{si}_block{di}"
            qp[f"{pre}/dwconv"] = {"w": blk.dwconv.weight.detach().float(),
                                   "b": blk.dwconv.bias.detach().float()}
            qp[f"{pre}/norm"] = norm_entry(blk.norm)
            qp[f"{pre}/pwconv1"] = dense_entry(blk.pwconv1)
            fc2 = dense_entry(blk.pwconv2)
            if blk.grn is None and blk.gamma is not None:
                # fold the LayerScale into pwconv2 (exact in float)
                g = blk.gamma.detach().float()
                fc2 = {"w": fc2["w"] * g[:, None], "b": fc2["b"] * g}
            qp[f"{pre}/pwconv2"] = fc2
            if blk.grn is not None:
                qp[f"{pre}/grn"] = {"gamma": blk.grn.gamma.detach().float().reshape(-1),
                                    "beta": blk.grn.beta.detach().float().reshape(-1)}
    return QuantizedConvNeXt.build(clf, qp, calib_images, calib_batch_size)
