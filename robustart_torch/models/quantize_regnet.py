"""int8 post-training quantization of RegNetX and RegNetY for eval.

Counterpart of ``robustart_tpu/models/quantize_regnet.py``. Every
convolution folds its BatchNorm (eps 1e-5) and runs int8 × int8 → int32;
the grouped 3×3 (group width 8 to 72) takes ``ops/quant.py``'s grouped
route. RegNetY's squeeze-excite stays float32, and the activation it
scales is requantized before the last 1×1. The residual stream stays
float32: each block's input is requantized where a convolution reads it
(the projection's too), and the head runs on the float output of the last
block. The 3×3/2 stem is exact on the uint8 grid (``quantize.py``) and its
output stays float32.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from robustart_torch.models.quantize_net import (
    Int8Ops,
    QuantizedNet,
    dense_entry,
    folded,
    linear,
    se_entry,
    squeeze_excite,
)
from robustart_torch.models.regnet import RegNetX


@dataclasses.dataclass(frozen=True)
class _Block:
    name: str  # the JAX key, "s{i}_b{j}"
    path: str  # the port module's, "s{i}.b{j}"
    stride: int
    groups: int
    has_proj: bool
    has_se: bool
    site_in: str
    site_out: str


def _spec(module: RegNetX):
    """The blocks in forward order (JAX ``_regnet_spec``)."""
    blocks, cur = [], "stem"
    for si in range(module.num_stages):
        for path, blk in getattr(module, f"s{si + 1}").named_children():
            name = f"s{si + 1}_{path}"
            blocks.append(_Block(name, f"s{si + 1}.{path}", blk.f.b.stride[0], blk.f.b.groups,
                                 blk.proj is not None, blk.f.se is not None, cur,
                                 f"{name}.out"))
            cur = f"{name}.out"
    return tuple(blocks)


def _forward(ops: Int8Ops, blocks, x: torch.Tensor) -> torch.Tensor:
    x = F.relu(ops.stem(x, "stem_conv", 2, 1))
    ops.record("stem", x)
    for blk in blocks:
        pre = blk.name
        identity = x
        out = F.relu(ops.conv(x, f"{pre}/conv1", site=blk.site_in))
        out = ops.site(f"{pre}.a1", out)
        out = F.relu(ops.conv(out, f"{pre}/conv2", blk.stride, 1, blk.groups, f"{pre}.a1"))
        if blk.has_se:
            out = squeeze_excite(out, ops.qp[f"{pre}/se"], F.relu, torch.sigmoid)
        out = ops.site(f"{pre}.a2", out)
        out = ops.conv(out, f"{pre}/conv3", site=f"{pre}.a2")
        if blk.has_proj:
            identity = ops.conv(identity, f"{pre}/proj", blk.stride, site=blk.site_in)
        x = ops.record(blk.site_out, F.relu(out + identity))
    return linear(x.mean(dim=(1, 2)), ops.qp["fc"])


def _convs(blocks) -> list:
    out = [("stem_conv", 1)]
    for blk in blocks:
        out += [(f"{blk.name}/conv1", 1), (f"{blk.name}/conv2", blk.groups),
                (f"{blk.name}/conv3", 1)] + [(f"{blk.name}/proj", 1)] * blk.has_proj
    return out


@dataclasses.dataclass
class QuantizedRegNet(QuantizedNet):
    """int8 eval-only RegNetX/Y."""

    stem_key = "stem_conv"
    spec_of = staticmethod(_spec)
    conv_list = staticmethod(_convs)
    forward_fn = staticmethod(_forward)


@torch.no_grad()
def quantize_regnet(clf, calib_images, calib_batch_size: int = 64) -> QuantizedRegNet:
    """Build the int8 eval path from a float RegNetX/Y :class:`Classifier`,
    on its device."""
    module = clf.model
    if not isinstance(module, RegNetX):
        raise ValueError(f"quantize_regnet supports RegNetX/Y; got {type(module).__name__}")
    qp = {"stem_conv": folded(module.stem.conv, module.stem.bn),
          "fc": dense_entry(module.head.fc)}
    for blk in _spec(module):
        m = module.get_submodule(blk.path)
        for i, (conv, bn) in enumerate(((m.f.a, m.f.a_bn), (m.f.b, m.f.b_bn),
                                        (m.f.c, m.f.c_bn))):
            qp[f"{blk.name}/conv{i + 1}"] = folded(conv, bn)
        if blk.has_proj:
            qp[f"{blk.name}/proj"] = folded(m.proj, m.bn)
        if blk.has_se:
            qp[f"{blk.name}/se"] = se_entry(m.f.se.f_ex[0], m.f.se.f_ex[2])
    return QuantizedRegNet.build(clf, qp, calib_images, calib_batch_size)
