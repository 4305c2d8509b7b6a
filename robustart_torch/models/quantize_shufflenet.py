"""int8 post-training quantization of ShuffleNetV2 for eval.

Counterpart of ``robustart_tpu/models/quantize_shufflenet.py``. Every
convolution folds its BatchNorm (eps 1e-5) and runs int8 × int8 → int32,
the depthwise 3×3s on ``ops/quant.py``'s grouped route. The tensor between
units is int8 at one per-tensor scale, so the channel split is free; the
branches' outputs are f32 (a stride-1 unit's passed-through half
dequantized), concatenated and shuffled in the JAX module's NHWC order
(:func:`channel_shuffle`), and requantized once per unit. The 3×3/2 stem is
exact on the uint8 grid (``quantize.py``) and its max-pool runs on int8.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from robustart_torch.models.quantize_net import (
    Int8Ops,
    QuantizedNet,
    dense_entry,
    folded,
    linear,
)
from robustart_torch.models.shufflenet import ShuffleNetV2
from robustart_torch.ops.quant import maxpool_i8


def channel_shuffle(x: torch.Tensor, groups: int = 2) -> torch.Tensor:
    """The JAX package's NHWC ``channel_shuffle``: channel g·(C/groups) + i
    becomes channel i·groups + g."""
    b, h, w, c = x.shape
    return x.reshape(b, h, w, groups, c // groups).transpose(3, 4).reshape(b, h, w, c)


@dataclasses.dataclass(frozen=True)
class _Unit:
    name: str  # the JAX key, e.g. "stage2_0"
    path: str  # the port's, e.g. "stage2.0"
    stride: int
    features: int
    cin: int
    site_in: str


def _spec(module: ShuffleNetV2):
    units, cur = [], "stem"
    for stage in (2, 3, 4):
        for i, unit in enumerate(getattr(module, f"stage{stage}")):
            name = f"stage{stage}_{i}"
            cin = unit.branch2[0].in_channels * (2 if unit.stride == 1 else 1)
            units.append(_Unit(name, f"stage{stage}.{i}", unit.stride,
                               unit.branch2[-2].num_features * 2, cin, cur))
            cur = name
    return tuple(units)


def _pairs(seq: nn.Sequential) -> list:
    """(conv, BatchNorm) pairs of a flat torchvision branch, in order."""
    mods = list(seq)
    return [(m, mods[i + 1]) for i, m in enumerate(mods) if isinstance(m, nn.Conv2d)]


def _maxpool_f32(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)


def _forward(ops: Int8Ops, units, x: torch.Tensor) -> torch.Tensor:
    y = F.relu(ops.stem(x, "_ConvBN_0", 2, 1))
    if ops.calib:
        a = ops.record("stem", _maxpool_f32(y))
    else:
        a = maxpool_i8(ops.site("stem", y))
    for u in units:
        bf, nm = u.features // 2, u.name

        def conv(t, i, site, stride=1, groups=1):
            return ops.conv(t, f"{nm}/_ConvBN_{i}", stride, 1 if groups > 1 else 0, groups,
                            site)

        if u.stride == 1:
            half = a.shape[-1] // 2
            x1, x2 = a[..., :half], a[..., half:]
            t = ops.site(f"{nm}.a0", F.relu(conv(x2, 0, u.site_in)))
            t = ops.site(f"{nm}.d", conv(t, 1, f"{nm}.a0", 1, bf))
            out2 = F.relu(conv(t, 2, f"{nm}.d"))
            x1 = x1 if ops.calib else x1.float() * ops.qp["scale"][u.site_in]
            out = torch.cat([x1, out2], dim=-1)
        else:
            t1 = ops.site(f"{nm}.d1", conv(a, 0, u.site_in, 2, u.cin))
            out1 = F.relu(conv(t1, 1, f"{nm}.d1"))
            t2 = ops.site(f"{nm}.a0", F.relu(conv(a, 2, u.site_in)))
            t2 = ops.site(f"{nm}.d", conv(t2, 3, f"{nm}.a0", 2, bf))
            out2 = F.relu(conv(t2, 4, f"{nm}.d"))
            out = torch.cat([out1, out2], dim=-1)
        a = ops.site(nm, channel_shuffle(out, 2))
    y = ops.record("conv5", F.relu(ops.conv(a, "_ConvBN_1", site=units[-1].name)))
    return linear(y.mean(dim=(1, 2)), ops.qp["fc"])


def _convs(units) -> list:
    out = [("_ConvBN_0", 1), ("_ConvBN_1", 1)]
    for u in units:
        groups = ([1, u.features // 2, 1] if u.stride == 1 else
                  [u.cin, 1, 1, u.features // 2, 1])
        out += [(f"{u.name}/_ConvBN_{i}", g) for i, g in enumerate(groups)]
    return out


@dataclasses.dataclass
class QuantizedShuffleNet(QuantizedNet):
    """int8 eval-only ShuffleNetV2."""

    stem_key = "_ConvBN_0"
    spec_of = staticmethod(_spec)
    conv_list = staticmethod(_convs)
    forward_fn = staticmethod(_forward)


@torch.no_grad()
def quantize_shufflenet(clf, calib_images, calib_batch_size: int = 64) -> QuantizedShuffleNet:
    """Build the int8 eval path from a float ShuffleNetV2 :class:`Classifier`,
    on its device."""
    module = clf.model
    if not isinstance(module, ShuffleNetV2):
        raise ValueError(f"quantize_shufflenet expects ShuffleNetV2; got "
                         f"{type(module).__name__}")
    qp = {"_ConvBN_0": folded(*module.conv1[:2]), "_ConvBN_1": folded(*module.conv5[:2]),
          "fc": dense_entry(module.fc)}
    for u in _spec(module):
        unit = module.get_submodule(u.path)
        pairs = ([] if unit.branch1 is None else _pairs(unit.branch1)) + _pairs(unit.branch2)
        for i, (conv, bn) in enumerate(pairs):
            qp[f"{u.name}/_ConvBN_{i}"] = folded(conv, bn)
    return QuantizedShuffleNet.build(clf, qp, calib_images, calib_batch_size)
