"""int8 post-training quantization of DenseNet for eval.

Counterpart of ``robustart_tpu/models/quantize_densenet.py``. DenseNet is
pre-activation (BN → ReLU → conv), so no BatchNorm folds into a
convolution after the stem: each unit's BN affine ``a·x + c`` and ReLU run
in f32, their output is the requantize site, and the convolution (1×1 or
3×3, no bias) runs int8 × int8 → int32 with an f32 dequant. The
concatenations, the transitions' 2×2 average pools and ``norm5`` stay f32.
The stem (conv0 + norm0, 7×7/2) folds exactly and is exact on the uint8
grid (``quantize.py``); its max-pool runs on int8.

The float DenseNet's dense-block kernel K12 (``ops/densenet.py``) is not on
this path: the JAX int8 forward computes its own convolutions, and so does
this one.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from robustart_torch.models.densenet import DenseNet
from robustart_torch.models.quantize_net import (
    Int8Ops,
    QuantizedNet,
    bn_affine,
    dense_entry,
    folded,
    hwio,
    linear,
)
from robustart_torch.ops.quant import maxpool_i8


@dataclasses.dataclass(frozen=True)
class _Unit:
    """One BN → ReLU → conv unit."""

    key: str  # the JAX key, e.g. "denseblock1_layer1/_BNReLUConv_0"
    norm: str  # the port's BatchNorm and convolution
    conv: str
    pad: int
    site: str  # the requantize site at the convolution's input


def _spec(module: DenseNet):
    """(name, unit, unit or None) groups in forward order: a dense layer's
    two units, or a transition's one (JAX ``_dn_spec``)."""
    groups = []
    for bi, n_layers in enumerate(module.block_config):
        for li in range(n_layers):
            pre = f"denseblock{bi + 1}_layer{li + 1}"
            path = f"features.denseblock{bi + 1}.denselayer{li + 1}"
            groups.append((pre, _Unit(f"{pre}/_BNReLUConv_0", f"{path}.norm1", f"{path}.conv1",
                                      0, f"{pre}.c1"),
                           _Unit(f"{pre}/_BNReLUConv_1", f"{path}.norm2", f"{path}.conv2", 1,
                                 f"{pre}.c2")))
        if bi != len(module.block_config) - 1:
            name, path = f"transition{bi + 1}", f"features.transition{bi + 1}"
            groups.append((name, _Unit(name, f"{path}.norm", f"{path}.conv", 0, f"{name}.c"),
                           None))
    return tuple(groups)


def _avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """2×2/2 average pool of NHWC x, as the JAX forward's ``reduce_window``
    sum (row-major over the window) times 0.25."""
    h, w = x.shape[1] // 2 * 2, x.shape[2] // 2 * 2
    x = x[:, :h, :w]
    return (x[:, 0::2, 0::2] + x[:, 0::2, 1::2] + x[:, 1::2, 0::2] + x[:, 1::2, 1::2]) * 0.25


def _forward(ops: Int8Ops, groups, x: torch.Tensor) -> torch.Tensor:
    def unit(x, u):
        e = ops.qp[u.key]
        y = ops.record(u.site, F.relu(x * e["a"] + e["c"]))
        return ops.conv(y, u.key, 1, u.pad, site=u.site)

    y = F.relu(ops.stem(x, "stem", 2, 3))
    if ops.calib:
        x = ops.record("stem", F.max_pool2d(y.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1))
    else:
        x = maxpool_i8(ops.site("stem", y)).float() * ops.qp["scale"]["stem"]
    for _, first, second in groups:
        if second is None:  # transition
            x = _avg_pool2(unit(x, first))
        else:  # dense layer
            x = torch.cat([x, unit(unit(x, first), second)], dim=-1)
    e = ops.qp["norm5"]
    return linear(F.relu(x * e["a"] + e["c"]).mean(dim=(1, 2)), ops.qp["classifier"])


def _convs(groups) -> list:
    return [("stem", 1)] + [(u.key, 1) for g in groups for u in g[1:] if u is not None]


@dataclasses.dataclass
class QuantizedDenseNet(QuantizedNet):
    """int8 eval-only DenseNet."""

    spec_of = staticmethod(_spec)
    conv_list = staticmethod(_convs)
    forward_fn = staticmethod(_forward)


@torch.no_grad()
def quantize_densenet(clf, calib_images, calib_batch_size: int = 64) -> QuantizedDenseNet:
    """Build the int8 eval path from a float DenseNet :class:`Classifier`,
    on its device."""
    module = clf.model
    if not isinstance(module, DenseNet):
        raise ValueError(f"quantize_densenet supports DenseNet; got {type(module).__name__}")
    f = module.features
    qp = {"stem": folded(f.conv0, f.norm0), "norm5": bn_affine(f.norm5),
          "classifier": dense_entry(module.classifier)}
    for group in _spec(module):
        for u in group[1:]:
            if u is not None:
                qp[u.key] = {**bn_affine(module.get_submodule(u.norm)),
                             "w": hwio(module.get_submodule(u.conv))}
    return QuantizedDenseNet.build(clf, qp, calib_images, calib_batch_size)
