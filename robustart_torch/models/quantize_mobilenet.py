"""int8 post-training quantization of MobileNetV2 for eval, and the
inverted-residual forward it shares with MobileNetV3 and EfficientNet.

Counterpart of ``robustart_tpu/models/quantize_mobilenet.py``. Every
convolution folds its BatchNorm (eps 1e-3) and runs int8 × int8 → int32,
the depthwise 3×3s on ``ops/quant.py``'s grouped route; ReLU6 runs in the
f32 epilogue; each block's output is requantized after the residual add,
the identity dequantized at the block input's scale; the head convolution
is int8 and the pooled features and the classifier f32. The 3×3/2 stem is
exact on the uint8 grid (``quantize.py``).

:func:`inverted_forward` is one forward for the three families, on a
:class:`Spec` that says each convolution's activation, each block's
squeeze-excite and the head: the expand convolution's output is
requantized, the depthwise output stays f32 through the squeeze-excite,
where there is one, and is requantized by the project convolution (V2
requantizes it at once; the values and the order of the sites are the
same).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from robustart_torch.models.layers import Act, hardswish
from robustart_torch.models.mobilenet import MobileNetV2
from robustart_torch.models.quantize_net import (
    Int8Ops,
    QuantizedNet,
    dense_entry,
    folded,
    linear,
    se_entry,
    squeeze_excite,
)
from robustart_torch.ops.image import div_const


def _hardswish(x: torch.Tensor) -> torch.Tensor:
    # x·relu6(x + 3)/6 as the jitted JAX forward computes it: the division
    # by the constant 6 is a product by its float32 reciprocal
    return div_const(x * F.relu6(x + 3.0), 6.0)


def _hardsigmoid(x: torch.Tensor) -> torch.Tensor:
    return div_const(F.relu6(x + 3.0), 6.0)


ACTS = {None: lambda x: x, "relu": F.relu, "relu6": F.relu6, "hs": _hardswish,
        "silu": F.silu, "sigmoid": torch.sigmoid, "hsigmoid": _hardsigmoid}


def act_name(cba) -> str | None:
    """The activation of a port ``conv_bn`` Sequential (an ``Act`` third
    child), as :data:`ACTS` names it."""
    if len(cba) < 3 or not isinstance(cba[2], Act):
        return None
    return {hardswish: "hs", torch.relu: "relu", F.relu6: "relu6", F.silu: "silu"}[cba[2].fn]


@dataclasses.dataclass(frozen=True)
class Conv:
    key: str  # the JAX key, e.g. "InvertedResidualV2_3/ConvBNAct_0"
    conv: str  # the port's convolution, e.g. "features.4.conv.0.0"
    bn: str  # and its BatchNorm
    stride: int
    pad: int
    groups: int
    act: str | None
    site_in: str


def conv_spec(key: str, path: str, cba, site: str) -> Conv:
    """The :class:`Conv` of a port ``conv_bn`` Sequential at ``path``."""
    conv = cba[0]
    return Conv(key, f"{path}.0", f"{path}.1", conv.stride[0], conv.padding[0], conv.groups,
                act_name(cba), site)


@dataclasses.dataclass(frozen=True)
class Block:
    name: str  # the JAX block key, e.g. "InvertedResidualV3_4"
    convs: tuple  # expand?, depthwise, project, in call order
    se: tuple | None  # (the port's SqueezeExcite path, act, gate) or None
    residual: bool
    site_in: str
    site_out: str


@dataclasses.dataclass(frozen=True)
class Spec:
    stem: Conv
    blocks: tuple
    head: Conv  # the head convolution, on the last block's output
    dense: tuple  # (key, act) of the f32 dense layers after the pool


def inverted_forward(ops: Int8Ops, spec: Spec, x: torch.Tensor) -> torch.Tensor:
    s = spec.stem
    x = ops.site("stem", ACTS[s.act](ops.stem(x, s.key, s.stride, s.pad)))
    for blk in spec.blocks:
        identity = x
        *body, project = blk.convs
        for j, c in enumerate(body):
            x = ACTS[c.act](ops.conv(x, c.key, c.stride, c.pad, c.groups, c.site_in))
            if j < len(body) - 1:  # expand → depthwise
                x = ops.site(body[j + 1].site_in, x)
        if blk.se is not None:
            x = squeeze_excite(x, ops.qp[f"{blk.name}/se"], ACTS[blk.se[1]], ACTS[blk.se[2]])
        x = ops.conv(ops.record(project.site_in, x), project.key, site=project.site_in)
        if blk.residual:
            x = x + (identity if ops.calib else
                     identity.float() * ops.qp["scale"][blk.site_in])
        x = ops.site(blk.site_out, x)
    h = spec.head
    x = ACTS[h.act](ops.conv(x, h.key, site=h.site_in)).mean(dim=(1, 2))
    for key, act in spec.dense:
        x = ACTS[act](linear(x, ops.qp[key]))
    return x


def inverted_qparams(module, spec: Spec) -> dict:
    """The float ``qparams`` of an inverted-residual model: every
    convolution and its BatchNorm folded, each squeeze-excite's 1×1s."""
    qp = {}
    for c in (spec.stem, *(c for b in spec.blocks for c in b.convs), spec.head):
        qp[c.key] = folded(module.get_submodule(c.conv), module.get_submodule(c.bn))
    for blk in spec.blocks:
        if blk.se is not None:
            se = module.get_submodule(blk.se[0])
            qp[f"{blk.name}/se"] = se_entry(se.fc1, se.fc2)
    return qp


def inverted_convs(spec: Spec) -> list:
    return [(c.key, c.groups) for c in (spec.stem, *(c for b in spec.blocks for c in b.convs),
                                        spec.head)]


def _spec(module: MobileNetV2) -> Spec:
    """JAX ``_v2_spec``: features.0 the stem, then the blocks, the last
    feature the head convolution."""
    feats = list(module.features.named_children())
    blocks, cur = [], "stem"
    for bi, (path, blk) in enumerate(feats[1:-1]):
        pre, layers = f"InvertedResidualV2_{bi}", len(blk.conv)
        convs, site = [], cur
        # [expand conv_bn]?, the depthwise conv_bn, then the project conv and its BN
        for ci in range(layers - 2):
            convs.append(conv_spec(f"{pre}/ConvBNAct_{ci}", f"features.{path}.conv.{ci}",
                                   blk.conv[ci], site))
            site = f"b{bi}.a{ci}"
        convs.append(Conv(f"{pre}/ConvBNAct_{layers - 2}", f"features.{path}.conv.{layers - 2}",
                          f"features.{path}.conv.{layers - 1}", 1, 0, 1, None, site))
        blocks.append(Block(pre, tuple(convs), None, blk.use_res, cur, f"b{bi}.out"))
        cur = f"b{bi}.out"
    return Spec(conv_spec("ConvBNAct_0", "features.0", feats[0][1], ""), tuple(blocks),
                conv_spec("ConvBNAct_1", f"features.{feats[-1][0]}", feats[-1][1], cur),
                (("classifier", None),))


@dataclasses.dataclass
class QuantizedMobileNetV2(QuantizedNet):
    """int8 eval-only MobileNetV2."""

    stem_key = "ConvBNAct_0"
    spec_of = staticmethod(_spec)
    conv_list = staticmethod(inverted_convs)
    forward_fn = staticmethod(inverted_forward)


@torch.no_grad()
def quantize_mobilenet_v2(clf, calib_images,
                          calib_batch_size: int = 64) -> QuantizedMobileNetV2:
    """Build the int8 eval path from a float MobileNetV2 :class:`Classifier`,
    on its device."""
    module = clf.model
    if not isinstance(module, MobileNetV2):
        raise ValueError(f"quantize_mobilenet_v2 supports MobileNetV2; got "
                         f"{type(module).__name__}")
    spec = _spec(module)
    qp = inverted_qparams(module, spec)
    qp["classifier"] = dense_entry(module.classifier[1])
    return QuantizedMobileNetV2.build(clf, qp, calib_images, calib_batch_size)
