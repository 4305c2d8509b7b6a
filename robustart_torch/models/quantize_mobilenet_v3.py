"""int8 post-training quantization of MobileNetV3 (large and small) for
eval.

Counterpart of ``robustart_tpu/models/quantize_mobilenet_v3.py``, on
``quantize_mobilenet.py``'s inverted-residual forward: BatchNorm (eps 1e-3)
folded into every convolution, int8 × int8 → int32 products, the k×k
depthwise convolutions on ``ops/quant.py``'s grouped route, each block's
hardswish or ReLU in the f32 epilogue. The squeeze-excite (ReLU, then the
hardsigmoid gate) stays f32, and the activation it scales is requantized by
the project convolution; a block without one requantizes the depthwise
output there. The head convolution is int8 with hardswish; the pooled
features, ``pre_classifier`` + hardswish and the classifier are f32. The
3×3/2 stem (hardswish) is exact on the uint8 grid (``quantize.py``).
"""

from __future__ import annotations

import dataclasses

import torch

from robustart_torch.models.mobilenet import MobileNetV3, SqueezeExcite
from robustart_torch.models.quantize_mobilenet import (
    Block,
    Spec,
    conv_spec,
    inverted_convs,
    inverted_forward,
    inverted_qparams,
)
from robustart_torch.models.quantize_net import QuantizedNet, dense_entry


def inverted_blocks(feats, prefix: str, conv_prefix: str, se_acts: tuple, proj_site):
    """:class:`Block` specs of a port model's inverted-residual blocks
    (``(path, module)`` pairs, each module's ``block`` its conv_bn layers
    with an optional :class:`SqueezeExcite` before the last), named as the
    JAX package names them: ``{prefix}_{i}`` and its ``{conv_prefix}_{j}``,
    counting the conv_bn layers only. ``proj_site(i, has_se)`` names the
    project convolution's input site."""
    blocks, cur = [], "stem"
    for bi, (path, blk) in enumerate(feats):
        pre = f"{prefix}_{bi}"
        cbas = [(f"{path}.block.{j}", m) for j, m in enumerate(blk.block)
                if not isinstance(m, SqueezeExcite)]
        ses = [f"{path}.block.{j}" for j, m in enumerate(blk.block)
               if isinstance(m, SqueezeExcite)]
        convs, site = [], cur
        for ci, (cpath, cba) in enumerate(cbas[:-1]):
            convs.append(conv_spec(f"{pre}/{conv_prefix}_{ci}", cpath, cba, site))
            site = f"b{bi}.a{ci}"
        n = len(cbas) - 1
        convs.append(conv_spec(f"{pre}/{conv_prefix}_{n}", cbas[-1][0], cbas[-1][1],
                               proj_site(bi, bool(ses))))
        se = (ses[0], *se_acts) if ses else None
        blocks.append(Block(pre, tuple(convs), se, blk.use_res, cur, f"b{bi}.out"))
        cur = f"b{bi}.out"
    return tuple(blocks), cur


def _spec(module: MobileNetV3) -> Spec:
    """JAX ``_v3_spec``: features.0 the stem, then the blocks, the last
    feature the head convolution; ``pre_classifier`` (hardswish) and the
    classifier after the pool."""
    feats = [(f"features.{p}", m) for p, m in module.features.named_children()]
    blocks, head_site = inverted_blocks(
        feats[1:-1], "InvertedResidualV3", "ConvBNAct", ("relu", "hsigmoid"),
        lambda bi, se: f"b{bi}.se" if se else f"b{bi}.dw")
    return Spec(conv_spec("ConvBNAct_0", *feats[0], ""), blocks,
                conv_spec("ConvBNAct_1", *feats[-1], head_site),
                (("pre_classifier", "hs"), ("classifier", None)))


@dataclasses.dataclass
class QuantizedMobileNetV3(QuantizedNet):
    """int8 eval-only MobileNetV3."""

    stem_key = "ConvBNAct_0"
    spec_of = staticmethod(_spec)
    conv_list = staticmethod(inverted_convs)
    forward_fn = staticmethod(inverted_forward)


@torch.no_grad()
def quantize_mobilenet_v3(clf, calib_images,
                          calib_batch_size: int = 64) -> QuantizedMobileNetV3:
    """Build the int8 eval path from a float MobileNetV3 :class:`Classifier`,
    on its device."""
    module = clf.model
    if not isinstance(module, MobileNetV3):
        raise ValueError(f"quantize_mobilenet_v3 supports MobileNetV3; got "
                         f"{type(module).__name__}")
    qp = inverted_qparams(module, _spec(module))
    qp["pre_classifier"] = dense_entry(module.classifier[0])
    qp["classifier"] = dense_entry(module.classifier[3])
    return QuantizedMobileNetV3.build(clf, qp, calib_images, calib_batch_size)
