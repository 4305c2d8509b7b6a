"""int8 post-training quantization of EfficientNet (B0-B7 and the
``_nodrop`` variants) for eval.

Counterpart of ``robustart_tpu/models/quantize_efficientnet.py``, on
``quantize_mobilenet.py``'s inverted-residual forward: BatchNorm (eps 1e-3)
folded into every convolution, int8 × int8 → int32 products, the k×k
depthwise convolutions on ``ops/quant.py``'s grouped route, SiLU in the f32
epilogue. Every MBConv's squeeze-excite (SiLU, then the sigmoid gate) stays
f32, and the activation it scales is requantized by the project
convolution. The head convolution is int8 with SiLU, the pooled features
and the classifier f32. The 3×3/2 stem (SiLU) is exact on the uint8 grid
(``quantize.py``).
"""

from __future__ import annotations

import dataclasses

import torch

from robustart_torch.models.efficientnet import EfficientNet
from robustart_torch.models.quantize_mobilenet import (
    Spec,
    conv_spec,
    inverted_convs,
    inverted_forward,
    inverted_qparams,
)
from robustart_torch.models.quantize_mobilenet_v3 import inverted_blocks
from robustart_torch.models.quantize_net import QuantizedNet, dense_entry


def _spec(module: EfficientNet) -> Spec:
    """JAX ``_eff_spec``: features.0 the stem, the MBConvs of every stage
    numbered on, the last feature the head convolution."""
    feats = list(module.features.named_children())
    mbconvs = [(f"features.{p}.{i}", m) for p, stage in feats[1:-1]
               for i, m in enumerate(stage)]
    blocks, head_site = inverted_blocks(mbconvs, "MBConv", "_ConvBNSiLU", ("silu", "sigmoid"),
                                        lambda bi, se: f"b{bi}.se")
    return Spec(conv_spec("_ConvBNSiLU_0", "features.0", feats[0][1], ""), blocks,
                conv_spec("_ConvBNSiLU_1", f"features.{feats[-1][0]}", feats[-1][1], head_site),
                (("classifier", None),))


@dataclasses.dataclass
class QuantizedEfficientNet(QuantizedNet):
    """int8 eval-only EfficientNet."""

    stem_key = "_ConvBNSiLU_0"
    spec_of = staticmethod(_spec)
    conv_list = staticmethod(inverted_convs)
    forward_fn = staticmethod(inverted_forward)


@torch.no_grad()
def quantize_efficientnet(clf, calib_images,
                          calib_batch_size: int = 64) -> QuantizedEfficientNet:
    """Build the int8 eval path from a float EfficientNet :class:`Classifier`,
    on its device."""
    module = clf.model
    if not isinstance(module, EfficientNet):
        raise ValueError(f"quantize_efficientnet supports EfficientNet; got "
                         f"{type(module).__name__}")
    qp = inverted_qparams(module, _spec(module))
    qp["classifier"] = dense_entry(module.classifier[1])
    return QuantizedEfficientNet.build(clf, qp, calib_images, calib_batch_size)
