"""EfficientNet B0-B7 and the reference's ``_nodrop`` variants.

Counterpart of ``robustart_tpu/models/efficientnet.py``: the compound-scaling
table ``SCALING`` (width, depth, input size, dropout), the base blocks,
MBConv with squeeze-excite on the input width (SiLU, sigmoid gate), BatchNorm
eps 1e-3, drop-path the identity at eval. Module names follow torchvision
(``features.0`` stem, ``features.S.I.block.J`` MBConvs, ``features.8``
head conv, ``classifier.1``) as the JAX package's ``torch_convert.py:268-326``
names them, so its checkpoints load through ``saver.pretrain`` as they are.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from robustart_torch.models.layers import ConvNet, DropPath, conv_bn
from robustart_torch.models.mobilenet import SqueezeExcite, make_divisible

BN_EPS = 1e-3

# (width_mult, depth_mult, resolution, dropout)
SCALING = {
    "b0": (1.0, 1.0, 224, 0.2),
    "b1": (1.0, 1.1, 240, 0.2),
    "b2": (1.1, 1.2, 260, 0.3),
    "b3": (1.2, 1.4, 300, 0.3),
    "b4": (1.4, 1.8, 380, 0.4),
    "b5": (1.6, 2.2, 456, 0.4),
    "b6": (1.8, 2.6, 528, 0.5),
    "b7": (2.0, 3.1, 600, 0.5),
}

# base (expand, channels, repeats, stride, kernel)
BASE_BLOCKS = (
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
)


def _cbs(cin, cout, kernel=1, stride=1, groups=1, act=F.silu):
    return conv_bn(cin, cout, kernel, stride, groups, BN_EPS, act)


class MBConv(nn.Module):
    def __init__(self, inp: int, features: int, kernel: int, stride: int, expand_ratio: int,
                 se_ratio: float = 0.25, drop_path: float = 0.0):
        super().__init__()
        hidden = inp * expand_ratio
        layers = [_cbs(inp, hidden)] if expand_ratio != 1 else []
        layers += [_cbs(hidden, hidden, kernel, stride, hidden),
                   SqueezeExcite(hidden, max(1, int(inp * se_ratio)), torch.sigmoid, F.silu),
                   _cbs(hidden, features, act=None)]
        self.block = nn.Sequential(*layers)
        self.use_res = stride == 1 and inp == features
        self.drop_path = DropPath(drop_path)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.block(x)
        return self.drop_path(out) + x if self.use_res else out


class EfficientNet(ConvNet):
    HEAD = ("classifier",)

    def __init__(self, width_mult: float = 1.0, depth_mult: float = 1.0,
                 num_classes: int = 1000, dropout: float = 0.2, drop_path: float = 0.2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.width_mult, self.depth_mult = width_mult, depth_mult

        def c(ch):
            return make_divisible(ch * width_mult)

        def d(n):
            return int(math.ceil(n * depth_mult))

        total = sum(d(r) for _, _, r, _, _ in BASE_BLOCKS)
        cin = c(32)
        stages = [_cbs(3, cin, 3, 2)]
        bi = 0
        for expand, ch, repeats, stride, kernel in BASE_BLOCKS:
            blocks = []
            for i in range(d(repeats)):
                blocks.append(MBConv(cin, c(ch), kernel, stride if i == 0 else 1, expand,
                                     drop_path=drop_path * bi / max(total - 1, 1)))
                cin = c(ch)
                bi += 1
            stages.append(nn.Sequential(*blocks))
        stages.append(_cbs(cin, c(1280)))
        self.features = nn.Sequential(*stages)
        self.classifier = nn.Sequential(nn.Dropout(dropout), nn.Linear(c(1280), num_classes))
        self.finish(dtype, num_classes)

    def body(self, x):
        return self.features(x)

    def classify(self, x):
        return self.classifier(x)


def _efficientnet(variant: str, nodrop: bool = False, **kw):
    kw.pop("bn", None)
    w, dep, _res, drop = SCALING[variant]
    if nodrop:
        kw.setdefault("dropout", 0.0)
        kw.setdefault("drop_path", 0.0)
    else:
        kw.setdefault("dropout", drop)
    return EfficientNet(width_mult=w, depth_mult=dep, **kw)


def _make(variant: str, nodrop: bool):
    def factory(**kw):
        return _efficientnet(variant, nodrop, **kw)

    return factory


EFFICIENTNET_FACTORIES = {}
for _v in SCALING:
    EFFICIENTNET_FACTORIES[f"efficientnet_{_v}"] = _make(_v, False)
    EFFICIENTNET_FACTORIES[f"efficientnet_{_v}_nodrop"] = _make(_v, True)
