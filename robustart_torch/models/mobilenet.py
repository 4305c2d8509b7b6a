"""MobileNetV2 and MobileNetV3 (large and small), width-scaled.

Counterpart of ``robustart_tpu/models/mobilenet.py``: the same layer tables,
``make_divisible`` widths, BatchNorm eps 1e-3, ``hardswish`` and the
squeeze-excite gate ``hardsigmoid`` as x·relu6(x + 3)/6 and relu6(x + 3)/6.
Module names follow torchvision (``features.N`` with ``.conv`` in a V2
block and ``.block`` in a V3 block, ``classifier``), so torchvision's
``mobilenet_v2`` and ``mobilenet_v3_large``/``_small`` checkpoints load as
they are (at scale 1.0, where the widths agree) and ``models/convert.py``
maps the JAX package's variables onto the same keys (V2 as the JAX package's
``torch_convert.py:114-145`` names it).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from robustart_torch.models.layers import Act, ConvNet, conv_bn, hardsigmoid, hardswish

BN_EPS = 1e-3


def make_divisible(v: float, divisor: int = 8, min_value: int | None = None) -> int:
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def _cba(cin, cout, kernel=1, stride=1, groups=1, act=F.relu6):
    return conv_bn(cin, cout, kernel, stride, groups, BN_EPS, act)


class InvertedResidualV2(nn.Module):
    def __init__(self, inp: int, features: int, stride: int, expand_ratio: int):
        super().__init__()
        hidden = int(round(inp * expand_ratio))
        layers = [_cba(inp, hidden)] if expand_ratio != 1 else []
        layers += [_cba(hidden, hidden, 3, stride, hidden),
                   nn.Conv2d(hidden, features, 1, bias=False),
                   nn.BatchNorm2d(features, eps=BN_EPS)]
        self.conv = nn.Sequential(*layers)
        self.use_res = stride == 1 and inp == features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv(x)
        return out + x if self.use_res else out


class MobileNetV2(ConvNet):
    HEAD = ("classifier",)
    SETTINGS = (  # t, c, n, s
        (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
        (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1),
    )

    def __init__(self, scale: float = 1.0, num_classes: int = 1000, dropout: float = 0.2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        cin = make_divisible(32 * scale)
        last = make_divisible(1280 * max(1.0, scale))
        layers = [_cba(3, cin, 3, 2)]
        for t, c, n, s in self.SETTINGS:
            cout = make_divisible(c * scale)
            for i in range(n):
                layers.append(InvertedResidualV2(cin, cout, s if i == 0 else 1, t))
                cin = cout
        layers.append(_cba(cin, last))
        self.features = nn.Sequential(*layers)
        self.classifier = nn.Sequential(nn.Dropout(dropout), nn.Linear(last, num_classes))
        self.finish(dtype, num_classes)

    def body(self, x):
        return self.features(x)

    def classify(self, x):
        return self.classifier(x)


class SqueezeExcite(nn.Module):
    """torchvision's ``SqueezeExcitation``: ``fc1``, ReLU (or ``act``),
    ``fc2``, then the gate over the channels of x."""

    def __init__(self, channels: int, squeeze: int, gate=hardsigmoid, act=torch.relu):
        super().__init__()
        self.fc1 = nn.Conv2d(channels, squeeze, 1)
        self.fc2 = nn.Conv2d(squeeze, channels, 1)
        self.gate = gate
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(2, 3), keepdim=True)
        return x * self.gate(self.fc2(self.act(self.fc1(s))))


class InvertedResidualV3(nn.Module):
    def __init__(self, inp: int, kernel: int, expanded: int, features: int, use_se: bool,
                 use_hs: bool, stride: int):
        super().__init__()
        act = hardswish if use_hs else torch.relu
        layers = [_cba(inp, expanded, act=act)] if expanded != inp else []
        layers.append(_cba(expanded, expanded, kernel, stride, expanded, act))
        if use_se:
            layers.append(SqueezeExcite(expanded, make_divisible(expanded // 4)))
        layers.append(_cba(expanded, features, act=None))
        self.block = nn.Sequential(*layers)
        self.use_res = stride == 1 and inp == features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.block(x)
        return out + x if self.use_res else out


# (kernel, expansion, out, SE, HS, stride): torchvision's mobilenet_v3 tables
V3_LARGE = (
    (3, 16, 16, False, False, 1), (3, 64, 24, False, False, 2),
    (3, 72, 24, False, False, 1), (5, 72, 40, True, False, 2),
    (5, 120, 40, True, False, 1), (5, 120, 40, True, False, 1),
    (3, 240, 80, False, True, 2), (3, 200, 80, False, True, 1),
    (3, 184, 80, False, True, 1), (3, 184, 80, False, True, 1),
    (3, 480, 112, True, True, 1), (3, 672, 112, True, True, 1),
    (5, 672, 160, True, True, 2), (5, 960, 160, True, True, 1),
    (5, 960, 160, True, True, 1),
)
V3_SMALL = (
    (3, 16, 16, True, False, 2), (3, 72, 24, False, False, 2),
    (3, 88, 24, False, False, 1), (5, 96, 40, True, True, 2),
    (5, 240, 40, True, True, 1), (5, 240, 40, True, True, 1),
    (5, 120, 48, True, True, 1), (5, 144, 48, True, True, 1),
    (5, 288, 96, True, True, 2), (5, 576, 96, True, True, 1),
    (5, 576, 96, True, True, 1),
)


class MobileNetV3(ConvNet):
    HEAD = ("classifier",)

    def __init__(self, scale: float = 1.0, mode: str = "large", num_classes: int = 1000,
                 dropout: float = 0.2, dtype: torch.dtype = torch.float32):
        super().__init__()
        large = mode == "large"
        cin = make_divisible(16 * scale)
        layers = [_cba(3, cin, 3, 2, act=hardswish)]
        for k, exp, out, se, hs, stride in (V3_LARGE if large else V3_SMALL):
            cout = make_divisible(out * scale)
            layers.append(InvertedResidualV3(cin, k, make_divisible(exp * scale), cout, se, hs,
                                             stride))
            cin = cout
        last_conv = make_divisible((960 if large else 576) * scale)
        hidden = make_divisible((1280 if large else 1024) * max(1.0, scale))
        layers.append(_cba(cin, last_conv, act=hardswish))
        self.features = nn.Sequential(*layers)
        self.classifier = nn.Sequential(nn.Linear(last_conv, hidden), Act(hardswish),
                                        nn.Dropout(dropout), nn.Linear(hidden, num_classes))
        self.finish(dtype, num_classes)

    def body(self, x):
        return self.features(x)

    def classify(self, x):
        return self.classifier(x)


def mobilenet_v2(**kw):
    kw.pop("bn", None)
    return MobileNetV2(**kw)


def mobilenet_v3(**kw):
    kw.pop("bn", None)
    return MobileNetV3(**kw)


def mobilenet_v3_named(mode: str, scale: float):
    """The registry's ``mobilenet_v3_{mode}_x{scale}`` names, dropout 0 by
    default (JAX ``registry.py:146-153``)."""

    def factory(**kw):
        kw.pop("bn", None)
        kw.setdefault("dropout", 0.0)
        return MobileNetV3(mode=mode, scale=scale, **kw)

    return factory
