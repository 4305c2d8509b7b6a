"""RegNetX and RegNetY (pycls flop regimes 200M-6.4G).

Counterpart of ``robustart_tpu/models/regnet.py``: ``generate_widths`` (the
quantized-linear width rule), the X block (1×1, grouped 3×3, 1×1, projection
where the stride or width changes) with RegNetY's squeeze-excite on the
block's input width, BatchNorm eps 1e-5, and every name of ``PARAMS``.
Module names follow pycls (``stem.{conv,bn}``, ``sS.bB.f.{a,a_bn,b,b_bn,
se.f_ex.0,se.f_ex.2,c,c_bn}``, ``sS.bB.{proj,bn}``, ``head.fc``), as the JAX
package's ``torch_convert.py:328-355`` names them.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from robustart_torch.models.layers import ConvNet

BN_EPS = 1e-5


def generate_widths(w0: float, wa: float, wm: float, depth: int, group_w: int):
    """Per-stage (widths, depths) from the RegNet u_j = w0 + wa·j rule."""
    ks = np.round(np.log((w0 + wa * np.arange(depth)) / w0) / np.log(wm))
    widths = w0 * np.power(wm, ks)
    widths = np.round(widths / 8) * 8
    # adjust to group width compatibility
    widths = [int(min(group_w, w) * round(w / min(group_w, w))) for w in widths]
    stage_widths, stage_depths = [], []
    for w in widths:
        if stage_widths and stage_widths[-1] == w:
            stage_depths[-1] += 1
        else:
            stage_widths.append(w)
            stage_depths.append(1)
    return stage_widths, stage_depths


class SE(nn.Module):
    """pycls's squeeze-excite: ``f_ex`` = conv, ReLU, conv, sigmoid."""

    def __init__(self, channels: int, squeeze: int):
        super().__init__()
        self.f_ex = nn.Sequential(nn.Conv2d(channels, squeeze, 1), nn.ReLU(),
                                  nn.Conv2d(squeeze, channels, 1), nn.Sigmoid())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.f_ex(x.mean(dim=(2, 3), keepdim=True))


class BottleneckTransform(nn.Module):
    """pycls's ``f``: a, b (grouped, strided), [se], c with their norms."""

    def __init__(self, w_in: int, w_out: int, stride: int, group_width: int,
                 se_ratio: float):
        super().__init__()
        groups = max(1, w_out // group_width)
        self.a = nn.Conv2d(w_in, w_out, 1, bias=False)
        self.a_bn = nn.BatchNorm2d(w_out, eps=BN_EPS)
        self.b = nn.Conv2d(w_out, w_out, 3, stride, 1, groups=groups, bias=False)
        self.b_bn = nn.BatchNorm2d(w_out, eps=BN_EPS)
        # SE on the block input width (pycls convention)
        self.se = SE(w_out, max(1, int(round(w_in * se_ratio)))) if se_ratio > 0 else None
        self.c = nn.Conv2d(w_out, w_out, 1, bias=False)
        self.c_bn = nn.BatchNorm2d(w_out, eps=BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.a_bn(self.a(x)))
        x = torch.relu(self.b_bn(self.b(x)))
        if self.se is not None:
            x = self.se(x)
        return self.c_bn(self.c(x))


class XBlock(nn.Module):
    def __init__(self, w_in: int, w_out: int, stride: int, group_width: int,
                 se_ratio: float = 0.0):
        super().__init__()
        self.f = BottleneckTransform(w_in, w_out, stride, group_width, se_ratio)
        self.proj = self.bn = None
        if stride != 1 or w_in != w_out:
            self.proj = nn.Conv2d(w_in, w_out, 1, stride, bias=False)
            self.bn = nn.BatchNorm2d(w_out, eps=BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.proj is None else self.bn(self.proj(x))
        return torch.relu(self.f(x) + identity)


class Stem(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(3, 32, 3, 2, 1, bias=False)
        self.bn = nn.BatchNorm2d(32, eps=BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.bn(self.conv(x)))


class Head(nn.Module):
    def __init__(self, w_in: int, num_classes: int):
        super().__init__()
        self.fc = nn.Linear(w_in, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc(x)


class RegNetX(ConvNet):
    """RegNetX, or RegNetY with ``se_ratio`` > 0."""

    HEAD = ("head",)

    def __init__(self, w0: float, wa: float, wm: float, depth: int, group_width: int,
                 num_classes: int = 1000, se_ratio: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stem = Stem()
        widths, depths = generate_widths(w0, wa, wm, depth, group_width)
        w_in = 32
        self.num_stages = len(widths)
        for si, (w, d) in enumerate(zip(widths, depths)):
            stage = nn.Module()
            for bi in range(d):
                stage.add_module(f"b{bi + 1}", XBlock(w_in, w, 2 if bi == 0 else 1,
                                                      group_width, se_ratio))
                w_in = w
            self.add_module(f"s{si + 1}", stage)
        self.head = Head(w_in, num_classes)
        self.finish(dtype, num_classes)

    def body(self, x):
        x = self.stem(x)
        for si in range(self.num_stages):
            for block in getattr(self, f"s{si + 1}").children():
                x = block(x)
        return x

    def classify(self, x):
        return self.head(x)


# pycls RegNetX/Y flop-regime parameters (Y adds SE with ratio 0.25)
PARAMS = {
    "regnetx_400m": dict(w0=24, wa=24.48, wm=2.54, depth=22, group_width=16),
    "regnetx_800m": dict(w0=56, wa=35.73, wm=2.28, depth=16, group_width=16),
    "regnetx_1600m": dict(w0=80, wa=34.01, wm=2.25, depth=18, group_width=24),
    "regnetx_3200m": dict(w0=88, wa=26.31, wm=2.25, depth=25, group_width=48),
    "regnetx_4000m": dict(w0=96, wa=38.65, wm=2.43, depth=23, group_width=40),
    "regnetx_6400m": dict(w0=184, wa=60.83, wm=2.07, depth=17, group_width=56),
    "regnety_200m": dict(w0=24, wa=36.44, wm=2.49, depth=13, group_width=8, se_ratio=0.25),
    "regnety_400m": dict(w0=48, wa=27.89, wm=2.09, depth=16, group_width=8, se_ratio=0.25),
    "regnety_600m": dict(w0=48, wa=32.54, wm=2.32, depth=15, group_width=16, se_ratio=0.25),
    "regnety_800m": dict(w0=56, wa=38.84, wm=2.4, depth=14, group_width=16, se_ratio=0.25),
    "regnety_1600m": dict(w0=48, wa=20.71, wm=2.65, depth=27, group_width=24, se_ratio=0.25),
    "regnety_3200m": dict(w0=80, wa=42.63, wm=2.66, depth=21, group_width=24, se_ratio=0.25),
    "regnety_4000m": dict(w0=96, wa=31.41, wm=2.24, depth=22, group_width=64, se_ratio=0.25),
    "regnety_6400m": dict(w0=112, wa=33.22, wm=2.27, depth=25, group_width=72, se_ratio=0.25),
}


def _make(name: str):
    def factory(**kw):
        kw.pop("bn", None)
        return RegNetX(**PARAMS[name], **kw)

    return factory


REGNET_FACTORIES = {name: _make(name) for name in PARAMS}
