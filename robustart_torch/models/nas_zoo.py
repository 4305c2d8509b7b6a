"""The NAS-derived zoo names (bignas / oneshot_supcell / dmcp / dmna /
crnas / resnet18c): width-scaled ResNet-18 stand-ins.

Counterpart of ``robustart_tpu/models/nas_zoo.py``. The reference's exact
NAS cells are not recoverable, so the JAX package defines stand-ins, and
the port copies them: ``crnas_resnet{18,50,101}c`` and
``resnet18c_x{0_125,0_25,0_5}`` are ResNet-C (deep stem) variants, and every
``<family>_<F>M`` name is a ResNet-18 whose uniform width multiplier is
solved (:func:`widths_for_budget`, the same bisection and rounding) so the
224² forward FLOPs match the budget: each name gets the JAX package's
widths. A block projects its identity only where the width changes
(``ScaledBasicBlock``), so the budgets whose widths repeat across a strided
stage boundary (e.g. ``bignas_resnet18_9M``, widths 8, 8, 8, 8) fail at
their first forward, in the JAX package and in the port alike.

Module names follow torchvision's ResNet (``conv1``, ``bn1``,
``layerL.B.{conv1,bn1,conv2,bn2,downsample.0,downsample.1}``, ``fc``), the
deep stem timm's (``conv1.{0,1,3,4,6}``, ``bn1``).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from robustart_torch.models.layers import ConvNet, MaxPool2d

BN_EPS = 1e-5


class ScaledBasicBlock(nn.Module):
    def __init__(self, cin: int, filters: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, filters, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(filters, eps=BN_EPS)
        self.conv2 = nn.Conv2d(filters, filters, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(filters, eps=BN_EPS)
        self.downsample = None
        if cin != filters:
            self.downsample = nn.Sequential(nn.Conv2d(cin, filters, 1, stride, bias=False),
                                            nn.BatchNorm2d(filters, eps=BN_EPS))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        out = torch.relu(self.bn1(self.conv1(x)))
        return torch.relu(self.bn2(self.conv2(out)) + identity)


class ScaledResNet18(ConvNet):
    """ResNet-18 topology with scalable stem and stage widths; optional
    ResNet-C deep stem (three 3×3 convs)."""

    HEAD = ("fc",)

    def __init__(self, widths: Sequence[int] = (64, 128, 256, 512),
                 stage_sizes: Sequence[int] = (2, 2, 2, 2), deep_stem: bool = False,
                 num_classes: int = 1000, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.widths, self.stage_sizes, self.deep_stem = tuple(widths), tuple(stage_sizes), deep_stem
        stem_w = self.widths[0]
        if deep_stem:
            w0, w1, w2 = (max(w, 8) for w in (stem_w // 2, stem_w // 2, stem_w))
            self.conv1 = nn.Sequential(
                nn.Conv2d(3, w0, 3, 2, 1, bias=False), nn.BatchNorm2d(w0, eps=BN_EPS), nn.ReLU(),
                nn.Conv2d(w0, w1, 3, 1, 1, bias=False), nn.BatchNorm2d(w1, eps=BN_EPS), nn.ReLU(),
                nn.Conv2d(w1, w2, 3, 1, 1, bias=False))
            cin = w2
        else:
            self.conv1 = nn.Conv2d(3, stem_w, 7, 2, 3, bias=False)
            cin = stem_w
        self.bn1 = nn.BatchNorm2d(cin, eps=BN_EPS)
        self.maxpool = MaxPool2d()
        for si, (w, n) in enumerate(zip(self.widths, self.stage_sizes)):
            blocks = []
            for bi in range(n):
                blocks.append(ScaledBasicBlock(cin, w, 2 if (si > 0 and bi == 0) else 1))
                cin = w
            self.add_module(f"layer{si + 1}", nn.Sequential(*blocks))
        self.fc = nn.Linear(cin, num_classes)
        self.finish(dtype, num_classes)

    def body(self, x):
        x = self.maxpool(torch.relu(self.bn1(self.conv1(x))))
        for si in range(len(self.widths)):
            x = getattr(self, f"layer{si + 1}")(x)
        return x

    def classify(self, x):
        return self.fc(x)


def resnet18_flops(widths, stage_sizes, input_size: int = 224) -> float:
    """Analytic 2·MAC forward FLOPs of the scaled ResNet-18 topology."""
    h = input_size // 2
    flops = 2 * h * h * 3 * widths[0] * 49  # 7x7 stem
    h //= 2  # maxpool
    cin = widths[0]
    for si, (w, n) in enumerate(zip(widths, stage_sizes)):
        for bi in range(n):
            stride = 2 if (si > 0 and bi == 0) else 1
            hout = h // stride
            flops += 2 * hout * hout * cin * w * 9
            flops += 2 * hout * hout * w * w * 9
            if stride != 1 or cin != w:
                flops += 2 * hout * hout * cin * w
            cin = w
            h = hout
    flops += 2 * cin * 1000
    return flops


def widths_for_budget(mflops: float) -> tuple:
    """Solve a uniform width multiplier so 224² forward FLOPs ≈ the budget."""
    base = (64, 128, 256, 512)
    lo, hi = 0.01, 4.0
    for _ in range(40):
        mid = (lo + hi) / 2
        widths = tuple(max(8, int(round(w * mid / 8) * 8)) for w in base)
        f = resnet18_flops(widths, (2, 2, 2, 2)) / 1e6
        if f < mflops:
            lo = mid
        else:
            hi = mid
    return tuple(max(8, int(round(w * lo / 8) * 8)) for w in base)


def make_budgeted_resnet18(mflops: float):
    widths = widths_for_budget(mflops)

    def factory(**kw):
        kw.pop("bn", None)
        return ScaledResNet18(widths=widths, **kw)

    return factory


def crnas_resnet_c(depth: int):
    stage_sizes = {18: (2, 2, 2, 2), 50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}[depth]

    def factory(**kw):
        kw.pop("bn", None)
        return ScaledResNet18(widths=(64, 128, 256, 512), stage_sizes=stage_sizes,
                              deep_stem=True, **kw)

    return factory


def resnet18c_scaled(scale: float):
    widths = tuple(max(8, int(64 * 2**i * scale)) for i in range(4))

    def factory(**kw):
        kw.pop("bn", None)
        return ScaledResNet18(widths=widths, deep_stem=True, **kw)

    return factory


# the budget lists the reference enumerates (swin/config.yaml:8)
BIGNAS_BUDGETS = (9, 37, 49, 50, 65, 107, 125, 150, 312, 403, 492, 1555)
BIGNAS_RESNET50_BUDGETS = (2954, 3145, 3811)
ONESHOT_BUDGETS = (9, 27, 37, 55, 70, 91, 96, 113, 168, 304, 1710, 3072)

NAS_FACTORIES = {}
for _b in BIGNAS_BUDGETS:
    NAS_FACTORIES[f"bignas_resnet18_{_b}M"] = make_budgeted_resnet18(_b)
NAS_FACTORIES["bignas_det_resnet18_1930M"] = make_budgeted_resnet18(1930)
for _b in BIGNAS_RESNET50_BUDGETS:
    NAS_FACTORIES[f"bignas_resnet50_{_b}M"] = make_budgeted_resnet18(_b)
for _b in ONESHOT_BUDGETS:
    NAS_FACTORIES[f"oneshot_supcell_{_b}M"] = make_budgeted_resnet18(_b)
NAS_FACTORIES["dmcp_resnet18_47M"] = make_budgeted_resnet18(47)
NAS_FACTORIES["dmna_resnet18_1800M"] = make_budgeted_resnet18(1800)
NAS_FACTORIES["crnas_resnet18c"] = crnas_resnet_c(18)
NAS_FACTORIES["crnas_resnet50c"] = crnas_resnet_c(50)
NAS_FACTORIES["crnas_resnet101c"] = crnas_resnet_c(101)
NAS_FACTORIES["resnet18c_x0_125"] = resnet18c_scaled(0.125)
NAS_FACTORIES["resnet18c_x0_25"] = resnet18c_scaled(0.25)
NAS_FACTORIES["resnet18c_x0_5"] = resnet18c_scaled(0.5)
