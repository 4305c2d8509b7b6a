"""GoogLeNet (Inception v1, the BatchNorm variant, no auxiliary heads).

Counterpart of ``robustart_tpu/models/googlenet.py``: BatchNorm eps 1e-3,
the "5×5" branch a 3×3 conv as in torchvision. Module names follow
torchvision (``conv1.{conv,bn}``, ``inception3a.branch1``,
``branch2.{0,1}``, ``branch3.{0,1}``, ``branch4.1``, ``fc``).

The pools are the JAX package's ``layers.MaxPool2d``: −inf padding and the
floor of (H + 2p − k)/s + 1 outputs (3×3/2 padding 1 after the stem and
conv3 and stage 3, 3×3/1 padding 1 in each branch 4, 2×2/2 without padding
before stage 5), not torchvision's ``ceil_mode`` pools, which give other
sizes at odd inputs.
"""

from __future__ import annotations

import torch
from torch import nn

from robustart_torch.models.layers import ConvNet, MaxPool2d

BN_EPS = 1e-3


class BasicConv2d(nn.Module):
    def __init__(self, cin: int, cout: int, kernel: int = 1, stride: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, (kernel - 1) // 2, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.bn(self.conv(x)))


class Inception(nn.Module):
    def __init__(self, cin, ch1x1, ch3x3red, ch3x3, ch5x5red, ch5x5, pool_proj):
        super().__init__()
        self.branch1 = BasicConv2d(cin, ch1x1)
        self.branch2 = nn.Sequential(BasicConv2d(cin, ch3x3red), BasicConv2d(ch3x3red, ch3x3, 3))
        self.branch3 = nn.Sequential(BasicConv2d(cin, ch5x5red), BasicConv2d(ch5x5red, ch5x5, 3))
        self.branch4 = nn.Sequential(MaxPool2d(3, 1, 1), BasicConv2d(cin, pool_proj))
        self.out_chans = ch1x1 + ch3x3 + ch5x5 + pool_proj

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([self.branch1(x), self.branch2(x), self.branch3(x), self.branch4(x)],
                         dim=1)


# (name, ch1x1, ch3x3red, ch3x3, ch5x5red, ch5x5, pool_proj)
INCEPTIONS = (
    ("inception3a", 64, 96, 128, 16, 32, 32),
    ("inception3b", 128, 128, 192, 32, 96, 64),
    ("inception4a", 192, 96, 208, 16, 48, 64),
    ("inception4b", 160, 112, 224, 24, 64, 64),
    ("inception4c", 128, 128, 256, 24, 64, 64),
    ("inception4d", 112, 144, 288, 32, 64, 64),
    ("inception4e", 256, 160, 320, 32, 128, 128),
    ("inception5a", 256, 160, 320, 32, 128, 128),
    ("inception5b", 384, 192, 384, 48, 128, 128),
)
# the pool before each of these inception blocks
_POOL_BEFORE = {"inception4a": "maxpool3", "inception5a": "maxpool4"}


class GoogLeNet(ConvNet):
    HEAD = ("fc",)

    def __init__(self, num_classes: int = 1000, dropout: float = 0.2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = BasicConv2d(3, 64, 7, 2)
        self.maxpool1 = MaxPool2d()
        self.conv2 = BasicConv2d(64, 64, 1)
        self.conv3 = BasicConv2d(64, 192, 3)
        self.maxpool2 = MaxPool2d()
        self.maxpool3 = MaxPool2d()
        self.maxpool4 = MaxPool2d(2, 2, 0)
        cin = 192
        for name, *chans in INCEPTIONS:
            block = Inception(cin, *chans)
            self.add_module(name, block)
            cin = block.out_chans
        self.dropout = nn.Dropout(dropout)
        self.fc = nn.Linear(cin, num_classes)
        self.finish(dtype, num_classes)

    def body(self, x):
        x = self.maxpool1(self.conv1(x))
        x = self.maxpool2(self.conv3(self.conv2(x)))
        for name, *_ in INCEPTIONS:
            if name in _POOL_BEFORE:
                x = getattr(self, _POOL_BEFORE[name])(x)
            x = getattr(self, name)(x)
        return x

    def classify(self, x):
        return self.fc(self.dropout(x))


def googlenet(**kw):
    kw.pop("bn", None)
    return GoogLeNet(**kw)
