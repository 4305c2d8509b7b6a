"""ShuffleNetV2 x0.5, x1.0, x1.5 and x2.0.

Counterpart of ``robustart_tpu/models/shufflenet.py`` (BatchNorm eps 1e-5).
Module names follow torchvision (``conv1.{0,1}``, ``stageS.I.branch1.J``,
``stageS.I.branch2.J``, ``conv5.{0,1}``, ``fc``), as the JAX package's
``torch_convert.py:235-254`` names them.

:func:`channel_shuffle` on NCHW gives the channel order of the JAX
package's NHWC shuffle (:19-23): channel g·(C/groups) + i of the input
becomes channel i·groups + g.
"""

from __future__ import annotations

import torch
from torch import nn

from robustart_torch.models.layers import ConvNet, MaxPool2d, conv_bn

BN_EPS = 1e-5


def channel_shuffle(x: torch.Tensor, groups: int = 2) -> torch.Tensor:
    """Interleave the ``groups`` channel groups of NCHW x."""
    b, c, h, w = x.shape
    return x.reshape(b, groups, c // groups, h, w).transpose(1, 2).reshape(b, c, h, w)


def _seq(*parts) -> nn.Sequential:
    """Concatenate conv_bn Sequentials into one, torchvision's flat branch."""
    return nn.Sequential(*[m for p in parts for m in p])


def _cbr(cin, cout, kernel=1, stride=1, groups=1, relu=True):
    return conv_bn(cin, cout, kernel, stride, groups, BN_EPS, torch.relu if relu else None)


class ShuffleUnit(nn.Module):
    def __init__(self, cin: int, features: int, stride: int):
        super().__init__()
        self.stride = stride
        bf = features // 2
        if stride == 1:
            self.branch1 = None
            first = bf
        else:
            self.branch1 = _seq(_cbr(cin, cin, 3, stride, cin, relu=False), _cbr(cin, bf))
            first = cin
        self.branch2 = _seq(_cbr(first, bf), _cbr(bf, bf, 3, stride, bf, relu=False),
                            _cbr(bf, bf))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.branch1 is None:
            x1, x2 = x.chunk(2, dim=1)
            out = torch.cat([x1, self.branch2(x2)], dim=1)
        else:
            out = torch.cat([self.branch1(x), self.branch2(x)], dim=1)
        return channel_shuffle(out, 2)


class ShuffleNetV2(ConvNet):
    HEAD = ("fc",)

    def __init__(self, stage_channels, stage_repeats=(4, 8, 4), num_classes: int = 1000,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = _cbr(3, 24, 3, 2)
        self.maxpool = MaxPool2d()
        cin = 24
        for stage, (c, n) in enumerate(zip(stage_channels[:3], stage_repeats)):
            units = []
            for i in range(n):
                units.append(ShuffleUnit(cin, c, 2 if i == 0 else 1))
                cin = c
            self.add_module(f"stage{stage + 2}", nn.Sequential(*units))
        self.conv5 = _cbr(cin, stage_channels[3])
        self.fc = nn.Linear(stage_channels[3], num_classes)
        self.finish(dtype, num_classes)

    def body(self, x):
        x = self.maxpool(self.conv1(x))
        x = self.stage4(self.stage3(self.stage2(x)))
        return self.conv5(x)

    def classify(self, x):
        return self.fc(x)


CHANNELS = {
    0.5: (48, 96, 192, 1024),
    1.0: (116, 232, 464, 1024),
    1.5: (176, 352, 704, 1024),
    2.0: (244, 488, 976, 2048),
}


def _shufflenet(scale, **kw):
    kw.pop("bn", None)
    return ShuffleNetV2(stage_channels=CHANNELS[scale], **kw)


def shufflenet_v2_x0_5(**kw):
    return _shufflenet(0.5, **kw)


def shufflenet_v2_x1_0(**kw):
    return _shufflenet(1.0, **kw)


def shufflenet_v2_x1_5(**kw):
    return _shufflenet(1.5, **kw)


def shufflenet_v2_x2_0(**kw):
    return _shufflenet(2.0, **kw)
