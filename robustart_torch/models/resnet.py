"""ResNet family: resnet18/34/50/101/152, wide_resnet{50_2,101_2},
resnext{50_32x4d,101_32x8d}.

Counterpart of ``robustart_tpu/models/resnet.py``. Module names follow
torchvision (``conv1``, ``layer1.0.conv1``, ``layer1.0.downsample.0``,
``fc``), so a torchvision checkpoint loads as it is and
``models/convert.py`` maps the JAX package's variables onto the same keys.
The forward takes normalized NHWC images and runs on ``channels_last``
memory; BatchNorm eps is 1e-5 as in the JAX package.
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn

from robustart_torch.models.layers import MaxPool2d, full_f32, global_avg_pool


def _downsample(inplanes: int, planes: int, stride: int) -> nn.Sequential:
    return nn.Sequential(
        nn.Conv2d(inplanes, planes, 1, stride, bias=False),
        nn.BatchNorm2d(planes, eps=1e-5),
    )


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, filters: int, stride: int = 1,
                 downsample: bool = False, groups: int = 1, base_width: int = 64):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, filters, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(filters, eps=1e-5)
        self.conv2 = nn.Conv2d(filters, filters, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(filters, eps=1e-5)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = _downsample(inplanes, filters, stride) if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return self.relu(out + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, filters: int, stride: int = 1,
                 downsample: bool = False, groups: int = 1, base_width: int = 64):
        super().__init__()
        width = int(filters * (base_width / 64.0)) * groups
        out = filters * self.expansion
        self.conv1 = nn.Conv2d(inplanes, width, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(width, eps=1e-5)
        self.conv2 = nn.Conv2d(width, width, 3, stride, 1, groups=groups, bias=False)
        self.bn2 = nn.BatchNorm2d(width, eps=1e-5)
        self.conv3 = nn.Conv2d(width, out, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(out, eps=1e-5)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = _downsample(inplanes, out, stride) if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return self.relu(out + identity)


class ResNet(nn.Module):
    """Torchvision-structured ResNet taking normalized NHWC images.

    ``stem_s2d`` is accepted for config compatibility and changes nothing:
    in the JAX package it rewrites the 7×7/2 stem as an equivalent 4×4 conv
    on a space-to-depth input to fill the TPU's matrix unit
    (robustart_tpu/models/resnet.py:116-169), with exactly the standard
    stem's result. The port always computes the standard stem.

    ``dtype=torch.bfloat16`` computes the body in bf16 and takes the pooled
    features and ``fc`` in float32, as the JAX package does. In float32 the
    forward runs with TF32 off.
    """

    def __init__(self, block, stage_sizes, num_classes: int = 1000,
                 groups: int = 1, base_width: int = 64, stem_s2d: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.num_classes = num_classes
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64, eps=1e-5)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = MaxPool2d()
        inplanes = 64
        for stage, num_blocks in enumerate(stage_sizes):
            filters = 64 * (2**stage)
            blocks = []
            for i in range(num_blocks):
                stride = 2 if (stage > 0 and i == 0) else 1
                needs_ds = i == 0 and (
                    stride != 1 or inplanes != filters * block.expansion
                )
                blocks.append(block(inplanes, filters, stride, needs_ds, groups, base_width))
                inplanes = filters * block.expansion
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))
        self.num_stages = len(stage_sizes)
        self.fc = nn.Linear(inplanes, num_classes)
        self.to(memory_format=torch.channels_last)
        if dtype != torch.float32:
            for name, child in self.named_children():
                if name != "fc":
                    child.to(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) normalized → (N, num_classes) float32 logits."""
        # an NHWC tensor seen through permute is NCHW with channels_last strides
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        ctx = full_f32() if self.dtype == torch.float32 else contextlib.nullcontext()
        with ctx:
            x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
            for stage in range(self.num_stages):
                x = getattr(self, f"layer{stage + 1}")(x)
            x = global_avg_pool(x).float()
            return self.fc(x)


def _resnet(block, stage_sizes, **kwargs):
    kwargs.pop("bn", None)  # reference bn{use_sync_bn}: eval uses running stats
    return ResNet(block, stage_sizes, **kwargs)


def resnet18(**kw):
    return _resnet(BasicBlock, (2, 2, 2, 2), **kw)


def resnet34(**kw):
    return _resnet(BasicBlock, (3, 4, 6, 3), **kw)


def resnet50(**kw):
    return _resnet(Bottleneck, (3, 4, 6, 3), **kw)


def resnet101(**kw):
    return _resnet(Bottleneck, (3, 4, 23, 3), **kw)


def resnet152(**kw):
    return _resnet(Bottleneck, (3, 8, 36, 3), **kw)


def wide_resnet50_2(**kw):
    return _resnet(Bottleneck, (3, 4, 6, 3), base_width=128, **kw)


def wide_resnet101_2(**kw):
    return _resnet(Bottleneck, (3, 4, 23, 3), base_width=128, **kw)


def resnext50_32x4d(**kw):
    return _resnet(Bottleneck, (3, 4, 6, 3), groups=32, base_width=4, **kw)


def resnext101_32x8d(**kw):
    return _resnet(Bottleneck, (3, 4, 23, 3), groups=32, base_width=8, **kw)
