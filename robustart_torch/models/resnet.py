"""ResNet family: resnet18/34/50/101/152, wide_resnet{50_2,101_2},
resnext{50_32x4d,101_32x8d}.

Counterpart of ``robustart_tpu/models/resnet.py``. Module names follow
torchvision (``conv1``, ``layer1.0.conv1``, ``layer1.0.downsample.0``,
``fc``), so a torchvision checkpoint loads as it is and
``models/convert.py`` maps the JAX package's variables onto the same keys.
The forward takes normalized NHWC images and runs on ``channels_last``
memory; BatchNorm eps is 1e-5 as in the JAX package.

Train mode (``model.train()``) is Flax's BatchNorm (``momentum=0.9``,
``epsilon=1e-5``; :class:`BatchNorm`): batch statistics in float32 with the
biased variance E[x²] − E[x]², folded into the running statistics as
``0.9·running + 0.1·batch``. ``nn.BatchNorm2d`` would fold the unbiased
variance. Under ``dtype=torch.bfloat16`` a model trains on float32 master
parameters and statistics (``model.float()``, which leaves ``model.dtype``
as it is): every convolution
casts its weight to the input's type, as Flax does with ``param_dtype``
float32 and ``dtype`` bfloat16.
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn

from robustart_torch.models.layers import MaxPool2d, full_f32, global_avg_pool


class Conv2d(nn.Conv2d):
    """A convolution in its input's type: the weight is cast to it (a no-op
    where they agree), so float32 master weights serve a bf16 forward."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, self.weight.to(x.dtype), None)


class BatchNorm(nn.BatchNorm2d):
    """``nn.BatchNorm2d``'s parameters and buffers with Flax's train mode
    (see the module docstring). At eval, where the parameters' type is the
    input's, it is ``nn.BatchNorm2d``; a bf16 input on float32 parameters
    normalizes in float32 and returns bf16, as Flax does."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            if x.dtype == self.weight.dtype:
                return super().forward(x)
            return self._normalize(x, self.running_mean, self.running_var)
        xf = x.float()
        mean = xf.mean(dim=(0, 2, 3))
        var = torch.clamp((xf * xf).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
        with torch.no_grad():
            self.running_mean.mul_(0.9).add_(mean.detach() * (1 - 0.9))
            self.running_var.mul_(0.9).add_(var.detach() * (1 - 0.9))
            self.num_batches_tracked.add_(1)
        return self._normalize(x, mean, var)

    def _normalize(self, x, mean, var):
        shape = (1, -1, 1, 1)
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        y = (x.float() - mean.view(shape)) * mul.view(shape) + self.bias.float().view(shape)
        return y.to(x.dtype)


def _downsample(inplanes: int, planes: int, stride: int) -> nn.Sequential:
    return nn.Sequential(
        Conv2d(inplanes, planes, 1, stride, bias=False),
        BatchNorm(planes),
    )


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, filters: int, stride: int = 1,
                 downsample: bool = False, groups: int = 1, base_width: int = 64):
        super().__init__()
        self.conv1 = Conv2d(inplanes, filters, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm(filters)
        self.conv2 = Conv2d(filters, filters, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm(filters)
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
        self.conv1 = Conv2d(inplanes, width, 1, bias=False)
        self.bn1 = BatchNorm(width)
        self.conv2 = Conv2d(width, width, 3, stride, 1, groups=groups, bias=False)
        self.bn2 = BatchNorm(width)
        self.conv3 = Conv2d(width, out, 1, bias=False)
        self.bn3 = BatchNorm(out)
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
        self.conv1 = Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm(64)
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
