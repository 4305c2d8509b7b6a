"""Shared model building blocks (counterpart of
``robustart_tpu/models/layers.py``, the parts ResNet, ViT, Swin and ConvNeXt
use).

The port's public tensors are NHWC like the JAX package's; inside, the CNNs
run PyTorch's NCHW API on ``channels_last`` memory, which is the same bytes.
"""

from __future__ import annotations

import contextlib
import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from robustart_torch.ops.image import fma
from robustart_torch.ops.linear import layer_norm_f32

# ImageNet preprocessing constants shared across the zoo
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
# CLIP towers use their own normalization (``robustart_tpu/models/layers.py:30-31``)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's activation x·σ(1.702x) (``robustart_tpu/models/clip_vit.py:34``)."""
    return x * torch.sigmoid(1.702 * x)


def normalize_01(x: torch.Tensor, mean: Sequence[float], std: Sequence[float]) -> torch.Tensor:
    """Normalize NHWC [0,1] images with per-channel mean/std."""
    mean_t = torch.tensor(mean, dtype=x.dtype, device=x.device)
    std_t = torch.tensor(std, dtype=x.dtype, device=x.device)
    return (x - mean_t) / std_t


def normalize_jit(x: torch.Tensor, mean: Sequence[float], std: Sequence[float],
                  levels: torch.Tensor | None = None) -> torch.Tensor:
    """:func:`normalize_01` as XLA compiles the JAX package's jitted
    training step on the CPU: the division by the constant std becomes the
    product by its float32 reciprocal, ``(x − mean)·fl32(1/fl32(std))``; and
    where x is still uint8 ``levels``·fl32(1/255) (no attack or mixup made
    it), the subtraction fuses with that product into one FMA,
    ``fma(levels, fl32(1/255), −mean)·fl32(1/std)`` (bitwise the JAX
    program's on all 256 levels). A ResNet's train-mode gradient can hinge
    on an ulp of its input (a max-pool window whose two largest values
    differ by an ulp), so training normalizes as the JAX step does."""
    mean_t = torch.tensor(mean, dtype=torch.float32, device=x.device)
    inv = torch.from_numpy(np.float32(1.0) / np.asarray(std, np.float32)).to(x.device)
    if levels is not None:
        return fma(levels, float(np.float32(1.0 / 255.0)), -mean_t.to(torch.float64)) * inv
    return (x - mean_t) * inv


class MaxPool2d(nn.MaxPool2d):
    """3x3/2 max-pool with torch-style padding=1 (pads with −inf), the
    window the JAX package's ``MaxPool2d`` reduces over."""

    def __init__(self, window: int = 3, stride: int = 2, padding: int = 1):
        super().__init__(window, stride, padding)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """Mean over the spatial axes of an NCHW tensor → (N, C)."""
    return x.mean(dim=(2, 3))


def hardswish(x: torch.Tensor) -> torch.Tensor:
    """x·relu6(x + 3)/6 (``robustart_tpu/models/layers.py:125-127``)."""
    return x * F.relu6(x + 3.0) / 6.0


def hardsigmoid(x: torch.Tensor) -> torch.Tensor:
    """relu6(x + 3)/6 (``robustart_tpu/models/layers.py:130-131``)."""
    return F.relu6(x + 3.0) / 6.0


class Act(nn.Module):
    """An activation function as a module without parameters, so it takes
    its place in an ``nn.Sequential`` without shifting the indices of the
    parameterized layers after it."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(x)


def conv_bn(cin: int, cout: int, kernel: int = 1, stride: int = 1, groups: int = 1,
            eps: float = 1e-5, act=None) -> nn.Sequential:
    """Conv (padding (k − 1)/2, no bias) + BatchNorm [+ ``act``] as
    torchvision's ``Conv2dNormActivation``: keys ``.0`` and ``.1``."""
    layers = [nn.Conv2d(cin, cout, kernel, stride, (kernel - 1) // 2, groups=groups,
                        bias=False),
              nn.BatchNorm2d(cout, eps=eps)]
    if act is not None:
        layers.append(Act(act))
    return nn.Sequential(*layers)


class ConvNet(nn.Module):
    """Base of the float CNN zoo (MobileNet, EfficientNet, RegNet, RepVGG,
    ShuffleNet, GoogLeNet, the NAS stand-ins) on normalized NHWC images.

    A subclass builds its layers, then calls :meth:`finish`, and defines
    :meth:`body` (NCHW in the working type → NCHW features) and
    :meth:`classify` (pooled float32 features → logits). As in the JAX package,
    ``dtype=torch.bfloat16`` computes the body in bf16 and the pooled
    features and the head in float32; a float32 forward runs with TF32 off.
    """

    HEAD: tuple[str, ...] = ()  # the children that stay float32

    def finish(self, dtype: torch.dtype, num_classes: int) -> None:
        self.dtype = dtype
        self.num_classes = num_classes
        self.to(memory_format=torch.channels_last)
        if dtype != torch.float32:
            for name, child in self.named_children():
                if name not in self.HEAD:
                    child.to(dtype)

    def body(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def classify(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) normalized → (N, num_classes) float32 logits."""
        if self.training:
            raise NotImplementedError("training is not ported (ROADMAP.md, modules to port: "
                                      "Training)")
        # an NHWC tensor seen through permute is NCHW with channels_last strides
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        ctx = full_f32() if self.dtype == torch.float32 else contextlib.nullcontext()
        with ctx:
            return self.classify(global_avg_pool(self.body(x)).float())


@contextlib.contextmanager
def full_f32():
    """TF32 off for convolutions and matmuls, restored on exit: a float32
    forward is held to float32 parity with the JAX package."""
    conv, mm = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = mm


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5, dtype: torch.dtype | None = None) -> torch.Tensor:
    """LayerNorm over the last axis with f32 statistics, var = E[x²] − μ²,
    then rsqrt (``robustart_tpu/models/layers.py:170-178``); the result in
    ``dtype`` (default: x's)."""
    return layer_norm_f32(x, weight, bias, eps).to(dtype or x.dtype)


@torch.no_grad()
def init_lecun(model: nn.Module, generator: torch.Generator) -> None:
    """The JAX package's initializers for a transformer or ConvNeXt: Linear
    and convolution weights lecun-normal (std 1/√fan_in) with zero bias,
    LayerNorm at identity."""
    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            fan_in = m.weight[0].numel()
            w = torch.randn(m.weight.shape, generator=generator) / math.sqrt(fan_in)
            m.weight.copy_(w)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.LayerNorm):
            m.reset_parameters()


class DropPath(nn.Module):
    """Stochastic depth: the identity at eval, which is all the port runs."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training and self.rate > 0.0:
            raise NotImplementedError("training is not ported (ROADMAP.md, modules to port: "
                                      "Training)")
        return x


class PatchifyConv(nn.Conv2d):
    """A convolution with stride = kernel and no padding on NHWC input, in
    the matmul form of the JAX package's ``PatchifyConv``
    (``layers.py:181-228``): space-to-depth, one product in the working
    type, + bias in the working type. The weights are a Conv2d's (OIHW), so
    a torch checkpoint loads as it is. The product is ``torch.matmul``: XLA
    computed it outside any Pallas kernel; a float32 forward runs it under
    :func:`full_f32`. ``bias=False`` is CLIP's ``conv1``."""

    def __init__(self, in_chans: int, out_chans: int, patch_size: int, bias: bool = True):
        super().__init__(in_chans, out_chans, patch_size, patch_size, bias=bias)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """(B, H, W, C) → (B, H/p, W/p, out_chans) in ``dtype``."""
        b, h, w, cin = x.shape
        p = self.kernel_size[0]
        if h % p or w % p:
            raise ValueError(f"PatchifyConv needs H, W divisible by {p}; got {h}x{w}")
        gh, gw = h // p, w // p
        patches = x.reshape(b, gh, p, gw, p, cin).permute(0, 1, 3, 2, 4, 5)
        patches = patches.reshape(b, gh, gw, p * p * cin)
        # OIHW → (kh, kw, in, out): the HWIO order of the patches' features
        wmat = self.weight.permute(2, 3, 1, 0).reshape(p * p * cin, -1)
        y = torch.matmul(patches.to(dtype), wmat.to(dtype))
        return y if self.bias is None else y + self.bias.to(dtype)


class PatchEmbed(nn.Module):
    """ViT's patch embedding: :class:`PatchifyConv` under the name ``proj``,
    so a timm checkpoint's ``patch_embed.proj`` loads as it is, with the
    tokens flattened."""

    def __init__(self, patch_size: int, in_chans: int, embed_dim: int):
        super().__init__()
        self.proj = PatchifyConv(in_chans, embed_dim, patch_size)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """(B, H, W, C) → (B, H/p · W/p, embed_dim) in ``dtype``."""
        y = self.proj(x, dtype)
        return y.reshape(y.shape[0], -1, y.shape[-1])
