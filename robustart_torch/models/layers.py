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

import torch
from torch import nn

from robustart_torch.ops.linear import layer_norm_f32

# ImageNet preprocessing constants shared across the zoo
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_01(x: torch.Tensor, mean: Sequence[float], std: Sequence[float]) -> torch.Tensor:
    """Normalize NHWC [0,1] images with per-channel mean/std."""
    mean_t = torch.tensor(mean, dtype=x.dtype, device=x.device)
    std_t = torch.tensor(std, dtype=x.dtype, device=x.device)
    return (x - mean_t) / std_t


class MaxPool2d(nn.MaxPool2d):
    """3x3/2 max-pool with torch-style padding=1 (pads with −inf), the
    window the JAX package's ``MaxPool2d`` reduces over."""

    def __init__(self, window: int = 3, stride: int = 2, padding: int = 1):
        super().__init__(window, stride, padding)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """Mean over the spatial axes of an NCHW tensor → (N, C)."""
    return x.mean(dim=(2, 3))


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
            raise NotImplementedError("training is not ported (ROADMAP.md, item 7)")
        return x


class PatchifyConv(nn.Conv2d):
    """A convolution with stride = kernel and no padding on NHWC input, in
    the matmul form of the JAX package's ``PatchifyConv``
    (``layers.py:181-228``): space-to-depth, one product in the working
    type, + bias in the working type. The weights are a Conv2d's (OIHW), so
    a torch checkpoint loads as it is. The product is ``torch.matmul``: XLA
    computed it outside any Pallas kernel; a float32 forward runs it under
    :func:`full_f32`."""

    def __init__(self, in_chans: int, out_chans: int, patch_size: int):
        super().__init__(in_chans, out_chans, patch_size, patch_size)

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
        return torch.matmul(patches.to(dtype), wmat.to(dtype)) + self.bias.to(dtype)


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
