"""Shared model building blocks (counterpart of
``robustart_tpu/models/layers.py``, the part ResNet uses).

The port's public tensors are NHWC like the JAX package's; inside, models
run PyTorch's NCHW API on ``channels_last`` memory, which is the same bytes.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

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
