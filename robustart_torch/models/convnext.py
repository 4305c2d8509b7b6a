"""ConvNeXt: ``convnext_base``.

Counterpart of ``robustart_tpu/models/convnext.py`` (:83-202, the V1 model).
Parameter names follow facebook's ConvNeXt (``downsample_layers.0.{0,1}``
stem convolution and norm, ``downsample_layers.i.{0,1}`` norm and
convolution, ``stages.i.j.{dwconv, norm, pwconv1, pwconv2, gamma}``,
``norm``, ``head``), so an official checkpoint loads through
``saver.pretrain.path`` as it is, and ``models/convert.py`` maps the JAX
package's variables onto the same keys.

A block is the depthwise 7×7 convolution + bias + LayerNorm kernel K11
(``ops/convnext.py::dwconv_ln``), then the MLP kernel K7 in its ConvNeXt
form (``ops/mlp.py::mlp``: no LN prologue, exact GELU, the layer-scale
``gamma`` and the block input as the residual in the epilogue). The JAX
module resolves ``block_impl="auto"`` to its XLA form because of a TPU
measurement (``convnext.py:88-95``); here every block runs K11 on CUDA
tensors.

``dtype=torch.bfloat16`` keeps the stem, downsample and MLP weights in bf16
and computes there; the depthwise weights stay float32 (K11 takes its
parameters in f32, as the Pallas kernel does), as do biases, LayerNorm
parameters, ``gamma`` and the head, which runs in float32 on the pooled
features. The forward is eval only. ConvNeXtV2 (GRN, unfused MLP) is not
ported yet (ROADMAP.md).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from robustart_torch.models.layers import PatchifyConv, full_f32, init_lecun, layer_norm
from robustart_torch.ops.convnext import dwconv_ln
from robustart_torch.ops.mlp import mlp

LN_EPS = 1e-6


class ConvNeXtBlock(nn.Module):
    def __init__(self, dim: int, layer_scale_init: float = 1e-6,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.pwconv1 = nn.Linear(dim, 4 * dim)
        self.pwconv2 = nn.Linear(4 * dim, dim)
        self.gamma = nn.Parameter(torch.full((dim,), float(layer_scale_init)))
        for lin in (self.pwconv1, self.pwconv2):
            lin.weight.data = lin.weight.data.to(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) → (B, H, W, C) in x's type: K11, then K7 with the
        layer-scale and x as the shortcut."""
        y = dwconv_ln(x, self.dwconv.weight, self.dwconv.bias, self.norm.weight, self.norm.bias,
                      LN_EPS)
        return mlp(y, self.pwconv1.weight, self.pwconv1.bias, self.pwconv2.weight,
                   self.pwconv2.bias, gamma=self.gamma, residual=x)


class ConvNeXt(nn.Module):
    """ConvNeXt on normalized NHWC images → (N, num_classes) float32 logits."""

    def __init__(self, depths: Sequence[int] = (3, 3, 27, 3),
                 dims: Sequence[int] = (128, 256, 512, 1024), num_classes: int = 1000,
                 drop_path: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.num_classes = num_classes
        self.drop_path = float(drop_path)  # identity at eval
        stem = nn.ModuleList([PatchifyConv(3, dims[0], 4), nn.LayerNorm(dims[0], eps=LN_EPS)])
        self.downsample_layers = nn.ModuleList([stem] + [
            nn.ModuleList([nn.LayerNorm(dims[i - 1], eps=LN_EPS),
                           PatchifyConv(dims[i - 1], dims[i], 2)])
            for i in range(1, len(dims))
        ])
        self.stages = nn.ModuleList([
            nn.ModuleList([ConvNeXtBlock(dim, dtype=dtype) for _ in range(depth)])
            for depth, dim in zip(depths, dims)
        ])
        self.norm = nn.LayerNorm(dims[-1], eps=LN_EPS)
        self.head = nn.Linear(dims[-1], num_classes)
        for m in self.modules():
            if isinstance(m, PatchifyConv):
                m.weight.data = m.weight.data.to(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) normalized → (N, num_classes) float32 logits."""
        if self.training and self.drop_path:
            raise NotImplementedError("training is not ported (ROADMAP.md, item 7)")
        dt = self.dtype
        with full_f32():
            for i, (down, stage) in enumerate(zip(self.downsample_layers, self.stages)):
                if i == 0:
                    conv, norm = down
                    x = layer_norm(conv(x, dt), norm.weight, norm.bias, LN_EPS, dt)
                else:
                    norm, conv = down
                    x = conv(layer_norm(x, norm.weight, norm.bias, LN_EPS, dt), dt)
                for blk in stage:
                    x = blk(x)
            x = x.mean(dim=(1, 2))
            x = layer_norm(x.float(), self.norm.weight, self.norm.bias, LN_EPS)
            return torch.matmul(x, self.head.weight.t()) + self.head.bias


@torch.no_grad()
def init_convnext(model: ConvNeXt, generator: torch.Generator, probe: bool = False) -> None:
    """Random weights from ``generator`` by the JAX package's initializers
    (:func:`init_lecun`; the depthwise fan-in is 49) with ``gamma`` at the
    layer-scale init 1e-6. ``probe`` draws ``gamma`` from U(0.5, 1.5)
    instead: at 1e-6 the blocks are all but the identity, and an error in
    K11 or K7 would not reach the logits."""
    init_lecun(model, generator)
    for stage in model.stages:
        for blk in stage:
            if probe:
                blk.gamma.copy_(torch.rand(blk.gamma.shape, generator=generator) + 0.5)
            else:
                blk.gamma.fill_(1e-6)


def convnext_base(**kw):
    kw.pop("bn", None)  # reference bn{use_sync_bn}: ConvNeXt has none
    return ConvNeXt(**kw)
