"""ConvNeXt and ConvNeXt-V2: ``convnext_base`` (and ``convnext_base_cvst``,
the CvSt robust checkpoints), ``convnextv2_base``.

Counterpart of ``robustart_tpu/models/convnext.py`` (:83-217).
Parameter names follow facebook's ConvNeXt (``downsample_layers.0.{0,1}``
stem convolution and norm, ``downsample_layers.i.{0,1}`` norm and
convolution, ``stages.i.j.{dwconv, norm, pwconv1, pwconv2, gamma}``,
``norm``, ``head``), so an official checkpoint loads through
``saver.pretrain.path`` as it is, and ``models/convert.py`` maps the JAX
package's variables onto the same keys. ConvNeXt-V2's blocks have no
``gamma`` and add ``stages.i.j.grn.{gamma, beta}`` of shape (1, 1, 1, 4C),
facebook's.

A block is the depthwise 7×7 convolution + bias + LayerNorm kernel K11
(``ops/convnext.py::dwconv_ln``), then the MLP kernel K7 in its ConvNeXt
form (``ops/mlp.py::mlp``: no LN prologue, exact GELU, the layer-scale
``gamma`` and the block input as the residual in the epilogue). The JAX
module resolves ``block_impl="auto"`` to its XLA form because of a TPU
measurement (``convnext.py:88-95``); here every block runs K11 on CUDA
tensors. A ConvNeXt-V2 block (``use_grn``) has no layer-scale and keeps its
MLP unfused, as the JAX module does (``convnext.py:130``: it fuses only
without GRN, and XLA computes those products): fc1 + bias, exact GELU,
:class:`GRN`, fc2 + bias in the working type, then the shortcut.

``dtype=torch.bfloat16`` keeps the stem, downsample and MLP weights in bf16
and computes there; the depthwise weights stay float32 (K11 takes its
parameters in f32, as the Pallas kernel does), as do biases, LayerNorm
parameters, ``gamma`` and the head, which runs in float32 on the pooled
features; GRN's ``gamma`` and ``beta`` stay float32, so GRN's output is
float32, as the JAX module's is. The forward is eval only.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from robustart_torch.models.layers import PatchifyConv, full_f32, init_lecun, layer_norm
from robustart_torch.ops.convnext import dwconv_ln
from robustart_torch.ops.mlp import mlp

LN_EPS = 1e-6


class GRN(nn.Module):
    """ConvNeXt-V2's global response normalization on NHWC x
    (``robustart_tpu/models/convnext.py:69-80``): the L2 norm over H and W
    (+1e-12 under the root), divided by its channel mean (+1e-6), then
    ``gamma·(x·nx) + beta + x``. The square and the sums are in x's type,
    as the JAX module's; with f32 ``gamma`` and ``beta`` the result is
    f32."""

    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.zeros(1, 1, 1, dim))
        self.beta = nn.Parameter(torch.zeros(1, 1, 1, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gx = torch.sqrt((x * x).sum(dim=(1, 2), keepdim=True) + 1e-12)
        nx = gx / (gx.mean(dim=-1, keepdim=True) + 1e-6)
        return self.gamma * (x * nx) + self.beta + x


class ConvNeXtBlock(nn.Module):
    """``layer_scale_init`` ≤ 0 drops the layer-scale ``gamma`` (V2);
    ``use_grn`` makes the MLP V2's unfused one with :class:`GRN`."""

    def __init__(self, dim: int, layer_scale_init: float = 1e-6, use_grn: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.dwconv = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.pwconv1 = nn.Linear(dim, 4 * dim)
        self.grn = GRN(4 * dim) if use_grn else None
        self.pwconv2 = nn.Linear(4 * dim, dim)
        self.gamma = (nn.Parameter(torch.full((dim,), float(layer_scale_init)))
                      if layer_scale_init > 0 else None)
        for lin in (self.pwconv1, self.pwconv2):
            lin.weight.data = lin.weight.data.to(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) → (B, H, W, C) in x's type: K11, then K7 with the
        layer-scale and x as the shortcut (V1), or V2's unfused MLP."""
        y = dwconv_ln(x, self.dwconv.weight, self.dwconv.bias, self.norm.weight, self.norm.bias,
                      LN_EPS)
        fc1, fc2 = self.pwconv1, self.pwconv2
        if self.grn is None:
            return mlp(y, fc1.weight, fc1.bias, fc2.weight, fc2.bias, gamma=self.gamma,
                       residual=x)
        dt = self.dtype
        h = F.gelu(torch.matmul(y, fc1.weight.t()) + fc1.bias.to(dt))
        h = self.grn(h)
        y = torch.matmul(h.to(dt), fc2.weight.t()) + fc2.bias.to(dt)
        if self.gamma is not None:
            y = y * self.gamma
        return x + y


class ConvNeXt(nn.Module):
    """ConvNeXt on normalized NHWC images → (N, num_classes) float32 logits."""

    def __init__(self, depths: Sequence[int] = (3, 3, 27, 3),
                 dims: Sequence[int] = (128, 256, 512, 1024), num_classes: int = 1000,
                 drop_path: float = 0.0, use_grn: bool = False,
                 dtype: torch.dtype = torch.float32):
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
            nn.ModuleList([ConvNeXtBlock(dim, 0.0 if use_grn else 1e-6, use_grn, dtype)
                           for _ in range(depth)])
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
            raise NotImplementedError("training is not ported (ROADMAP.md, modules to port: "
                                      "Training)")
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
    layer-scale init 1e-6 and GRN's ``gamma`` and ``beta`` at zero (V2: GRN
    is then the identity). ``probe`` draws ``gamma`` from U(0.5, 1.5) and
    GRN's two from N(0, 0.5²) instead: at their inits the blocks are all
    but the identity, and an error in K11, K7 or GRN would not reach the
    logits."""
    init_lecun(model, generator)
    for stage in model.stages:
        for blk in stage:
            if blk.gamma is not None:
                if probe:
                    blk.gamma.copy_(torch.rand(blk.gamma.shape, generator=generator) + 0.5)
                else:
                    blk.gamma.fill_(1e-6)
            if blk.grn is not None:
                for p in (blk.grn.gamma, blk.grn.beta):
                    p.copy_(torch.randn(p.shape, generator=generator) * 0.5 if probe
                            else torch.zeros(p.shape))


def convnext_base(**kw):
    kw.pop("bn", None)  # reference bn{use_sync_bn}: ConvNeXt has none
    return ConvNeXt(**kw)


def convnextv2_base(**kw):
    kw.pop("bn", None)
    return ConvNeXt(use_grn=True, **kw)
