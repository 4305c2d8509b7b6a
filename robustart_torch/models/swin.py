"""Swin Transformer: ``swin_tiny``, ``swin_small``, ``swin_base``,
``swin_base_384``.

Counterpart of ``robustart_tpu/models/swin.py``. Parameter names follow
Microsoft's Swin (``patch_embed.proj``, ``patch_embed.norm``,
``layers.S.blocks.B.{norm1, attn.qkv, attn.proj,
attn.relative_position_bias_table, norm2, mlp.fc1, mlp.fc2}``,
``layers.S.downsample.{norm, reduction}``, ``norm``, ``head``), with q/k/v
packed 3-major as torch packs it and patch merging's 2×2 neighbours in
Microsoft's order ``[x(0,0), x(1,0), x(0,1), x(1,1)]``, so an official
checkpoint loads through ``saver.pretrain.path`` as it is.
``models/convert.py`` maps the JAX package's variables onto the same keys
(its q/k/v are head-major and its merge order ``[x(0,0), x(0,1), x(1,0),
x(1,1)]``).

Each block follows the JAX module's dispatch (``swin.py:193-205``):

- where ``block_kernel_head_groups(C, H, itemsize)`` is not None (every
  block of Swin-B; stages 2-3 of Swin-T and Swin-S) the attention half is
  the fused block kernel K6 (``ops/attention.py::window_block_qkv``): roll,
  window partition, K6 with the relative-position bias and the shift mask
  (the residual is inside K6), window reverse, roll back;
- elsewhere (C = 96 and 192) it is LN, the packed q/k/v product + bias in
  the working type, Swin's window attention K9 (``ops/attention.py::
  window_mha``), proj + bias, the residual;
- the MLP half is always K7 (``ops/mlp.py::mlp``) with the LN prologue and
  the raw-x residual.

Where a stage's resolution equals the window (stage 3 at 224²), the shift is
0 and no block has a mask.

``dtype=torch.bfloat16`` keeps the products' weights (patch embed, q/k/v,
proj, MLP, merge reduction) in bf16 and computes there; biases, LayerNorm
parameters, the bias tables and the head stay float32, and the head runs in
float32 on the pooled features, as the JAX package does. The forward is eval
only: the stochastic-depth rate is accepted for config compatibility.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch
from torch import nn

from robustart_torch.models.layers import (
    DropPath,
    PatchifyConv,
    full_f32,
    init_lecun,
    layer_norm,
)
from robustart_torch.ops.attention import block_kernel_head_groups, window_block_qkv, window_mha
from robustart_torch.ops.mlp import mlp

LN_EPS = 1e-5


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) → (B·nW, ws², C), windows image-major, row-major."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)


def window_reverse(windows: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    """The inverse of :func:`window_partition`."""
    b = windows.shape[0] // ((h // ws) * (w // ws))
    x = windows.reshape(b, h // ws, w // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


@functools.lru_cache(maxsize=None)
def relative_position_index(ws: int) -> np.ndarray:
    """(ws², ws²) index into the ((2·ws − 1)², H) bias table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


@functools.lru_cache(maxsize=None)
def shift_attn_mask(h: int, w: int, ws: int, shift: int) -> np.ndarray:
    """(nW, ws², ws²) additive mask of shifted-window attention: −100 between
    tokens of different regions of the rolled image, 0 within one."""
    img = np.zeros((h, w), np.float32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, wsl] = cnt
            cnt += 1
    win = img.reshape(h // ws, ws, w // ws, ws).transpose(0, 2, 1, 3).reshape(-1, ws * ws)
    diff = win[:, None, :] - win[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _on(device: torch.device, table, *key) -> torch.Tensor:
    """One device copy of the constant ``table(*key)``, made once, and
    outside inference mode, so that a forward that needs a gradient may
    save it for the backward."""
    with torch.inference_mode(False):
        return torch.from_numpy(table(*key).copy()).to(device)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int):
        super().__init__()
        self.num_heads = num_heads
        self.window_size = window_size
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))

    def rel_bias(self) -> torch.Tensor:
        """The (H, ws², ws²) f32 relative-position bias, gathered from the
        table (``swin.py:99-106``)."""
        table = self.relative_position_bias_table
        idx = _on(table.device, relative_position_index, self.window_size).reshape(-1)
        n = self.window_size ** 2
        return table[idx].reshape(n, n, self.num_heads).permute(2, 0, 1).float().contiguous()

    def forward(self, y: torch.Tensor, mask, num_windows: int) -> torch.Tensor:
        """The unfused branch on normalized windows y (B·nW, N, C), working
        type: q/k/v product + bias, K9, proj + bias."""
        bnw, n, c = y.shape
        qkv = torch.matmul(y, self.qkv.weight.t()) + self.qkv.bias.to(y.dtype)
        qkv = qkv.view(bnw, n, 3, self.num_heads, c // self.num_heads)
        out = window_mha(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], self.rel_bias(), mask,
                         num_windows=num_windows).reshape(bnw, n, c)
        return torch.matmul(out, self.proj.weight.t()) + self.proj.bias.to(y.dtype)

    def forward_fused(self, x: torch.Tensor, norm: nn.LayerNorm, mask,
                      num_windows: int) -> torch.Tensor:
        """K6: ``x + proj(attn(LN(x)))`` on pre-norm windows x."""
        return window_block_qkv(x, norm.weight, norm.bias, self.qkv.weight, self.qkv.bias,
                                self.proj.weight, self.proj.bias, self.rel_bias(), mask,
                                num_heads=self.num_heads, num_windows=num_windows,
                                eps=LN_EPS)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


class SwinBlock(nn.Module):
    """One block at a stage's ``resolution``: the window shrinks to the
    resolution where that is smaller, and the shift is then 0
    (``swin.py:176-177``)."""

    def __init__(self, dim: int, num_heads: int, resolution: int, window_size: int = 7,
                 shift: int = 0, mlp_ratio: float = 4.0, drop_path: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.ws = min(window_size, resolution)
        self.shift = shift if self.ws < resolution else 0
        self.dtype = dtype
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = WindowAttention(dim, num_heads, self.ws)
        self.drop_path = DropPath(drop_path)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        itemsize = torch.empty((), dtype=dtype).element_size()
        self.fused = block_kernel_head_groups(dim, num_heads, itemsize) is not None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        ws, shift = self.ws, self.shift
        mask = _on(x.device, shift_attn_mask, h, w, ws, shift) if shift else None
        nw = 1 if mask is None else mask.shape[0]
        if self.fused:
            y = torch.roll(x, (-shift, -shift), (1, 2)) if shift else x
            out = self.attn.forward_fused(window_partition(y, ws), self.norm1, mask, nw)
            y = window_reverse(out, ws, h, w)
            # the residual is inside K6; roll(x) + roll(dy) == roll(x + dy)
            x = torch.roll(y, (shift, shift), (1, 2)) if shift else y
        else:
            y = layer_norm(x, self.norm1.weight, self.norm1.bias, LN_EPS, self.dtype)
            if shift:
                y = torch.roll(y, (-shift, -shift), (1, 2))
            y = window_reverse(self.attn(window_partition(y, ws), mask, nw), ws, h, w)
            if shift:
                y = torch.roll(y, (shift, shift), (1, 2))
            x = x + self.drop_path(y)
        fc1, fc2 = self.mlp.fc1, self.mlp.fc2
        return mlp(x, fc1.weight, fc1.bias, fc2.weight, fc2.bias,
                   ln=(self.norm2.weight, self.norm2.bias), ln_eps=LN_EPS, residual=x)


class PatchMerging(nn.Module):
    """2×2 neighbours concatenated in Microsoft's order, LayerNorm,
    a product without bias (``swin.py:284-297``)."""

    def __init__(self, dim: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.norm = nn.LayerNorm(4 * dim, eps=LN_EPS)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]],
                      dim=-1)
        x = layer_norm(x, self.norm.weight, self.norm.bias, LN_EPS, self.dtype)
        return torch.matmul(x, self.reduction.weight.t())


class PatchEmbed(nn.Module):
    def __init__(self, embed_dim: int):
        super().__init__()
        self.proj = PatchifyConv(3, embed_dim, 4)
        self.norm = nn.LayerNorm(embed_dim, eps=LN_EPS)


class Stage(nn.Module):
    def __init__(self, blocks: list, downsample):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.downsample = downsample


class SwinTransformer(nn.Module):
    """Swin on normalized NHWC images → (N, num_classes) float32 logits."""

    def __init__(self, embed_dim: int = 128, depths: Sequence[int] = (2, 2, 18, 2),
                 num_heads: Sequence[int] = (4, 8, 16, 32), window_size: int = 7,
                 num_classes: int = 1000, drop_path: float = 0.1, img_size: int = 224,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.num_classes = num_classes
        self.embed_dim = embed_dim
        self.depths = tuple(depths)
        self.num_heads = tuple(num_heads)
        self.window_size = window_size
        self.patch_embed = PatchEmbed(embed_dim)
        total = sum(depths)
        layers, bi = [], 0
        for si, (depth, heads) in enumerate(zip(depths, num_heads)):
            dim = embed_dim * 2 ** si
            res = img_size // 4 // 2 ** si
            blocks = []
            for di in range(depth):
                blocks.append(SwinBlock(dim, heads, res, window_size,
                                        0 if di % 2 == 0 else window_size // 2,
                                        drop_path=drop_path * bi / max(total - 1, 1),
                                        dtype=dtype))
                bi += 1
            merge = PatchMerging(dim, dtype) if si < len(depths) - 1 else None
            layers.append(Stage(blocks, merge))
        self.layers = nn.ModuleList(layers)
        features = embed_dim * 2 ** (len(depths) - 1)
        self.norm = nn.LayerNorm(features, eps=LN_EPS)
        self.head = nn.Linear(features, num_classes)
        for m in self.modules():
            if isinstance(m, (WindowAttention, Mlp, PatchMerging)):
                for lin in m.children():
                    if isinstance(lin, nn.Linear):
                        lin.weight.data = lin.weight.data.to(dtype)
        proj = self.patch_embed.proj
        proj.weight.data = proj.weight.data.to(dtype)

    def blocks(self) -> list:
        return [blk for stage in self.layers for blk in stage.blocks]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) normalized → (N, num_classes) float32 logits."""
        with full_f32():
            pe = self.patch_embed
            x = pe.proj(x, self.dtype)
            x = layer_norm(x, pe.norm.weight, pe.norm.bias, LN_EPS, self.dtype)
            for stage in self.layers:
                for blk in stage.blocks:
                    x = blk(x)
                if stage.downsample is not None:
                    x = stage.downsample(x)
            x = layer_norm(x, self.norm.weight, self.norm.bias, LN_EPS, self.dtype)
            x = x.mean(dim=(1, 2)).float()
            return torch.matmul(x, self.head.weight.t()) + self.head.bias


@torch.no_grad()
def init_swin(model: SwinTransformer, generator: torch.Generator, probe: bool = False) -> None:
    """Random weights from ``generator`` by the JAX package's initializers
    (:func:`init_lecun`, then the bias tables truncated normal, std 0.02,
    cut at two std). ``probe`` draws the tables from N(0, 1) instead, so
    that an error in the bias path reaches the logits."""
    init_lecun(model, generator)
    for blk in model.blocks():
        table = blk.attn.relative_position_bias_table
        t = torch.empty(table.shape)
        if probe:
            t.normal_(generator=generator)
        else:
            nn.init.trunc_normal_(t, std=0.02, a=-0.04, b=0.04, generator=generator)
        table.copy_(t)


def _swin(embed_dim, depths, heads, **kw):
    kw.pop("bn", None)  # reference bn{use_sync_bn}: Swin has none
    return SwinTransformer(embed_dim=embed_dim, depths=depths, num_heads=heads, **kw)


def swin_tiny(**kw):
    return _swin(96, (2, 2, 6, 2), (3, 6, 12, 24), **kw)


def swin_small(**kw):
    return _swin(96, (2, 2, 18, 2), (3, 6, 12, 24), **kw)


def swin_base(**kw):
    return _swin(128, (2, 2, 18, 2), (4, 8, 16, 32), **kw)


def swin_base_384(**kw):
    """Swin-B at 384² with window 12 (upstream
    ``swin_base_patch4_window12_384``; JAX ``registry.py:136-143``): stage
    0 has 64 windows of 144 tokens an image, shifted by 6; stage 3 is one
    12 × 12 window with no shift."""
    kw.setdefault("window_size", 12)
    return swin_base(**kw)
