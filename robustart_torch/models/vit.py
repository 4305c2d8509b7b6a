"""Vision Transformer and DeiT: ``vit_b16_224``, ``vit_b32_224``,
``deit_{tiny,small,base}_b16_224``.

Counterpart of ``robustart_tpu/models/vit.py``. Parameter names follow timm
(``patch_embed.proj``, ``cls_token``, ``pos_embed``, ``blocks.N.norm1``,
``blocks.N.attn.qkv`` packed 3-major as torch packs it, ``blocks.N.attn.proj``,
``blocks.N.norm2``, ``blocks.N.mlp.fc1/fc2``, ``norm``, ``head``), so a timm
checkpoint loads through ``saver.pretrain.path`` as it is, and
``models/convert.py`` maps the JAX package's variables onto the same keys.

Each block follows the JAX module's dispatch (``vit.py:188-237``):

- where ``block_kernel_head_groups(C, H, itemsize)`` is not None (ViT-B), the
  attention half is the fused block kernel K6 (``ops/attention.py::
  window_block_qkv`` on the packed q/k/v weights, one 197-token window per
  image, no bias);
- elsewhere (DeiT-Tiny, C = 192) it is LN, the packed q/k/v product, the
  attention kernel K8 (``ops/attention.py::mha``), proj and the residual,
  with the q/k/v and proj biases added in the working type;
- the MLP half is always K7 (``ops/mlp.py::mlp``) with the LN prologue and
  the raw-x residual.

``dtype=torch.bfloat16`` keeps the block and patch-embed weights in bf16
and computes there; biases, LayerNorm parameters, ``cls_token``,
``pos_embed`` and the head stay float32, and the head runs in float32 on the
float32 CLS token, as the JAX package does. The forward is eval only: the
dropout and stochastic-depth rates are accepted for config compatibility.
"""

from __future__ import annotations

import torch
from torch import nn

from robustart_torch.models.layers import DropPath, PatchEmbed, full_f32, init_lecun, layer_norm
from robustart_torch.ops.attention import block_kernel_head_groups, mha, window_block_qkv
from robustart_torch.ops.mlp import mlp

LN_EPS = 1e-6


class MlpBlock(nn.Module):
    def __init__(self, dim: int, hidden_dim: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, dim)

    def forward(self, x: torch.Tensor, ln=None, residual=None) -> torch.Tensor:
        """K7: ``ln=(weight, bias)`` makes x the pre-norm input."""
        return mlp(x, self.fc1.weight, self.fc1.bias, self.fc2.weight, self.fc2.bias,
                   ln=ln, ln_eps=LN_EPS, residual=residual)


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        """The unfused branch on the normalized input y (working type)."""
        b, n, c = y.shape
        qkv = torch.matmul(y, self.qkv.weight.t())
        if self.qkv.bias is not None:
            qkv = qkv + self.qkv.bias.to(y.dtype)
        qkv = qkv.view(b, n, 3, self.num_heads, c // self.num_heads)
        out = mha(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]).reshape(b, n, c)
        return torch.matmul(out, self.proj.weight.t()) + self.proj.bias.to(y.dtype)

    def forward_fused(self, x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
        """K6: ``x + proj(attn(LN(x)))`` on the pre-norm input x."""
        return window_block_qkv(x, norm.weight, norm.bias, self.qkv.weight, self.qkv.bias,
                                self.proj.weight, self.proj.bias, num_heads=self.num_heads,
                                eps=LN_EPS)


class EncoderBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 drop_path: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, num_heads, qkv_bias)
        self.drop_path = DropPath(drop_path)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = MlpBlock(dim, int(dim * mlp_ratio))
        self.dtype = dtype
        itemsize = torch.empty((), dtype=dtype).element_size()
        self.fused = block_kernel_head_groups(dim, num_heads, itemsize) is not None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fused:
            x = self.attn.forward_fused(x, self.norm1)
        else:
            y = layer_norm(x, self.norm1.weight, self.norm1.bias, LN_EPS, self.dtype)
            x = x + self.drop_path(self.attn(y))
        return self.mlp(x, ln=(self.norm2.weight, self.norm2.bias), residual=x)


class VisionTransformer(nn.Module):
    """ViT on normalized NHWC images → (N, num_classes) float32 logits."""

    def __init__(self, patch_size: int = 16, embed_dim: int = 768, depth: int = 12,
                 num_heads: int = 12, mlp_ratio: float = 4.0, num_classes: int = 1000,
                 qkv_bias: bool = True, dropout: float = 0.0, attention_dropout: float = 0.0,
                 drop_path: float = 0.0, img_size: int = 224,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.num_classes = num_classes
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.rates = (float(dropout), float(attention_dropout))  # identity at eval
        self.patch_embed = PatchEmbed(patch_size, 3, embed_dim)
        tokens = (img_size // patch_size) ** 2 + 1
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, tokens, embed_dim))
        # stochastic-depth schedule rising linearly with depth (the timm rule)
        self.blocks = nn.ModuleList([
            EncoderBlock(embed_dim, num_heads, mlp_ratio, qkv_bias,
                         drop_path * i / max(depth - 1, 1), dtype)
            for i in range(depth)
        ])
        self.norm = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.head = nn.Linear(embed_dim, num_classes)
        for blk in self.blocks:
            for lin in (blk.attn.qkv, blk.attn.proj, blk.mlp.fc1, blk.mlp.fc2):
                lin.weight.data = lin.weight.data.to(dtype)
        self.patch_embed.proj.weight.data = self.patch_embed.proj.weight.data.to(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) normalized → (N, num_classes) float32 logits."""
        if self.training and any(self.rates):
            raise NotImplementedError("training is not ported (ROADMAP.md, modules to port: "
                                      "Training)")
        with full_f32():
            x = self.patch_embed(x, self.dtype)
            b = x.shape[0]
            cls = self.cls_token.expand(b, 1, -1).to(x.dtype)
            x = torch.cat([cls, x], dim=1) + self.pos_embed.to(x.dtype)
            for blk in self.blocks:
                x = blk(x)
            x = layer_norm(x, self.norm.weight, self.norm.bias, LN_EPS)
            return torch.matmul(x[:, 0].float(), self.head.weight.t()) + self.head.bias


@torch.no_grad()
def init_vit(model: VisionTransformer, generator: torch.Generator) -> None:
    """Random weights from ``generator`` by the JAX package's initializers:
    :func:`init_lecun`, then ``pos_embed`` truncated normal (std 0.02, cut
    at two std) and ``cls_token`` zero."""
    init_lecun(model, generator)
    pos = torch.empty(model.pos_embed.shape)
    nn.init.trunc_normal_(pos, std=0.02, a=-0.04, b=0.04, generator=generator)
    model.pos_embed.copy_(pos)
    model.cls_token.zero_()


def _vit(patch, dim, depth, heads, **kw):
    kw.pop("bn", None)  # reference bn{use_sync_bn}: a ViT has none
    return VisionTransformer(patch_size=patch, embed_dim=dim, depth=depth, num_heads=heads,
                             **kw)


def vit_b16_224(**kw):
    return _vit(16, 768, 12, 12, **kw)


def vit_b32_224(**kw):
    return _vit(32, 768, 12, 12, **kw)


def deit_tiny_b16_224(**kw):
    return _vit(16, 192, 12, 3, **kw)


def deit_small_b16_224(**kw):
    return _vit(16, 384, 12, 6, **kw)


def deit_base_b16_224(**kw):
    return _vit(16, 768, 12, 12, **kw)
