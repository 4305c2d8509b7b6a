"""CLIP ViT-L/14's visual tower as an ImageNet classifier: ``clip_vit_l_14``
and its robust fine-tunes ``clip_vit_l_14_fare2_clip`` and
``clip_vit_l_14_tecoa2_clip`` (the same architecture, other weights).

Counterpart of ``robustart_tpu/models/clip_vit.py``: patch 14, width 1024,
depth 24, 16 heads of 64, pre-LN blocks with LN eps 1e-5 and quick_gelu, the
class and position embeddings, ``ln_pre``, ``ln_post`` on the CLS token,
the projection to the 768-d joint space, and a zero-shot head: the
L2-normalized features in float32 against ``zero_shot_weights`` (embed_dim,
num_classes) normalized per column, scaled by ``exp(logit_scale)``.

Parameter names are OpenAI's (``visual.conv1``, ``visual.class_embedding``,
``visual.positional_embedding``, ``visual.ln_pre``,
``visual.transformer.resblocks.i.{ln_1, attn.in_proj_weight,
attn.in_proj_bias, attn.out_proj, ln_2, mlp.c_fc, mlp.c_proj}``,
``visual.ln_post``, ``visual.proj``, ``logit_scale``), q/k/v packed 3-major
as ``nn.MultiheadAttention`` packs it, so an OpenAI, FARE² or TeCoA²
checkpoint loads through ``saver.pretrain.path`` as it is; a raw OpenAI
checkpoint has no classifier, and ``saver.pretrain.clip_zero_shot`` builds
``zero_shot_weights`` from its text tower (``models/clip_text.py``,
``models/convert.py::load_clip_zero_shot``). ``models/convert.py`` maps the
JAX package's variables onto the same keys.

Each block follows the JAX module's dispatch (``clip_vit.py:54-123``):

- where ``block_kernel_head_groups(C, H, itemsize)`` is not None (CLIP-L:
  two head groups in bf16, four in f32) the attention half is the fused
  block kernel K6 (``ops/attention.py::window_block_qkv``): one 257-token
  window an image, no relative bias (the JAX module passes a zero (H, 1, 1)
  bias, which adds nothing), LN eps 1e-5;
- elsewhere it is LN, the packed q/k/v product + bias in the working type,
  the attention kernel K8 (``ops/attention.py::mha``), proj + bias and the
  residual;
- the MLP half is always K7 (``ops/mlp.py::mlp``) with the LN prologue,
  ``act="quick_gelu"``, eps 1e-5 and the raw-x residual.

``dtype=torch.bfloat16`` keeps the patch, q/k/v, proj and MLP weights in
bf16 and computes there; biases, LayerNorm parameters, the embeddings,
``proj``, the head and ``logit_scale`` stay float32, as in the JAX package.
The forward is eval only.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from robustart_torch.models.layers import PatchifyConv, full_f32, init_lecun, layer_norm
from robustart_torch.ops.attention import block_kernel_head_groups, mha, window_block_qkv
from robustart_torch.ops.mlp import mlp

LN_EPS = 1e-5


class CLIPAttention(nn.Module):
    """``nn.MultiheadAttention``'s parameters: ``in_proj_weight`` (3C, C),
    rows [q; k; v], ``in_proj_bias`` (3C,), ``out_proj``."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        """The unfused branch on the normalized input y (working type)."""
        b, n, c = y.shape
        qkv = torch.matmul(y, self.in_proj_weight.t()) + self.in_proj_bias.to(y.dtype)
        qkv = qkv.view(b, n, 3, self.num_heads, c // self.num_heads)
        out = mha(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]).reshape(b, n, c)
        return torch.matmul(out, self.out_proj.weight.t()) + self.out_proj.bias.to(y.dtype)


class CLIPMlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.c_fc = nn.Linear(dim, hidden)
        self.c_proj = nn.Linear(hidden, dim)


class CLIPEncoderBlock(nn.Module):
    """OpenAI's ``ResidualAttentionBlock``: ``x + attn(ln_1(x))``, then
    ``x + mlp(ln_2(x))``."""

    def __init__(self, dim: int, num_heads: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.ln_1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = CLIPAttention(dim, num_heads)
        self.ln_2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = CLIPMlp(dim, 4 * dim)
        self.dtype = dtype
        itemsize = torch.empty((), dtype=dtype).element_size()
        self.fused = block_kernel_head_groups(dim, num_heads, itemsize) is not None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        attn, ln1, ln2 = self.attn, self.ln_1, self.ln_2
        if self.fused:
            x = window_block_qkv(x, ln1.weight, ln1.bias, attn.in_proj_weight, attn.in_proj_bias,
                                 attn.out_proj.weight, attn.out_proj.bias,
                                 num_heads=attn.num_heads, eps=LN_EPS)
        else:
            x = x + attn(layer_norm(x, ln1.weight, ln1.bias, LN_EPS, self.dtype))
        fc, proj = self.mlp.c_fc, self.mlp.c_proj
        return mlp(x, fc.weight, fc.bias, proj.weight, proj.bias, ln=(ln2.weight, ln2.bias),
                   ln_eps=LN_EPS, residual=x, act="quick_gelu")


class CLIPTransformer(nn.Module):
    def __init__(self, width: int, depth: int, num_heads: int, dtype: torch.dtype):
        super().__init__()
        self.resblocks = nn.ModuleList([CLIPEncoderBlock(width, num_heads, dtype)
                                        for _ in range(depth)])


class CLIPVisual(nn.Module):
    """OpenAI's ``VisionTransformer`` (the ``visual`` tower)."""

    def __init__(self, patch_size: int, width: int, depth: int, num_heads: int,
                 embed_dim: int, img_size: int, dtype: torch.dtype):
        super().__init__()
        self.conv1 = PatchifyConv(3, width, patch_size, bias=False)
        tokens = (img_size // patch_size) ** 2 + 1
        self.class_embedding = nn.Parameter(torch.zeros(width))
        self.positional_embedding = nn.Parameter(torch.zeros(tokens, width))
        self.ln_pre = nn.LayerNorm(width, eps=LN_EPS)
        self.transformer = CLIPTransformer(width, depth, num_heads, dtype)
        self.ln_post = nn.LayerNorm(width, eps=LN_EPS)
        self.proj = nn.Parameter(torch.zeros(width, embed_dim))


class CLIPVisionClassifier(nn.Module):
    """CLIP's visual tower and zero-shot head on normalized NHWC images →
    (N, num_classes) float32 logits."""

    def __init__(self, patch_size: int = 14, width: int = 1024, depth: int = 24,
                 num_heads: int = 16, embed_dim: int = 768, num_classes: int = 1000,
                 img_size: int = 224, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.num_classes = num_classes
        self.width = width
        self.num_heads = num_heads
        self.visual = CLIPVisual(patch_size, width, depth, num_heads, embed_dim, img_size, dtype)
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1 / 0.07)))
        self.zero_shot_weights = nn.Parameter(torch.zeros(embed_dim, num_classes))
        for blk in self.blocks():
            blk.attn.in_proj_weight.data = blk.attn.in_proj_weight.data.to(dtype)
            for lin in (blk.attn.out_proj, blk.mlp.c_fc, blk.mlp.c_proj):
                lin.weight.data = lin.weight.data.to(dtype)
        self.visual.conv1.weight.data = self.visual.conv1.weight.data.to(dtype)

    def blocks(self) -> list:
        return list(self.visual.transformer.resblocks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) normalized → (N, num_classes) float32 logits."""
        v = self.visual
        with full_f32():
            x = v.conv1(x, self.dtype)
            b = x.shape[0]
            x = x.reshape(b, -1, x.shape[-1])
            cls = v.class_embedding.to(x.dtype).expand(b, 1, -1)
            x = torch.cat([cls, x], dim=1) + v.positional_embedding.to(x.dtype)
            x = layer_norm(x, v.ln_pre.weight, v.ln_pre.bias, LN_EPS, self.dtype)
            for blk in self.blocks():
                x = blk(x)
            x = layer_norm(x[:, 0], v.ln_post.weight, v.ln_post.bias, LN_EPS, self.dtype)
            feats = torch.matmul(x.float(), v.proj.float())
            feats = feats / feats.norm(dim=-1, keepdim=True)
            w = self.zero_shot_weights.float()
            w = w / w.norm(dim=0, keepdim=True)
            return self.logit_scale.exp() * torch.matmul(feats, w)


@torch.no_grad()
def init_clip(model: CLIPVisionClassifier, generator: torch.Generator) -> None:
    """Random weights from ``generator`` by the JAX package's initializers:
    :func:`init_lecun` (the patch conv, out_proj, c_fc, c_proj; LayerNorm at
    identity), the packed q/k/v weights of std 1/√C with zero bias, the
    embeddings and ``proj`` normal(width^-0.5), ``zero_shot_weights``
    normal(0.02) and ``logit_scale`` log(1/0.07)."""
    init_lecun(model, generator)
    for blk in model.blocks():
        w = blk.attn.in_proj_weight
        w.copy_(torch.randn(w.shape, generator=generator) / math.sqrt(w.shape[1]))
        blk.attn.in_proj_bias.zero_()
    v = model.visual
    for p in (v.class_embedding, v.positional_embedding, v.proj):
        p.copy_(torch.randn(p.shape, generator=generator) * model.width ** -0.5)
    zs = model.zero_shot_weights
    zs.copy_(torch.randn(zs.shape, generator=generator) * 0.02)
    model.logit_scale.fill_(math.log(1 / 0.07))


def clip_vit_l_14(**kw):
    kw.pop("bn", None)  # reference bn{use_sync_bn}: CLIP has none
    return CLIPVisionClassifier(**kw)


# the robust fine-tunes share the architecture; their checkpoints differ
clip_vit_l_14_fare2_clip = clip_vit_l_14
clip_vit_l_14_tecoa2_clip = clip_vit_l_14
