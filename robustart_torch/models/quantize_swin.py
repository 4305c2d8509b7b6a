"""int8 post-training quantization of Swin Transformer for eval.

Counterpart of ``robustart_tpu/models/quantize_swin.py``; the names are its
own. As in the ViT path (``quantize_vit.py``), the dense products (q/k/v,
the attention's proj, the MLP's fc1 and fc2, patch merging's reduction) run
int8 × int8 → int32; LayerNorm, the window-attention core, GELU, the
residual adds and the head stay float (bf16 in int8 mode). LN emits int8 at
the next dense's scale, so roll and window partition move 1-byte elements.

Attention in int8 mode is K9 (``ops/attention.py::window_mha``) in every
block, with the relative-position bias and, in shifted blocks, the shift
mask: the hand-written kernel where the tensors are on CUDA, its plain
version on the CPU. Calibration runs the plain version in float32. The bias
is gathered from each block's table once, at quantize time, as a dense
(H, N, N) f32 block.

**The patch embedding is exact** (up to weight rounding): a 4×4 stride-4
VALID convolution reads the int8 grid with the uint8-grid folding.

q/k/v are packed 3-major, as the port's float Swin packs them
(``models/convert.py::quantized_from_flax`` reorders a JAX ``qparams``), and
patch merging concatenates the 2×2 neighbours in the JAX package's order
``[x(0,0), x(0,1), x(1,0), x(1,1)]``, so that each requantized activation
is the JAX forward's (:func:`merge_order` reorders the float Swin's
Microsoft-ordered merge weights).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import torch
import torch.nn.functional as F

from robustart_torch.models.layers import full_f32
from robustart_torch.models.quantize import (
    Int8Model,
    calibration_batches,
    exact_patch_fold,
    running_max,
)
from robustart_torch.models.quantize_vit import (
    linear_entry,
    norm_entry,
    quantize_dense,
    transformer_scales,
)
from robustart_torch.models.swin import (
    SwinTransformer,
    _on,
    shift_attn_mask,
    window_partition,
    window_reverse,
)
from robustart_torch.ops.attention import window_mha, window_mha_reference
from robustart_torch.ops.quant import (
    conv_i8_packed,
    dense_i8,
    ln_f32,
    pack_conv,
    quantize_weight_per_channel,
    requantize,
)

LN_EPS = 1e-5


def merge_order(v: torch.Tensor) -> torch.Tensor:
    """Swap the middle two of four equal groups along the first axis:
    Microsoft's patch-merge order ↔ the JAX package's (its own inverse)."""
    c = v.shape[0] // 4
    return torch.cat([v[:c], v[2 * c:3 * c], v[c:2 * c], v[3 * c:]])


def _ln(x, p, eps=LN_EPS, out_dtype=torch.float32):
    return ln_f32(x, p, eps, out_dtype)


def _forward(qp, cfg, x, *, mode: str, packed=None):
    """Shared float-calibration / int8 forward.

    mode='calib': ``x`` = normalized f32 image, float weights; returns
    (logits, amax dict). mode='int8': ``x`` = the int8 grid ``k − 128``,
    ``packed`` the patch kernel in the product's layout. ``cfg`` =
    (embed_dim, depths, num_heads, window_size).
    """
    embed_dim, depths, num_heads, window_size = cfg
    amax = {}
    adt = torch.bfloat16 if mode == "int8" else torch.float32

    def dense(a, site, name):
        e = qp[name]
        if mode == "calib":
            amax[site] = a.abs().amax()
            y = torch.matmul(a, e["w"].t())
            return y if e["b"] is None else y + e["b"]
        if a.dtype != torch.int8:  # the LN before it emitted int8 already
            a = requantize(a.float(), qp["inv_scale"][site])
        return dense_i8(a, e, qp["scale"][site]).to(adt)

    def ln_q(x, p, site):
        if mode == "calib":
            return _ln(x, p)
        return requantize(_ln(x, p), qp["inv_scale"][site])

    e = qp["patch_embed"]
    if mode == "calib":
        x = F.conv2d(x.permute(0, 3, 1, 2), e["w"].permute(3, 2, 0, 1), e["b"],
                     stride=4).permute(0, 2, 3, 1)
    else:
        x = conv_i8_packed(x, packed, 4).float() * e["sw"] + e["b"]
    x = _ln(x, qp["patch_norm"], out_dtype=adt)

    attention = window_mha if mode == "int8" else window_mha_reference
    res = x.shape[1]
    for si, (depth, heads) in enumerate(zip(depths, num_heads)):
        dim = embed_dim * 2 ** si
        if si > 0:  # the 2×2 neighbours in the JAX package's order
            bsz, h, w, c = x.shape
            x = x.reshape(bsz, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
            x = x.reshape(bsz, h // 2, w // 2, 4 * c)
            y = ln_q(x, qp[f"merge_norm{si}"], f"merge{si}_in")
            x = dense(y, f"merge{si}_in", f"merge_reduction{si}")
            res //= 2
        ws = min(window_size, res)
        head_dim = dim // heads
        for di in range(depth):
            pre = f"stage{si}_block{di}"
            shift = window_size // 2 if di % 2 == 1 and ws < res else 0
            b, h, w, c = x.shape
            mask = _on(x.device, shift_attn_mask, h, w, ws, shift) if shift else None
            nw = 1 if mask is None else mask.shape[0]
            y = ln_q(x, qp[f"{pre}/norm1"], f"{pre}.qkv_in")
            if shift:
                y = torch.roll(y, (-shift, -shift), (1, 2))
            n = ws * ws
            qkv = dense(window_partition(y, ws), f"{pre}.qkv_in", f"{pre}/attn/qkv")
            qkv = qkv.view(-1, n, 3, heads, head_dim)
            out = attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], qp[f"{pre}/rel_bias"],
                            mask, num_windows=nw).reshape(-1, n, c)
            y = window_reverse(dense(out, f"{pre}.proj_in", f"{pre}/attn/proj"), ws, h, w)
            if shift:
                y = torch.roll(y, (shift, shift), (1, 2))
            x = x + y.to(adt)
            y = ln_q(x, qp[f"{pre}/norm2"], f"{pre}.fc1_in")
            hdn = F.gelu(dense(y, f"{pre}.fc1_in", f"{pre}/mlp_fc1")).to(adt)
            x = x + dense(hdn, f"{pre}.fc2_in", f"{pre}/mlp_fc2")

    x = _ln(x, qp["norm"])
    pooled = x.mean(dim=(1, 2)).float()
    return torch.matmul(pooled, qp["head"]["weight"].t()) + qp["head"]["bias"], amax


@dataclasses.dataclass
class QuantizedSwin(Int8Model):
    """int8 eval-only Swin."""

    name: str
    qparams: Any
    embed_dim: int
    depths: tuple
    num_heads: tuple
    window_size: int
    mean: Sequence[float]
    std: Sequence[float]
    num_classes: int = 1000
    input_size: int = 224

    def __post_init__(self):
        self.packed = pack_conv(self.qparams["patch_embed"]["w"])

    def forward_i8(self, x_i8: torch.Tensor) -> torch.Tensor:
        cfg = (self.embed_dim, self.depths, self.num_heads, self.window_size)
        with full_f32():
            return _forward(self.qparams, cfg, x_i8, mode="int8", packed=self.packed)[0]


@torch.no_grad()
def quantize_swin(clf, calib_images, calib_batch_size: int = 64) -> QuantizedSwin:
    """Build the int8 eval path from a float Swin :class:`Classifier`, on its
    device."""
    module = clf.model
    if not isinstance(module, SwinTransformer):
        raise ValueError(f"quantize_swin supports SwinTransformer; got {type(module).__name__}")
    pe = module.patch_embed
    qp: dict = {
        "patch_embed": {"w": pe.proj.weight.detach().float().permute(2, 3, 1, 0),
                        "b": pe.proj.bias.detach().float()},
        "patch_norm": norm_entry(pe.norm),
        "norm": norm_entry(module.norm),
        "head": {"weight": module.head.weight.detach().float(),
                 "bias": module.head.bias.detach().float()},
    }
    for si, stage in enumerate(module.layers):
        if si > 0:  # Microsoft's merge order → the JAX package's
            merge = module.layers[si - 1].downsample
            qp[f"merge_norm{si}"] = {k: merge_order(v) for k, v in
                                     norm_entry(merge.norm).items()}
            qp[f"merge_reduction{si}"] = {"w": merge_order(merge.reduction.weight.detach()
                                                           .float().t()).t(), "b": None}
        for di, blk in enumerate(stage.blocks):
            pre = f"stage{si}_block{di}"
            qp[f"{pre}/norm1"] = norm_entry(blk.norm1)
            qp[f"{pre}/norm2"] = norm_entry(blk.norm2)
            for sub, lin in (("attn/qkv", blk.attn.qkv), ("attn/proj", blk.attn.proj),
                             ("mlp_fc1", blk.mlp.fc1), ("mlp_fc2", blk.mlp.fc2)):
                qp[f"{pre}/{sub}"] = linear_entry(lin)
            qp[f"{pre}/rel_bias"] = blk.attn.rel_bias()
    cfg = (module.embed_dim, module.depths, module.num_heads, module.window_size)

    amax = None
    device = qp["patch_embed"]["w"].device
    with full_f32():
        for x in calibration_batches(calib_images, calib_batch_size, device, clf.mean,
                                     clf.std):
            amax = running_max(amax, _forward(qp, cfg, x, mode="calib")[1])
    qp.update(transformer_scales(amax))

    for key in [k for k in qp if "/attn/" in k or "/mlp_" in k or k.startswith("merge_red")]:
        qp[key] = quantize_dense(qp[key])
    w2, b2, _ = exact_patch_fold(qp["patch_embed"]["w"], qp["patch_embed"]["b"], clf.mean,
                                 clf.std)
    w_q, sw = quantize_weight_per_channel(w2)
    qp["patch_embed"] = {"w": w_q, "sw": sw, "b": b2}
    return QuantizedSwin(
        name=f"{clf.name}@int8", qparams=qp, embed_dim=cfg[0], depths=cfg[1],
        num_heads=cfg[2], window_size=cfg[3], mean=clf.mean, std=clf.std,
        num_classes=clf.num_classes, input_size=clf.input_size,
    )
