"""int8 post-training quantization of the ViT/DeiT family for eval.

Counterpart of ``robustart_tpu/models/quantize_vit.py``; the names are its
own. The dense products (q/k/v, the attention's proj, the MLP's fc1 and
fc2) run int8 × int8 → int32 (``ops/quant.py::dense_i8``); LayerNorm, the
attention core, GELU, the residual adds and the head stay float, and every
float-side activation is bf16 in int8 mode, as the JAX package keeps them.
Each activation is requantized per tensor just before its dense; the LN
before q/k/v and fc1 emits int8 at that site's scale directly.

Attention in int8 mode is K8 (``ops/attention.py::mha``) on the bf16
q/k/v: the hand-written kernel where the tensors are on CUDA, its plain
version on the CPU (the JAX package's rule ``pallas = backend == "tpu"``).
Calibration runs the plain version in float32, as the JAX package's does.

**The patch embedding is exact** (up to weight rounding), as the ResNet
stem: a stride-p VALID convolution of normalized pixels reads the int8 grid
``k − 128`` with ``1/(255·std_c)`` and the mean's shift folded in.

q/k/v are packed 3-major, as torch packs them (the port's float ViT), where
the JAX package packs them head-major; ``models/convert.py::
quantized_from_flax`` reorders a JAX ``qparams``' columns. Dense weights are
(N, K), nn.Linear's layout.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from robustart_torch.models.layers import full_f32
from robustart_torch.models.quantize import (
    Int8Model,
    calibration_batches,
    exact_patch_fold,
    running_max,
)
from robustart_torch.models.vit import VisionTransformer
from robustart_torch.ops.attention import mha, mha_reference
from robustart_torch.ops.quant import (
    conv_i8_packed,
    dense_i8,
    ln_f32,
    pack_conv,
    quantize_weight_per_channel,
    requantize,
)

LN_EPS = 1e-6


def _ln(x, p, eps=LN_EPS, out_dtype=torch.float32):
    return ln_f32(x, p, eps, out_dtype)


def _forward(qp, cfg, x, *, mode: str, packed=None):
    """Shared float-calibration / int8 forward.

    mode='calib': ``x`` is the normalized f32 image, ``qp`` holds float
    weights; returns (logits, amax dict). mode='int8': ``x`` is the int8
    grid ``k − 128``, ``qp`` the int8 parameters and ``packed`` the patch
    kernel in the product's layout. ``cfg`` = (depth, num_heads, patch).
    """
    depth, num_heads, patch = cfg
    amax = {}
    adt = torch.bfloat16 if mode == "int8" else torch.float32

    def dense(a, site, name):
        e = qp[name]
        if mode == "calib":
            amax[site] = a.abs().amax()
            return torch.matmul(a, e["w"].t()) + e["b"]
        if a.dtype != torch.int8:  # the LN before it emitted int8 already
            a = requantize(a.float(), qp["inv_scale"][site])
        return dense_i8(a, e, qp["scale"][site]).to(adt)

    def ln_q(x, p, site):
        if mode == "calib":
            return _ln(x, p)
        return requantize(_ln(x, p), qp["inv_scale"][site])

    e = qp["patch"]
    if mode == "calib":
        x = F.conv2d(x.permute(0, 3, 1, 2), e["w"].permute(3, 2, 0, 1), e["b"],
                     stride=patch).permute(0, 2, 3, 1)
    else:
        y = conv_i8_packed(x, packed, patch).float()
        x = (y * e["sw"] + e["b"]).to(adt)
    b, c = x.shape[0], x.shape[-1]
    x = x.reshape(b, -1, c)
    cls = qp["cls_token"].expand(b, 1, c).to(x.dtype)
    x = (torch.cat([cls, x], dim=1) + qp["pos_embed"]).to(adt)

    n = x.shape[1]
    head_dim = c // num_heads
    attention = mha if mode == "int8" else mha_reference
    for i in range(depth):
        pre = f"block{i}"
        y = ln_q(x, qp[f"{pre}/norm1"], f"b{i}.qkv_in")
        qkv = dense(y, f"b{i}.qkv_in", f"{pre}/attn/qkv").view(b, n, 3, num_heads, head_dim)
        out = attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]).reshape(b, n, c)
        x = x + dense(out, f"b{i}.proj_in", f"{pre}/attn/proj")
        y = ln_q(x, qp[f"{pre}/norm2"], f"b{i}.fc1_in")
        h = F.gelu(dense(y, f"b{i}.fc1_in", f"{pre}/mlp/fc1")).to(adt)
        x = x + dense(h, f"b{i}.fc2_in", f"{pre}/mlp/fc2")

    x = _ln(x, qp["norm"])
    logits = torch.matmul(x[:, 0].float(), qp["head"]["weight"].t()) + qp["head"]["bias"]
    return logits, amax


def transformer_scales(amax: dict) -> dict:
    """{"scale", "inv_scale"} per site as the JAX transformer paths make
    them: ``max(amax, 1e-12) / 127`` and its reciprocal in float64, each
    then rounded to float32 (where the JAX program takes them)."""
    scale = {k: max(float(v), 1e-12) / 127.0 for k, v in amax.items()}
    return {"scale": {k: float(np.float32(v)) for k, v in scale.items()},
            "inv_scale": {k: float(np.float32(1.0 / v)) for k, v in scale.items()}}


def quantize_dense(e: dict) -> dict:
    """A float dense entry {"w" (N, K), "b"} → {"w" int8 (N, K), "sw", "b"}
    (per output feature)."""
    w_q, sw = quantize_weight_per_channel(e["w"].t())
    return {"w": w_q.t().contiguous(), "sw": sw, "b": e["b"]}


def norm_entry(ln) -> dict:
    return {"scale": ln.weight.detach().float(), "bias": ln.bias.detach().float()}


def linear_entry(lin) -> dict:
    b = lin.bias
    return {"w": lin.weight.detach().float(), "b": None if b is None else b.detach().float()}


@dataclasses.dataclass
class QuantizedViT(Int8Model):
    """int8 eval-only ViT."""

    name: str
    qparams: Any
    depth: int
    num_heads: int
    mean: Sequence[float]
    std: Sequence[float]
    num_classes: int = 1000
    input_size: int = 224
    patch_size: int = 16

    def __post_init__(self):
        self.packed = pack_conv(self.qparams["patch"]["w"])

    def forward_i8(self, x_i8: torch.Tensor) -> torch.Tensor:
        with full_f32():
            return _forward(self.qparams, (self.depth, self.num_heads, self.patch_size), x_i8,
                            mode="int8", packed=self.packed)[0]


@torch.no_grad()
def quantize_vit(clf, calib_images, calib_batch_size: int = 64) -> QuantizedViT:
    """Build the int8 eval path from a float ViT :class:`Classifier`, on its
    device."""
    module = clf.model
    if not isinstance(module, VisionTransformer):
        raise ValueError(f"quantize_vit supports VisionTransformer; got {type(module).__name__}")
    depth, num_heads = len(module.blocks), module.num_heads
    proj = module.patch_embed.proj
    patch = proj.kernel_size[0]
    qp: dict = {
        "cls_token": module.cls_token.detach().float(),
        "pos_embed": module.pos_embed.detach().float(),
        "norm": norm_entry(module.norm),
        "head": {"weight": module.head.weight.detach().float(),
                 "bias": module.head.bias.detach().float()},
        "patch": {"w": proj.weight.detach().float().permute(2, 3, 1, 0),
                  "b": proj.bias.detach().float()},
    }
    for i, blk in enumerate(module.blocks):
        qp[f"block{i}/norm1"] = norm_entry(blk.norm1)
        qp[f"block{i}/norm2"] = norm_entry(blk.norm2)
        for sub, lin in (("attn/qkv", blk.attn.qkv), ("attn/proj", blk.attn.proj),
                         ("mlp/fc1", blk.mlp.fc1), ("mlp/fc2", blk.mlp.fc2)):
            qp[f"block{i}/{sub}"] = linear_entry(lin)

    # calibrate on the float graph (plain attention, float32)
    amax = None
    device = qp["patch"]["w"].device
    with full_f32():
        for x in calibration_batches(calib_images, calib_batch_size, device, clf.mean,
                                     clf.std):
            amax = running_max(amax, _forward(qp, (depth, num_heads, patch), x,
                                              mode="calib")[1])
    qp.update(transformer_scales(amax))

    for key in [k for k in qp if k.startswith("block") and "w" in qp[k]]:
        qp[key] = quantize_dense(qp[key])
    # the exact int8 patch embedding (uint8-grid folding, VALID: exact)
    w2, b2, _ = exact_patch_fold(qp["patch"]["w"], qp["patch"]["b"], clf.mean, clf.std)
    w_q, sw = quantize_weight_per_channel(w2)
    qp["patch"] = {"w": w_q, "sw": sw, "b": b2}
    return QuantizedViT(
        name=f"{clf.name}@int8", qparams=qp, depth=depth, num_heads=num_heads,
        mean=clf.mean, std=clf.std, num_classes=clf.num_classes,
        input_size=clf.input_size, patch_size=patch,
    )
