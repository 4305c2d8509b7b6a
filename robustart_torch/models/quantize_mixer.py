"""int8 post-training quantization of the MLP-Mixer for eval.

Counterpart of ``robustart_tpu/models/quantize_mixer.py``. Every dense layer
of the token and channel MLPs runs int8 × int8 → int32
(``ops/quant.py::dense_i8``); LayerNorm, GELU and the residual adds stay
float, bf16 in int8 mode. Each LayerNorm emits int8 at its site's scale
directly, so the token-mixing (B, T, C) → (B, C, T) transpose moves int8
(a per-tensor scale does not care about the transpose). The token MLP's
fc2 has N = T outputs (196 at 224 px) and its fc1 K = T inputs, which
``int_mm`` pads to a multiple of 8. The patch stem is exact on the uint8
grid (``quantize.py``).

The float Mixer's kernels K10 and K7 are not on this path: the JAX int8
forward uses neither, and neither does this one. The JAX package refuses
the family without ``model.quantize_force`` (``solvers/base.py``).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from robustart_torch.models.mlp_mixer import MlpMixer
from robustart_torch.models.quantize_net import (
    Int8Ops,
    QuantizedNet,
    biased,
    dense_entry,
    linear,
)
from robustart_torch.models.quantize_vit import norm_entry
from robustart_torch.ops.quant import ln_f32

LN_EPS = 1e-6


def _spec(module: MlpMixer):
    """(depth, patch)."""
    return len(module.blocks), module.stem.proj.kernel_size[0]


def _forward(ops: Int8Ops, spec, x: torch.Tensor) -> torch.Tensor:
    depth, patch = spec
    qp = ops.qp
    adt = torch.float32 if ops.calib else torch.bfloat16

    def ln_q(x, key, site):
        """LN, emitting int8 at ``site``'s scale in int8 mode."""
        y = ln_f32(x, qp[key], LN_EPS)
        return y if ops.calib else ops.site(site, y)

    x = ops.stem(x, "stem", patch, 0).to(adt)
    x = x.reshape(x.shape[0], -1, x.shape[-1])
    for i in range(depth):
        pre = f"block{i}"
        # token mixing over the token axis (requantized before the transpose)
        y = ln_q(x, f"{pre}/norm1", f"b{i}.tok1_in").transpose(1, 2)
        h = F.gelu(ops.dense(y, f"b{i}.tok1_in", f"{pre}/tok/fc1", adt)).to(adt)
        t = ops.dense(h, f"b{i}.tok2_in", f"{pre}/tok/fc2", adt)
        x = x + t.transpose(1, 2).to(adt)
        # channel mixing
        y = ln_q(x, f"{pre}/norm2", f"b{i}.ch1_in")
        h = F.gelu(ops.dense(y, f"b{i}.ch1_in", f"{pre}/ch/fc1", adt)).to(adt)
        x = x + ops.dense(h, f"b{i}.ch2_in", f"{pre}/ch/fc2", adt)
    x = ln_f32(x, qp["norm"], LN_EPS).mean(dim=1)
    return linear(x, qp["head"])


def _dense(spec) -> list:
    return [f"block{i}/{m}/{fc}" for i in range(spec[0]) for m in ("tok", "ch")
            for fc in ("fc1", "fc2")]


@dataclasses.dataclass
class QuantizedMixer(QuantizedNet):
    """int8 eval-only MLP-Mixer."""

    spec_of = staticmethod(_spec)
    conv_list = staticmethod(lambda spec: [("stem", 1)])
    dense_list = staticmethod(_dense)
    forward_fn = staticmethod(_forward)


@torch.no_grad()
def quantize_mixer(clf, calib_images, calib_batch_size: int = 64) -> QuantizedMixer:
    """Build the int8 eval path from a float MLP-Mixer :class:`Classifier`,
    on its device."""
    module = clf.model
    if not isinstance(module, MlpMixer):
        raise ValueError(f"quantize_mixer supports MlpMixer; got {type(module).__name__}")
    qp = {"norm": norm_entry(module.norm), "head": dense_entry(module.head),
          "stem": biased(module.stem.proj)}
    for i, blk in enumerate(module.blocks):
        qp[f"block{i}/norm1"] = norm_entry(blk.norm1)
        qp[f"block{i}/norm2"] = norm_entry(blk.norm2)
        for sub, mlp in (("tok", blk.mlp_tokens), ("ch", blk.mlp_channels)):
            qp[f"block{i}/{sub}/fc1"] = dense_entry(mlp.fc1)
            qp[f"block{i}/{sub}/fc2"] = dense_entry(mlp.fc2)
    return QuantizedMixer.build(clf, qp, calib_images, calib_batch_size)
