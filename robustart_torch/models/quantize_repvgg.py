"""int8 post-training quantization of RepVGG, on its deploy form, for eval.

Counterpart of ``robustart_tpu/models/quantize_repvgg.py``. The deploy form
(``models/repvgg.py::reparameterize``, which the solver's ``maybe_deploy``
swaps in) is a chain of 3×3 convolutions with bias and ReLU: each runs int8
× int8 → int32 with an f32 dequant → bias → relu → requantize epilogue; the
head is f32 on the pooled int8 output. The stage-0 stem (3×3/2, padding 1)
is exact on the uint8 grid (``quantize.py``). A train-form model is
re-parameterized first.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from robustart_torch.models.quantize_net import (
    Int8Ops,
    QuantizedNet,
    biased,
    dense_entry,
    linear,
    pooled,
)
from robustart_torch.models.repvgg import RepVGG, reparameterize


@dataclasses.dataclass(frozen=True)
class _Block:
    name: str  # the JAX key, e.g. "stage2_3"
    stride: int
    site_in: str


def _spec(module: RepVGG):
    """The blocks after stage 0 and the head's site (JAX ``_repvgg_spec``)."""
    blocks, cur = [], "stage0"
    for si, n in enumerate(module.num_blocks):
        for bi in range(n):
            name = f"stage{si + 1}_{bi}"
            blocks.append(_Block(name, 2 if bi == 0 else 1, cur))
            cur = name
    return tuple(blocks), cur


def _forward(ops: Int8Ops, spec, x: torch.Tensor) -> torch.Tensor:
    blocks, head_site = spec
    x = ops.site("stage0", F.relu(ops.stem(x, "stage0", 2, 1)))
    for blk in blocks:
        x = ops.site(blk.name, F.relu(ops.conv(x, blk.name, blk.stride, 1, site=blk.site_in)))
    return linear(pooled(ops, x, head_site), ops.qp["fc"])


def _convs(spec) -> list:
    return [("stage0", 1)] + [(b.name, 1) for b in spec[0]]


@dataclasses.dataclass
class QuantizedRepVGG(QuantizedNet):
    """int8 eval-only RepVGG (deploy form)."""

    stem_key = "stage0"
    spec_of = staticmethod(_spec)
    conv_list = staticmethod(_convs)
    forward_fn = staticmethod(_forward)


@torch.no_grad()
def quantize_repvgg(clf, calib_images, calib_batch_size: int = 64) -> QuantizedRepVGG:
    """Build the int8 eval path from a float RepVGG :class:`Classifier`
    (deploy form, or train form, re-parameterized first), on its device."""
    module = clf.model
    if not isinstance(module, RepVGG):
        raise ValueError(f"quantize_repvgg expects the RepVGG family; got "
                         f"{type(module).__name__}")
    module = reparameterize(module)
    qp = {name.replace(".", "_"): biased(block.rbr_reparam) for name, block in module.blocks()}
    qp["fc"] = dense_entry(module.linear)
    return QuantizedRepVGG.build(clf, qp, calib_images, calib_batch_size)
