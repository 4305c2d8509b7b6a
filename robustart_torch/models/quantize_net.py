"""What the int8 families after ResNet, ViT and Swin share: the calibration
and int8 forwards' operations (:class:`Int8Ops`), calibration
(:func:`calibrate`), BatchNorm folding of the port's modules and the
classifier base (:class:`QuantizedNet`).

Each family's ``models/quantize_<family>.py`` writes its forward once, as
the JAX package's ``quantize_<family>.py`` writes ``_forward(qp, ..., mode)``:
run on :class:`Int8Ops` in ``"calib"`` mode it is the folded float network
on normalized images, recording amax at every requantize site; in
``"int8"`` mode it is the int8 network on the grid ``k − 128``. The
parameters (``qparams``) are keyed as the JAX package's are, and the sites
are named as its are, so ``models/convert.py::quantized_from_flax`` carries
a JAX ``qparams`` across by layout alone: convolution weights HWIO, dense
weights (N, K) (nn.Linear's layout; the JAX package's are (K, N)).

The scales are the JAX package's arithmetic for these families:
``max(amax, 1e-12)/127`` and its reciprocal in float64, each then taken in
float32 (``quantize_vit.py::transformer_scales``).
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
from robustart_torch.models.quantize_vit import quantize_dense, transformer_scales
from robustart_torch.ops.quant import (
    conv_i8_packed,
    dense_i8,
    fold_conv_bn,
    pack_conv,
    quantize_weight_per_channel,
    requantize,
)


def conv_f32(x: torch.Tensor, w: torch.Tensor, stride: int = 1, pad: int = 0,
             groups: int = 1) -> torch.Tensor:
    """Float NHWC convolution with an HWIO kernel, no bias (the calibration
    forwards' ``lax.conv_general_dilated``)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), None, stride, pad,
                 groups=groups)
    return y.permute(0, 2, 3, 1)


class Int8Ops:
    """One forward's operations, on ``qp``: in ``"calib"`` mode on float
    weights, recording each site's amax (``amax``); in ``"int8"`` mode on
    int8 weights (``packed``: :func:`~robustart_torch.ops.quant.pack_conv`
    of each convolution), requantizing at each site."""

    def __init__(self, qp: dict, mode: str, packed: dict | None = None):
        self.qp, self.mode, self.packed = qp, mode, packed
        self.calib = mode == "calib"
        self.amax: dict = {}

    def record(self, site: str, t: torch.Tensor) -> torch.Tensor:
        """Calibration: record ``site``'s amax; ``t`` unchanged."""
        if self.calib:
            self.amax[site] = t.abs().amax()
        return t

    def site(self, site: str, t: torch.Tensor) -> torch.Tensor:
        """A requantize site: recorded in calibration, requantized in int8."""
        if self.calib:
            return self.record(site, t)
        return requantize(t, self.qp["inv_scale"][site])

    def int8_in(self, a: torch.Tensor, site: str) -> torch.Tensor:
        """``a`` requantized at ``site`` (in f32) unless it is int8 already."""
        if a.dtype == torch.int8:
            return a
        return requantize(a.float(), self.qp["inv_scale"][site])

    def conv(self, a: torch.Tensor, key: str, stride: int = 1, pad: int = 0, groups: int = 1,
             site: str | None = None) -> torch.Tensor:
        """The convolution ``key`` (+ its bias, where it has one): float in
        calibration; in int8 on ``a`` requantized at ``site`` (unless int8
        already), then ``acc·(scale·sw) [+ b]`` in f32."""
        e = self.qp[key]
        if self.calib:
            y = conv_f32(a, e["w"], stride, pad, groups)
        else:
            a = self.int8_in(a, site)
            y = conv_i8_packed(a, self.packed[key], stride, pad).float()
            y = y * (self.qp["scale"][site] * e["sw"])
        b = e.get("b")
        return y if b is None else y + b

    def stem(self, x: torch.Tensor, key: str, stride: int, pad: int) -> torch.Tensor:
        """The exact stem ``key`` (``quantize.py``'s uint8-grid fold): float
        on normalized images in calibration; in int8 the grid bordered by
        ``qp["stem_pad_vals"]`` per channel, a VALID convolution, then
        ``acc·sw + b``."""
        e = self.qp[key]
        if self.calib:
            return conv_f32(x, e["w"], stride, pad) + e["b"]
        if pad:
            b, h, w, c = x.shape
            border = torch.tensor(self.qp["stem_pad_vals"], dtype=torch.int8, device=x.device)
            x_p = border.expand(b, h + 2 * pad, w + 2 * pad, c).clone()
            x_p[:, pad:-pad, pad:-pad] = x
            x = x_p
        y = conv_i8_packed(x, self.packed[key], stride, 0).float()
        return y * e["sw"] + e["b"]

    def dense(self, a: torch.Tensor, site: str, key: str,
              out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """The dense layer ``key`` over the last axis: float in calibration
        (``site``'s amax recorded), int8 × int8 in int8 mode on ``a``
        requantized at ``site`` (unless int8 already), in ``out_dtype``."""
        e = self.qp[key]
        if self.calib:
            self.record(site, a)
            return torch.matmul(a, e["w"].t()) + e["b"]
        return dense_i8(self.int8_in(a, site), e, self.qp["scale"][site]).to(out_dtype)


def calibrate(run, qp: dict, calib_images, batch_size: int, mean, std, device) -> dict:
    """``run(ops, x)`` in calibration mode over the normalized calibration
    batches (``quantize.py::calibration_batches``) → the ``{"scale",
    "inv_scale"}`` tables of the running amax."""
    amax = None
    with full_f32():
        for x in calibration_batches(calib_images, batch_size, device, mean, std):
            ops = Int8Ops(qp, "calib")
            run(ops, x)
            amax = running_max(amax, ops.amax)
    return transformer_scales(amax)


def hwio(conv) -> torch.Tensor:
    """An nn.Conv2d's weight (OIHW) as an f32 HWIO kernel."""
    return conv.weight.detach().float().permute(2, 3, 1, 0)


def folded(conv, bn) -> dict:
    """{"w" HWIO, "b"}: a bias-free conv and its eval BatchNorm folded in f32."""
    w, b = fold_conv_bn(hwio(conv), bn.weight.detach().float(), bn.bias.detach().float(),
                        bn.running_mean.float(), bn.running_var.float(), bn.eps)
    return {"w": w, "b": b}


def biased(conv) -> dict:
    """{"w" HWIO, "b"} of a conv with its own bias."""
    return {"w": hwio(conv), "b": conv.bias.detach().float()}


def dense_entry(lin) -> dict:
    """{"w" (N, K), "b"} of an nn.Linear (or a 1×1 conv), f32."""
    w = lin.weight.detach().float()
    return {"w": w.reshape(w.shape[0], -1), "b": lin.bias.detach().float()}


def quantize_conv(e: dict) -> dict:
    """A float convolution entry → its int8 HWIO weight and per-output-
    channel scale ``sw``, every other field kept."""
    w_q, sw = quantize_weight_per_channel(e["w"])
    return {**e, "w": w_q, "sw": sw}


def exact_stem(qp: dict, key: str, mean, std) -> None:
    """Replace the float stem ``key`` by its exact int8 fold (``quantize.py``'s
    uint8-grid fold, then weight quantization) and set ``qp["stem_pad_vals"]``."""
    w2, b2, offs = exact_patch_fold(qp[key]["w"], qp[key]["b"], mean, std)
    w_q, sw = quantize_weight_per_channel(w2)
    qp[key] = {"w": w_q, "sw": sw, "b": b2}
    qp["stem_pad_vals"] = tuple(int(round(v)) for v in offs)


@dataclasses.dataclass
class QuantizedNet(Int8Model):
    """An int8 eval-only classifier of one of the families that share
    :class:`Int8Ops`. A subclass gives its family's static structure
    (``spec_of``: float model → spec), its int8 convolutions and dense
    layers (``conv_list``, ``dense_list``: spec → (key, groups) pairs and
    keys) and its forward (``forward_fn(ops, spec, x)``), each a
    staticmethod."""

    name: str
    qparams: Any
    spec: Any
    mean: Sequence[float]
    std: Sequence[float]
    num_classes: int = 1000
    input_size: int = 224

    stem_key = "stem"  # the exact stem's key in ``qparams``

    @staticmethod
    def conv_list(spec) -> list:
        return []

    @staticmethod
    def dense_list(spec) -> list:
        return []

    def __post_init__(self):
        # each int8 convolution's weight in its route's form, packed once
        self.packed = {key: pack_conv(self.qparams[key]["w"], groups)
                       for key, groups in self.conv_list(self.spec)}

    @classmethod
    def of(cls, clf, qparams: dict):
        """The int8 classifier of float ``clf``'s architecture on
        ``qparams``."""
        return cls(name=f"{clf.name}@int8", qparams=qparams, spec=cls.spec_of(clf.model),
                   mean=clf.mean, std=clf.std, num_classes=clf.num_classes,
                   input_size=clf.input_size)

    @classmethod
    def build(cls, clf, qp: dict, calib_images, calib_batch_size: int):
        """Quantize float ``qp`` (keyed as the JAX package's, on ``clf``'s
        device): calibrate the scales, fold the exact stem, quantize every
        other convolution and every dense layer per output channel."""
        spec = cls.spec_of(clf.model)
        device = next(clf.model.parameters()).device
        qp.update(calibrate(lambda ops, x: cls.forward_fn(ops, spec, x), qp, calib_images,
                            calib_batch_size, clf.mean, clf.std, device))
        exact_stem(qp, cls.stem_key, clf.mean, clf.std)
        for key, _ in cls.conv_list(spec):
            if key != cls.stem_key:
                qp[key] = quantize_conv(qp[key])
        for key in cls.dense_list(spec):
            qp[key] = quantize_dense(qp[key])
        return cls.of(clf, qp)

    def forward_i8(self, x_i8: torch.Tensor) -> torch.Tensor:
        with full_f32():
            return self.forward_fn(Int8Ops(self.qparams, "int8", self.packed), self.spec, x_i8)


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root (numpy's), through float64."""
    return torch.sqrt(x.double()).float()


def bn_affine(bn) -> dict:
    """{"a", "c"}: an eval BatchNorm as ``a·x + c`` in f32, computed as the
    JAX package's ``quantize_densenet.py::_bn_affine`` computes it in
    numpy."""
    a = bn.weight.detach().float() / sqrt_f32(bn.running_var.float() + np.float32(bn.eps))
    return {"a": a, "c": bn.bias.detach().float() - bn.running_mean.float() * a}


def pooled(ops: Int8Ops, x: torch.Tensor, site: str) -> torch.Tensor:
    """The global average pool before a head: of the float activation in
    calibration, of the int8 one dequantized at ``site`` in int8."""
    if not ops.calib:
        x = x.float() * ops.qp["scale"][site]
    return x.mean(dim=(1, 2))


def linear(x: torch.Tensor, e: dict) -> torch.Tensor:
    """A float head ``x·wᵀ + b``, w (N, K)."""
    return torch.matmul(x, e["w"].t()) + e["b"]


def se_entry(fc1, fc2) -> dict:
    """{"rw", "rb", "ew", "eb"}: a squeeze-excite's two 1×1 convolutions,
    HWIO f32, as the JAX quantizers keep them."""
    return {"rw": hwio(fc1), "rb": fc1.bias.detach().float(),
            "ew": hwio(fc2), "eb": fc2.bias.detach().float()}


def squeeze_excite(x: torch.Tensor, e: dict, act, gate) -> torch.Tensor:
    """A float squeeze-excite on NHWC x: the pooled vector through the
    reduce convolution and ``act``, the expand convolution and ``gate``,
    scaling x."""
    s = x.mean(dim=(1, 2), keepdim=True)
    s = act(conv_f32(s, e["rw"]) + e["rb"])
    return x * gate(conv_f32(s, e["ew"]) + e["eb"])
