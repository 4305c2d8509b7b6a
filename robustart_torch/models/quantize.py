"""int8 post-training quantization of the ResNet family for eval.

Counterpart of ``robustart_tpu/models/quantize.py``; the names are its own.
The recipe (:mod:`robustart_torch.ops.quant`):

1. Fold eval-mode BatchNorm into each convolution (exact, in float).
2. Quantize weights symmetric per output channel to int8.
3. Calibrate static per-tensor activation scales: run the folded float
   network over calibration batches, record amax at every conv input.
4. Run an int8 forward that mirrors ``ResNet.forward`` layer for layer:
   int8 convolutions (int32 accumulators) with f32 dequant → bias → relu →
   requantize epilogues, residual adds in f32, int8 max-pool, f32 head.

**The stem is exact** (up to weight rounding): a normalized image takes only
256 values per channel, ``(k/255 − mean_c)/std_c`` for k in [0, 255], so
the stem takes ``k − 128`` as int8 with ``1/(255·std_c)`` folded into its
weights and the mean's shift into its bias. Its zero padding of the
normalized image becomes an explicit border of ``round(255·mean_c − 128)``
per channel (``stem_pad_vals``: within half a level, at the border only),
then a VALID convolution.

:class:`QuantizedClassifier` takes uint8 NHWC images, the centered int8 grid
``k − 128`` (the output of K1 with ``output="centered_u8"``,
``robustart_torch.ops.noise``) or [0,1] floats, on its device. It is eval
only and holds its own parameters (``qparams``, keyed by the float model's
torchvision names and its sites ``stem``, ``layer1.0.a1``,
``layer1.0.out``, ...); ``models/convert.py::quantized_from_flax`` builds
one from the JAX package's ``qparams``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from robustart_torch.models.layers import full_f32, normalize_01
from robustart_torch.models.resnet import Bottleneck, ResNet
from robustart_torch.ops.quant import (
    conv_i8_packed,
    fold_conv_bn,
    maxpool_i8,
    pack_conv,
    quantize_weight_per_channel,
    requantize,
)

# --------------------------------------------------------------------------
# Architecture walk (mirrors ResNet.forward)
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _ConvSpec:
    name: str  # the conv's module path, e.g. "layer2.0.conv2"
    bn: str  # its BatchNorm's
    k: int
    stride: int
    pad: int
    groups: int
    site_in: str  # the activation-scale site feeding this conv


@dataclasses.dataclass(frozen=True)
class _BlockSpec:
    name: str
    convs: tuple  # _ConvSpec... of the main path, in order
    downsample: Any  # _ConvSpec | None
    site_in: str
    site_out: str


def _resnet_spec(module: ResNet):
    """Flat block list and requantize-site names of a ResNet, and the head's
    input site."""
    blocks = []
    cur_site = "stem"
    for stage in range(module.num_stages):
        for i, blk in enumerate(getattr(module, f"layer{stage + 1}")):
            name = f"layer{stage + 1}.{i}"
            n_convs = 3 if isinstance(blk, Bottleneck) else 2
            convs = []
            for j in range(n_convs):
                conv = getattr(blk, f"conv{j + 1}")
                site = cur_site if j == 0 else f"{name}.a{j}"
                convs.append(_ConvSpec(f"{name}.conv{j + 1}", f"{name}.bn{j + 1}",
                                       conv.kernel_size[0], conv.stride[0], conv.padding[0],
                                       conv.groups, site))
            ds = None
            if blk.downsample is not None:
                ds = _ConvSpec(f"{name}.downsample.0", f"{name}.downsample.1", 1,
                               blk.downsample[0].stride[0], 0, 1, cur_site)
            blocks.append(_BlockSpec(name, tuple(convs), ds, cur_site, f"{name}.out"))
            cur_site = f"{name}.out"
    return blocks, cur_site


def _conv_specs(blocks) -> list:
    """Every _ConvSpec of the blocks, the downsamples included."""
    return [c for blk in blocks for c in blk.convs + ((blk.downsample,) if blk.downsample else ())]


# --------------------------------------------------------------------------
# BN folding
# --------------------------------------------------------------------------


def _fold_all(module: ResNet):
    """Fold every conv + BN pair → ({name: {"w" HWIO, "b"}}, blocks,
    head_site), in float32."""
    blocks, head_site = _resnet_spec(module)
    mods = dict(module.named_modules())
    folded = {}

    def fold(conv_name, bn_name):
        bn = mods[bn_name]
        kernel = mods[conv_name].weight.detach().float().permute(2, 3, 1, 0)  # OIHW → HWIO
        w, b = fold_conv_bn(kernel, bn.weight.float(), bn.bias.float(),
                            bn.running_mean.float(), bn.running_var.float(), bn.eps)
        folded[conv_name] = {"w": w, "b": b}

    fold("conv1", "bn1")
    for c in _conv_specs(blocks):
        fold(c.name, c.bn)
    return folded, blocks, head_site


# --------------------------------------------------------------------------
# Calibration forward (folded float, records amax per requantize site)
# --------------------------------------------------------------------------


def _calib_forward(folded, blocks, x_norm):
    """The folded float network on normalized NHWC images → amax per site
    (0-d tensors on the input's device)."""

    def conv_f(x, name, stride, pad, groups):
        e = folded[name]
        return F.conv2d(x, e["w"].permute(3, 2, 0, 1), e["b"], stride, pad, groups=groups)

    amax = {}

    def record(site, t):
        amax[site] = t.abs().amax()
        return t

    with full_f32():
        x = F.relu(conv_f(x_norm.permute(0, 3, 1, 2), "conv1", 2, 3, 1))
        x = record("stem", F.max_pool2d(x, 3, 2, 1))
        for blk in blocks:
            identity = x
            for j, c in enumerate(blk.convs):
                x = conv_f(x, c.name, c.stride, c.pad, c.groups)
                if j < len(blk.convs) - 1:
                    x = record(f"{blk.name}.a{j + 1}", F.relu(x))
            if blk.downsample is not None:
                d = blk.downsample
                identity = conv_f(identity, d.name, d.stride, d.pad, d.groups)
            x = record(blk.site_out, F.relu(x + identity))
    return amax


# --------------------------------------------------------------------------
# int8 forward
# --------------------------------------------------------------------------


def _int8_forward(qp, packed, blocks, head_site, x_i8, stem_pad_vals):
    """x_i8: (B, H, W, 3) int8 = uint8 grid − 128 → (B, classes) f32 logits."""

    def qconv(a_i8, c, s_in):
        e = qp[c.name]
        y = conv_i8_packed(a_i8, packed[c.name], c.stride, c.pad).float()
        return y * (s_in * e["sw"]) + e["b"]

    # the exact stem: explicit per-channel border, then a VALID conv whose
    # weights and bias carry 1/(255·std) and the mean's shift
    b, h, w, _ = x_i8.shape
    pad_c = torch.tensor(stem_pad_vals, dtype=torch.int8, device=x_i8.device)
    x_p = pad_c.expand(b, h + 6, w + 6, 3).clone()
    x_p[:, 3:-3, 3:-3] = x_i8
    e = qp["stem"]
    y = conv_i8_packed(x_p, packed["stem"], 2, 0).float()
    y = F.relu(y * e["sw"] + e["b"])
    a = maxpool_i8(requantize(y, qp["inv_scale"]["stem"]))

    for blk in blocks:
        id_i8 = a
        s_in = qp["scale"][blk.site_in]
        for j, c in enumerate(blk.convs):
            y = qconv(a if j else id_i8, c, qp["scale"][c.site_in])
            if j < len(blk.convs) - 1:
                a = requantize(F.relu(y), qp["inv_scale"][f"{blk.name}.a{j + 1}"])
        if blk.downsample is not None:
            identity = qconv(id_i8, blk.downsample, s_in)
        else:
            identity = id_i8.float() * s_in
        a = requantize(F.relu(y + identity), qp["inv_scale"][blk.site_out])

    x = (a.float() * qp["scale"][head_site]).mean(dim=(1, 2))
    with full_f32():
        return torch.matmul(x, qp["fc"]["weight"].t()) + qp["fc"]["bias"]


# --------------------------------------------------------------------------
# Public API
# --------------------------------------------------------------------------


def centered_grid(images: torch.Tensor) -> torch.Tensor:
    """The int8 grid ``k − 128`` of uint8 images; int8 images are taken as
    that grid already; [0,1] floats are rounded onto the uint8 grid first."""
    if images.dtype == torch.uint8:
        return (images.to(torch.int16) - 128).to(torch.int8)
    if images.dtype == torch.int8:
        return images
    k = torch.clamp(torch.round(images.float() * 255.0), 0, 255)
    return (k - 128).to(torch.int8)


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device) if torch.is_tensor(tree) else tree


class Int8Model:
    """The call surface the int8 classifiers share: NHWC images (uint8, the
    centered int8 grid, or [0,1] floats) on their device → f32 logits."""

    def __call__(self, images: torch.Tensor) -> torch.Tensor:
        return self.forward_i8(centered_grid(images))

    def to(self, device):
        """A copy with every parameter on ``device``, its weights packed
        anew there."""
        return dataclasses.replace(self, qparams=_tree_to(self.qparams, device))


def scale_table(amax: dict) -> dict:
    """{"scale", "inv_scale"} per site from float32 amax tensors, in float32:
    ``max(amax, 1e-12) / 127`` and its reciprocal (the ResNet path's
    arithmetic), as Python floats."""
    scale = {k: torch.clamp_min(v.float(), 1e-12) / 127.0 for k, v in amax.items()}
    return {"scale": {k: float(v) for k, v in scale.items()},
            "inv_scale": {k: float(1.0 / v) for k, v in scale.items()}}


@dataclasses.dataclass
class QuantizedClassifier(Int8Model):
    """int8 eval-only ResNet."""

    name: str
    qparams: Any
    blocks: Any
    head_site: str
    stem_pad_vals: tuple
    mean: Sequence[float]
    std: Sequence[float]
    num_classes: int = 1000
    input_size: int = 224

    def __post_init__(self):
        # each convolution's weight in the product's layout, packed once
        self.packed = {"stem": pack_conv(self.qparams["stem"]["w"])}
        for c in _conv_specs(self.blocks):
            self.packed[c.name] = pack_conv(self.qparams[c.name]["w"], c.groups)

    def forward_i8(self, x_i8: torch.Tensor) -> torch.Tensor:
        return _int8_forward(self.qparams, self.packed, self.blocks, self.head_site, x_i8,
                             self.stem_pad_vals)


def calibration_batches(calib_images, batch_size: int, device, mean, std):
    """Normalized f32 NHWC batches of the uint8 calibration images on
    ``device``: ``max(N // batch_size, 1)`` of them (N cropped to a multiple
    of the batch)."""
    images = torch.as_tensor(np.asarray(calib_images))
    for i in range(max(len(images) // batch_size, 1)):
        batch = images[i * batch_size:(i + 1) * batch_size].to(device)
        yield normalize_01(batch.float() / 255.0, mean, std)


def running_max(amax, stats):
    return stats if amax is None else {k: torch.maximum(v, stats[k]) for k, v in amax.items()}


def exact_patch_fold(w, b, mean, std):
    """Fold ``1/(255·std_c)`` and the mean's shift into an HWIO f32 kernel
    that reads normalized pixels, so that it reads the int8 grid ``k − 128``
    instead: returns (w', b') and the per-channel offsets
    ``255·mean − 128`` (f64)."""
    offs = 255.0 * np.asarray(mean, np.float64) - 128.0
    div = torch.tensor(255.0 * np.asarray(std, np.float64), dtype=torch.float32,
                       device=w.device)
    w2 = w / div.reshape(1, 1, 3, 1)
    offs_t = torch.tensor(offs, dtype=torch.float32, device=w.device)
    with full_f32():
        return w2, b - torch.einsum("hwco,c->o", w2, offs_t), offs


@torch.no_grad()
def quantize_classifier(clf, calib_images, calib_batch_size: int = 64) -> QuantizedClassifier:
    """Build the int8 eval path from a float ResNet :class:`Classifier`
    (ResNet, WideResNet, ResNeXt), on the classifier's device.

    ``calib_images``: uint8 (N, H, W, 3), a few hundred images from the eval
    distribution (corrupted ones when evaluating corruptions), which set the
    activation scales. N is cropped to a multiple of the calibration batch.
    """
    module = clf.model
    if not isinstance(module, ResNet):
        raise ValueError(f"int8 quantization of this family supports ResNet; got "
                         f"{type(module).__name__}")
    folded, blocks, head_site = _fold_all(module)
    device = folded["conv1"]["w"].device

    amax = None
    for x in calibration_batches(calib_images, calib_batch_size, device, clf.mean, clf.std):
        amax = running_max(amax, _calib_forward(folded, blocks, x))
    qp = scale_table(amax)

    # the stem takes the exact uint8-grid folding
    stem_w, stem_b, offs = exact_patch_fold(folded["conv1"]["w"], folded["conv1"]["b"],
                                            clf.mean, clf.std)
    w_q, sw = quantize_weight_per_channel(stem_w)
    qp["stem"] = {"w": w_q, "sw": sw, "b": stem_b}
    for c in _conv_specs(blocks):
        w_q, sw = quantize_weight_per_channel(folded[c.name]["w"])
        qp[c.name] = {"w": w_q, "sw": sw, "b": folded[c.name]["b"]}
    qp["fc"] = {"weight": module.fc.weight.detach().float(),
                "bias": module.fc.bias.detach().float()}
    return QuantizedClassifier(
        name=f"{clf.name}@int8", qparams=qp, blocks=blocks, head_site=head_site,
        stem_pad_vals=tuple(int(round(v)) for v in offs), mean=clf.mean, std=clf.std,
        num_classes=clf.num_classes, input_size=clf.input_size,
    )
