"""Model zoo registry (counterpart of ``robustart_tpu/models/registry.py``,
the ResNet, ViT/DeiT, Swin, ConvNeXt, MLP-Mixer and DenseNet families the
port has reached).

``create_classifier(name, seed=..., device=...)`` builds the model, fills it
with random weights drawn from a ``torch.Generator`` seeded with ``seed``
(by the JAX package's initializers: He fan-out normal convolutions and
BatchNorm at identity for ResNet and DenseNet, ``vit.init_vit``,
``swin.init_swin``, ``convnext.init_convnext`` and
``mlp_mixer.init_mixer`` for the others), and returns a :class:`Classifier`
in eval mode on ``device``. A Mixer's token MLP fixes its image size: the
registered Mixers take 224 only.
"""

from __future__ import annotations

import math
from typing import Any, Sequence

import torch
from torch import nn

from robustart_torch.models import convnext, densenet, mlp_mixer, resnet, swin, vit
from robustart_torch.models.classifier import Classifier
from robustart_torch.models.layers import IMAGENET_MEAN, IMAGENET_STD

MODELS = {
    # reference names both with and without the `_official` suffix
    "resnet18": resnet.resnet18,
    "resnet18_official": resnet.resnet18,
    "resnet34": resnet.resnet34,
    "resnet34_official": resnet.resnet34,
    "resnet50": resnet.resnet50,
    "resnet50_official": resnet.resnet50,
    "resnet101": resnet.resnet101,
    "resnet101_official": resnet.resnet101,
    "resnet152": resnet.resnet152,
    "resnet152_official": resnet.resnet152,
    "wide_resnet50_2": resnet.wide_resnet50_2,
    "wide_resnet101_2": resnet.wide_resnet101_2,
    "resnext50_32x4d": resnet.resnext50_32x4d,
    "resnext101_32x8d": resnet.resnext101_32x8d,
    "vit_b16_224": vit.vit_b16_224,
    "vit_base": vit.vit_b16_224,  # alias used by eval-loop configs
    "vit_base_cvst": vit.vit_b16_224,  # CvSt robust ViT checkpoints
    "vit_b32_224": vit.vit_b32_224,
    "deit_tiny_b16_224": vit.deit_tiny_b16_224,
    "deit_small_b16_224": vit.deit_small_b16_224,
    "deit_base_b16_224": vit.deit_base_b16_224,
    "swin_tiny": swin.swin_tiny,
    "swin_small": swin.swin_small,
    "swin_base": swin.swin_base,
    "swin_base_224": swin.swin_base,  # eval-list alias (reference swin/config.yaml)
    "convnext_base": convnext.convnext_base,
    "mixer_b16_224": mlp_mixer.mixer_b16_224,
    "mixer_L16_224": mlp_mixer.mixer_L16_224,
    "densenet121": densenet.densenet121,
    "densenet169": densenet.densenet169,
    "densenet201": densenet.densenet201,
}

# models whose shapes follow the image size: ViT's pos_embed, Swin's windows
_SIZED = {vit.vit_b16_224, vit.vit_b32_224, vit.deit_tiny_b16_224, vit.deit_small_b16_224,
          vit.deit_base_b16_224, swin.swin_tiny, swin.swin_small, swin.swin_base}
# models built for one image size: a Mixer's token MLP
_FIXED_SIZE = {mlp_mixer.mixer_b16_224, mlp_mixer.mixer_L16_224}
_META = {name: {"input_size": 224, "mean": IMAGENET_MEAN, "std": IMAGENET_STD}
         for name in MODELS}


def model_names() -> list[str]:
    return sorted(MODELS)


def model_meta(name: str) -> dict[str, Any]:
    if name not in _META:
        raise KeyError(
            f"model {name!r} is not ported yet; the port has {model_names()} "
            "(ROADMAP.md, modules to port)"
        )
    return dict(_META[name])


def get_model(name: str, **kwargs: Any) -> nn.Module:
    """Build a model by zoo name with the reference kwargs vocabulary."""
    model_meta(name)
    return MODELS[name](**kwargs)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator, probe: bool = False) -> None:
    """Random weights from ``generator``: a ViT by ``vit.init_vit``, a Swin
    by ``swin.init_swin``, a ConvNeXt by ``convnext.init_convnext``, a Mixer
    by ``mlp_mixer.init_mixer``; else convolutions He (fan-out) normal,
    Linear normal with std 1/√fan_in and zero bias, BatchNorm at identity.
    ``probe`` (tests and smoke checks only) draws Swin's bias tables,
    ConvNeXt's layer-scale and DenseNet's BatchNorms at a scale that reaches
    the logits."""
    if isinstance(model, vit.VisionTransformer):
        vit.init_vit(model, generator)
        return
    if isinstance(model, swin.SwinTransformer):
        swin.init_swin(model, generator, probe)
        return
    if isinstance(model, convnext.ConvNeXt):
        convnext.init_convnext(model, generator, probe)
        return
    if isinstance(model, mlp_mixer.MlpMixer):
        mlp_mixer.init_mixer(model, generator)
        return
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            o, i, kh, kw = m.weight.shape
            std = math.sqrt(2.0 / (kh * kw * o))
            w = torch.randn(m.weight.shape, generator=generator) * std
            m.weight.copy_(w)
        elif isinstance(m, nn.Linear):
            w = torch.randn(m.weight.shape, generator=generator)
            m.weight.copy_(w / math.sqrt(m.weight.shape[1]))
            m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
    if probe and isinstance(model, densenet.DenseNet):
        densenet.jitter_batch_norms(model, generator)


def create_classifier(
    name: str,
    seed: int = 0,
    device: str | torch.device = "cuda",
    input_size: int | None = None,
    mean: Sequence[float] | None = None,
    std: Sequence[float] | None = None,
    probe_init: bool = False,
    **kwargs: Any,
) -> Classifier:
    """Build a :class:`Classifier` with random weights from ``seed``
    (``probe_init``: see :func:`init_weights`)."""
    meta = model_meta(name)
    if MODELS[name] in _SIZED:
        kwargs.setdefault("img_size", input_size or meta["input_size"])
    elif MODELS[name] in _FIXED_SIZE and input_size not in (None, meta["input_size"]):
        raise ValueError(f"{name} takes {meta['input_size']}² images only (its token MLP's "
                         f"width is the token count), not {input_size}²")
    model = get_model(name, **kwargs)
    gen = torch.Generator().manual_seed(int(seed))
    init_weights(model, gen, probe_init)
    clf = Classifier(
        name,
        model,
        mean=mean or meta["mean"],
        std=std or meta["std"],
        input_size=input_size or meta["input_size"],
        num_classes=model.num_classes,
    )
    return clf.to(device).eval()
