"""Model zoo registry (counterpart of ``robustart_tpu/models/registry.py``:
every name it registers, the same input size, mean and std).

``create_classifier(name, seed=..., device=...)`` builds the model, fills it
with random weights drawn from a ``torch.Generator`` seeded with ``seed``
(by the JAX package's initializers: He fan-out normal convolutions and
BatchNorm at identity for the CNNs, their convolutions with a bias (the
squeeze-excite layers) and their dense layers lecun-normal with zero bias,
``vit.init_vit``,
``clip_vit.init_clip``, ``swin.init_swin``, ``convnext.init_convnext`` and
``mlp_mixer.init_mixer`` for the others), and returns a :class:`Classifier`
in eval mode on ``device``. Models whose shapes follow the image size (a
ViT's or CLIP's position table, Swin's windows, a Mixer's token MLP) are
built for ``input_size``, as the JAX package's are. The CLIP names take
CLIP's mean and std, ``swin_base_384`` an input of 384 with window 12 and
each EfficientNet its ``SCALING`` size.
"""

from __future__ import annotations

import math
from typing import Any, Sequence

import torch
from torch import nn

from robustart_torch.models import (clip_vit, convnext, densenet, efficientnet, googlenet,
                                    mlp_mixer, mobilenet, nas_zoo, regnet, repvgg, resnet,
                                    shufflenet, swin, vit)
from robustart_torch.models.classifier import Classifier
from robustart_torch.models.layers import CLIP_MEAN, CLIP_STD, IMAGENET_MEAN, IMAGENET_STD

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
    "swin_base_384": swin.swin_base_384,
    "convnext_base": convnext.convnext_base,
    "convnext_base_cvst": convnext.convnext_base,  # CvSt robust checkpoints
    "convnextv2_base": convnext.convnextv2_base,
    "clip_vit_l_14": clip_vit.clip_vit_l_14,
    "clip_vit_l_14_fare2_clip": clip_vit.clip_vit_l_14_fare2_clip,
    "clip_vit_l_14_tecoa2_clip": clip_vit.clip_vit_l_14_tecoa2_clip,
    "mixer_b16_224": mlp_mixer.mixer_b16_224,
    "mixer_L16_224": mlp_mixer.mixer_L16_224,
    "densenet121": densenet.densenet121,
    "densenet169": densenet.densenet169,
    "densenet201": densenet.densenet201,
    "mobilenet_v2": mobilenet.mobilenet_v2,
    "mobilenet_v3": mobilenet.mobilenet_v3,
    **{f"mobilenet_v3_{mode}_x{str(s).replace('.', '_')}": mobilenet.mobilenet_v3_named(mode, s)
       for mode in ("small", "large") for s in (0.35, 0.5, 0.75, 1.0, 1.4)},
    "shufflenet_v2_x0_5": shufflenet.shufflenet_v2_x0_5,
    "shufflenet_v2_x1_0": shufflenet.shufflenet_v2_x1_0,
    "shufflenet_v2_x1_5": shufflenet.shufflenet_v2_x1_5,
    "shufflenet_v2_x2_0": shufflenet.shufflenet_v2_x2_0,
    "repvgg_A0": repvgg.repvgg_A0,
    "repvgg_B3": repvgg.repvgg_B3,
    "googlenet": googlenet.googlenet,
    **regnet.REGNET_FACTORIES,
    **efficientnet.EFFICIENTNET_FACTORIES,
    **nas_zoo.NAS_FACTORIES,
}

# models whose shapes follow the image size: ViT's and CLIP's position
# tables, Swin's windows, a Mixer's token MLP (its width is the token count)
_SIZED = {vit.vit_b16_224, vit.vit_b32_224, vit.deit_tiny_b16_224, vit.deit_small_b16_224,
          vit.deit_base_b16_224, clip_vit.clip_vit_l_14, swin.swin_tiny, swin.swin_small,
          swin.swin_base, swin.swin_base_384, mlp_mixer.mixer_b16_224,
          mlp_mixer.mixer_L16_224}


def _input_size(name: str) -> int:
    if MODELS[name] is swin.swin_base_384:
        return 384
    if name.startswith("efficientnet_"):
        return efficientnet.SCALING[name.split("_")[1]][2]
    return 224


_META = {name: {"input_size": _input_size(name),
                "mean": CLIP_MEAN if factory is clip_vit.clip_vit_l_14 else IMAGENET_MEAN,
                "std": CLIP_STD if factory is clip_vit.clip_vit_l_14 else IMAGENET_STD}
         for name, factory in MODELS.items()}


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
    """Random weights from ``generator``: a ViT by ``vit.init_vit``, CLIP by
    ``clip_vit.init_clip``, a Swin by ``swin.init_swin``, a ConvNeXt by ``convnext.init_convnext``, a Mixer
    by ``mlp_mixer.init_mixer``; else convolutions without a bias He
    (fan-out) normal, convolutions with one (squeeze-excite) and Linear
    normal with std 1/√fan_in and zero bias, BatchNorm at identity.
    ``probe`` (tests and smoke checks only) draws Swin's bias tables,
    ConvNeXt's layer-scale and GRN and DenseNet's BatchNorms at a scale that
    reaches the logits."""
    if isinstance(model, vit.VisionTransformer):
        vit.init_vit(model, generator)
        return
    if isinstance(model, clip_vit.CLIPVisionClassifier):
        clip_vit.init_clip(model, generator)
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
        if isinstance(m, nn.Conv2d) and m.bias is not None:
            w = torch.randn(m.weight.shape, generator=generator)
            m.weight.copy_(w / math.sqrt(m.weight[0].numel()))
            m.bias.zero_()
        elif isinstance(m, nn.Conv2d):
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
