"""Model zoo registry (counterpart of ``robustart_tpu/models/registry.py``,
the ResNet subset the port has reached).

``create_classifier(name, seed=..., device=...)`` builds the model, fills it
with random weights drawn from a ``torch.Generator`` seeded with ``seed``
(He fan-out normal convolutions as in the JAX package, BatchNorm at
identity), and returns a :class:`Classifier` in eval mode on ``device``.
"""

from __future__ import annotations

import math
from typing import Any, Sequence

import torch
from torch import nn

from robustart_torch.models import resnet
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
}

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
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Random weights from ``generator``: convolutions He (fan-out) normal,
    Linear normal with std 1/√fan_in and zero bias, BatchNorm at identity."""
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


def create_classifier(
    name: str,
    seed: int = 0,
    device: str | torch.device = "cuda",
    input_size: int | None = None,
    mean: Sequence[float] | None = None,
    std: Sequence[float] | None = None,
    **kwargs: Any,
) -> Classifier:
    """Build a :class:`Classifier` with random weights from ``seed``."""
    meta = model_meta(name)
    model = get_model(name, **kwargs)
    gen = torch.Generator().manual_seed(int(seed))
    init_weights(model, gen)
    clf = Classifier(
        name,
        model,
        mean=mean or meta["mean"],
        std=std or meta["std"],
        input_size=input_size or meta["input_size"],
        num_classes=model.fc.out_features,
    )
    return clf.to(device).eval()
