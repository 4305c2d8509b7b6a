"""Model zoo (counterpart of ``robustart_tpu.models``: the ResNet and ViT/DeiT
families)."""

from robustart_torch.models.classifier import Classifier
from robustart_torch.models.registry import (
    MODELS,
    create_classifier,
    get_model,
    model_meta,
    model_names,
)
from robustart_torch.models.vit import VisionTransformer

__all__ = [
    "MODELS",
    "Classifier",
    "VisionTransformer",
    "create_classifier",
    "get_model",
    "model_meta",
    "model_names",
]
