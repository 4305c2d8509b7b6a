"""Model zoo (counterpart of ``robustart_tpu.models``, the ResNet family)."""

from robustart_torch.models.classifier import Classifier
from robustart_torch.models.registry import (
    MODELS,
    create_classifier,
    get_model,
    model_meta,
    model_names,
)

__all__ = [
    "MODELS",
    "Classifier",
    "create_classifier",
    "get_model",
    "model_meta",
    "model_names",
]
