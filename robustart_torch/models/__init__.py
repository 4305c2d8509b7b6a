"""Model zoo (counterpart of ``robustart_tpu.models``: the ResNet, ViT/DeiT,
Swin, ConvNeXt, MLP-Mixer and DenseNet families)."""

from robustart_torch.models.classifier import Classifier
from robustart_torch.models.convnext import ConvNeXt
from robustart_torch.models.densenet import DenseNet
from robustart_torch.models.mlp_mixer import MlpMixer
from robustart_torch.models.registry import (
    MODELS,
    create_classifier,
    get_model,
    model_meta,
    model_names,
)
from robustart_torch.models.swin import SwinTransformer
from robustart_torch.models.vit import VisionTransformer

__all__ = [
    "MODELS",
    "Classifier",
    "ConvNeXt",
    "DenseNet",
    "MlpMixer",
    "SwinTransformer",
    "VisionTransformer",
    "create_classifier",
    "get_model",
    "model_meta",
    "model_names",
]
