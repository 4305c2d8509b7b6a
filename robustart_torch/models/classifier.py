"""Classifier: a model plus its input normalization.

Counterpart of ``robustart_tpu/models/classifier.py``. A :class:`Classifier`
takes NHWC images in **[0,1]**, or uint8, and normalizes them inside its
forward (classifier.py:87-108 in the JAX package), so every solver composes with
every model without re-plumbing constants. :meth:`Classifier.forward_normalized`
takes an already-normalized NHWC tensor, the output of the fused noise
kernel (``robustart_torch.ops.noise``).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from robustart_torch.models.layers import IMAGENET_MEAN, IMAGENET_STD, normalize_jit


class Classifier(nn.Module):
    """A model operating on [0,1] NHWC images."""

    def __init__(
        self,
        name: str,
        model: nn.Module,
        mean: Sequence[float] = IMAGENET_MEAN,
        std: Sequence[float] = IMAGENET_STD,
        input_size: int = 224,
        num_classes: int = 1000,
    ):
        super().__init__()
        self.name = name
        self.model = model
        self.mean = tuple(float(v) for v in mean)
        self.std = tuple(float(v) for v in std)
        self.input_size = input_size
        self.num_classes = num_classes

    @property
    def dtype(self) -> torch.dtype:
        """The type the model body computes in (its input type)."""
        return getattr(self.model, "dtype", torch.float32)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) images → float32 logits, normalized as the JAX
        package's jitted eval computes ``(x/255 − mean)/std``
        (``layers.normalize_jit``): uint8 images by
        ``fma(levels, fl32(1/255), −mean)·fl32(1/std)``, [0,1] floats (a
        computed image, as an attack step makes) by
        ``(x − mean)·fl32(1/std)``."""
        if images.dtype == torch.uint8:
            levels = images.float()
            return self.model(normalize_jit(levels, self.mean, self.std, levels))
        return self.model(normalize_jit(images.float(), self.mean, self.std))

    def forward_train(self, x: torch.Tensor) -> torch.Tensor:
        """The training forward (JAX ``cls_solver.py:196-199``) on a batch
        the step normalized after mixing (``layers.normalize_jit``): the
        model in train mode (batch statistics, which update the running
        ones)."""
        self.model.train()
        return self.model(x)

    def forward_normalized(self, x: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) images already normalized with this classifier's
        mean/std (any float type) → float32 logits."""
        return self.model(x)


class StepAttackView(nn.Module):
    """The classifier as the JAX training step's in-step attack sees it:
    [0,1] images normalized as the jitted step normalizes them
    (``normalize_jit``), then the model in whatever mode it is in (eval, for
    the attack)."""

    def __init__(self, classifier: Classifier):
        super().__init__()
        self.classifier = classifier

    def forward(self, images01: torch.Tensor) -> torch.Tensor:
        clf = self.classifier
        return clf.model(normalize_jit(images01.float(), clf.mean, clf.std))
