"""Host-side eval transform presets: ONECROP / JUSTNORM.

Counterpart of ``robustart_tpu/data/transforms.py``, eval presets only:

- ONECROP:  Resize(shorter side = test_resize) + CenterCrop(input_size)
- JUSTNORM: no geometric op (images already sized)

The training preset STANDARD ports with the training solvers (ROADMAP.md,
modules to port: Training). Normalization is not done on the host: images
leave the pipeline as uint8 HWC and the classifier (or the fused noise
kernel) normalizes on the device.
"""

from __future__ import annotations

import numpy as np
from PIL import Image


def _to_pil(img) -> Image.Image:
    if isinstance(img, Image.Image):
        return img
    return Image.fromarray(np.asarray(img, dtype=np.uint8))


def onecrop_transform(img, input_size: int, test_resize: int) -> np.ndarray:
    """Eval preset: Resize(shorter side = test_resize) + CenterCrop."""
    pil = _to_pil(img).convert("RGB")
    w, h = pil.size
    if w <= h:
        ow, oh = test_resize, max(1, int(test_resize * h / w))
    else:
        oh, ow = test_resize, max(1, int(test_resize * w / h))
    pil = pil.resize((ow, oh), Image.BILINEAR)
    left = (ow - input_size) // 2
    top = (oh - input_size) // 2
    pil = pil.crop((left, top, left + input_size, top + input_size))
    return np.asarray(pil, dtype=np.uint8)


def justnorm_transform(img, input_size: int) -> np.ndarray:
    """Pass-through (images pre-sized); resizes only if the size mismatches."""
    pil = _to_pil(img).convert("RGB")
    if pil.size != (input_size, input_size):
        pil = pil.resize((input_size, input_size), Image.BILINEAR)
    return np.asarray(pil, dtype=np.uint8)


def build_transform(preset: str, input_size: int, test_resize: int = 256):
    preset = (preset or "ONECROP").upper()
    if preset == "ONECROP":
        def fn(img):
            return onecrop_transform(img, input_size, test_resize)
    elif preset == "JUSTNORM":
        def fn(img):
            return justnorm_transform(img, input_size)
    elif preset == "STANDARD":
        raise NotImplementedError(
            "the STANDARD training transform ports with the training solvers "
            "(ROADMAP.md, modules to port: Training)"
        )
    else:
        raise ValueError(f"unknown transform preset {preset!r}")
    fn.preset = preset
    return fn
