"""Host-side transform presets: STANDARD / ONECROP / JUSTNORM.

Counterpart of ``robustart_tpu/data/transforms.py``:

- STANDARD (train): RandomResizedCrop(input_size) + RandomHorizontalFlip +
  ColorJitter(0.2, 0.2, 0.2, 0.1), drawn from the item's
  ``random.Random`` in the JAX package's order (crop, flip, the four jitter
  factors, then the shuffle of the jitter ops), through the same Pillow
  operations, so an image comes out bitwise the JAX package's;
- ONECROP  (test):  Resize(shorter side = test_resize) + CenterCrop(input_size)
- JUSTNORM: no geometric op (images already sized)

Normalization is not done on the host: images leave the pipeline as uint8
HWC and the classifier (or the fused noise kernel) normalizes on the device.
A transform's ``needs_rng`` says whether it takes the item's generator.
"""

from __future__ import annotations

import random

import numpy as np
from PIL import Image, ImageEnhance

from robustart_torch.noise.imagenet_s import random_resized_crop_params


def _to_pil(img) -> Image.Image:
    if isinstance(img, Image.Image):
        return img
    return Image.fromarray(np.asarray(img, dtype=np.uint8))


def _color_jitter(img: Image.Image, rng: random.Random, brightness=0.2, contrast=0.2,
                  saturation=0.2, hue=0.1) -> Image.Image:
    """torchvision's ColorJitter as the JAX package writes it: the factors
    drawn in order, then the ops applied in a shuffled order."""
    ops = []
    if brightness > 0:
        f = rng.uniform(max(0, 1 - brightness), 1 + brightness)
        ops.append(lambda im: ImageEnhance.Brightness(im).enhance(f))
    if contrast > 0:
        f2 = rng.uniform(max(0, 1 - contrast), 1 + contrast)
        ops.append(lambda im: ImageEnhance.Contrast(im).enhance(f2))
    if saturation > 0:
        f3 = rng.uniform(max(0, 1 - saturation), 1 + saturation)
        ops.append(lambda im: ImageEnhance.Color(im).enhance(f3))
    if hue > 0:
        h = rng.uniform(-hue, hue)

        def hue_shift(im, h=h):
            hsv = np.array(im.convert("HSV"), dtype=np.int16)
            hsv[..., 0] = (hsv[..., 0] + int(h * 255)) % 256
            return Image.fromarray(hsv.astype(np.uint8), "HSV").convert("RGB")

        ops.append(hue_shift)
    rng.shuffle(ops)
    for op in ops:
        img = op(img)
    return img


def standard_transform(img, input_size: int, rng: random.Random) -> np.ndarray:
    """Training preset: RandomResizedCrop + flip + ColorJitter → uint8 HWC."""
    pil = _to_pil(img)
    i, j, h, w = random_resized_crop_params(np.asarray(pil).shape[:2], rng=rng)
    pil = pil.crop((j, i, j + w, i + h)).resize((input_size, input_size), Image.BILINEAR)
    if rng.random() < 0.5:
        pil = pil.transpose(Image.FLIP_LEFT_RIGHT)
    pil = _color_jitter(pil, rng)
    return np.asarray(pil.convert("RGB"), dtype=np.uint8)


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
    if preset == "STANDARD":
        def fn(img, rng):
            return standard_transform(img, input_size, rng)
    elif preset == "ONECROP":
        def fn(img, rng=None):
            return onecrop_transform(img, input_size, test_resize)
    elif preset == "JUSTNORM":
        def fn(img, rng=None):
            return justnorm_transform(img, input_size)
    else:
        raise ValueError(f"unknown transform preset {preset!r}")
    fn.preset = preset
    fn.needs_rng = preset == "STANDARD"
    return fn
