"""Weight bridge into the port's torchvision-named models.

Two sources of weights:

- :func:`state_dict_from_flax` takes the JAX package's variables as flat
  numpy arrays keyed by Flax paths (``params/layer1_0/Conv_0/kernel``,
  ``batch_stats/bn1/mean``, ...: the ``/``-joined keys of the variables
  tree) and returns the port's ``state_dict``: HWIO → OIHW, Dense
  (in, out) → (out, in), BatchNorm scale/bias/mean/var →
  weight/bias/running_mean/running_var. The name rule is the inverse of
  the JAX package's torchvision → Flax rule for ResNet.
- :func:`read_torch_checkpoint` reads a torchvision-named ``.pth``,
  tolerating the reference's layouts: a dict under ``state_dict`` /
  ``model`` / ``net`` or a raw state dict, with optional ``module.``
  prefixes. ``saver.pretrain.path`` loads through it.
"""

from __future__ import annotations

import re
from typing import Iterable, Mapping

import numpy as np
import torch
from torch import nn

from robustart_torch.core.logging import get_logger

logger = get_logger(__name__)

_PARAM_SUFFIX = {"kernel": "weight", "scale": "weight", "bias": "bias"}
_STAT_SUFFIX = {"mean": "running_mean", "var": "running_var"}


def resnet_torch_key(flax_path: str) -> str:
    """``params/layer1_0/Conv_0/kernel`` → ``layer1.0.conv1.weight``."""
    collection, _, path = flax_path.partition("/")
    if path == "conv1_kernel":  # the stem keeps a flat param in Flax
        return "conv1.weight"
    base, _, leaf = path.rpartition("/")
    suffix = (_STAT_SUFFIX if collection == "batch_stats" else _PARAM_SUFFIX)[leaf]
    base = re.sub(r"^layer(\d)_(\d+)/", r"layer\1.\2.", base)
    base = base.replace("downsample_conv", "downsample.0")
    base = base.replace("downsample_bn", "downsample.1")
    # unnamed convs inside blocks: Conv_0/1/2 → conv1/2/3
    base = re.sub(r"Conv_(\d)", lambda m: f"conv{int(m.group(1)) + 1}", base)
    return f"{base.replace('/', '.')}.{suffix}"


def state_dict_from_flax(flat: Mapping[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """Flat Flax ResNet variables → the port's ResNet ``state_dict``."""
    out: dict[str, torch.Tensor] = {}
    for path, value in flat.items():
        key = resnet_torch_key(path)
        v = np.asarray(value)
        if v.ndim == 4:
            v = v.transpose(3, 2, 0, 1)  # HWIO → OIHW
        elif v.ndim == 2:
            v = v.T  # Dense (in, out) → Linear (out, in)
        out[key] = torch.tensor(v)
        if key.endswith("running_mean"):
            out[key.replace("running_mean", "num_batches_tracked")] = torch.tensor(0)
    return out


def read_torch_checkpoint(path: str) -> dict[str, torch.Tensor]:
    """Load a torchvision-named checkpoint tolerating the layout zoo."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    for key in ("state_dict", "model", "net"):
        if isinstance(obj, dict) and key in obj and isinstance(obj[key], dict):
            obj = obj[key]
            break
    if not isinstance(obj, dict):
        raise ValueError(f"unrecognized checkpoint layout in {path}")
    return {
        k[len("module."):] if k.startswith("module.") else k: v
        for k, v in obj.items()
        if isinstance(v, torch.Tensor)
    }


@torch.no_grad()
def load_pretrain(
    model: nn.Module,
    state_dict: Mapping[str, torch.Tensor],
    ignore_model: Iterable[str] = (),
) -> int:
    """Warm-start ``model`` in place with ``saver.pretrain.ignore`` semantics:
    tensors whose name matches an ``ignore_model`` pattern, or whose shape
    differs, keep their initial values. Returns the number loaded."""
    patterns = [re.compile(p) for p in ignore_model]
    own = model.state_dict()
    n_loaded = 0
    for name, value in own.items():
        src = state_dict.get(name)
        if src is None or any(p.search(name) for p in patterns):
            continue
        if tuple(src.shape) != tuple(value.shape):
            logger.warning("pretrain: shape mismatch for %s, keeping init", name)
            continue
        value.copy_(src)
        n_loaded += 1
    logger.info("pretrain: loaded %d/%d tensors", n_loaded, len(own))
    return n_loaded
