"""Weight bridge into the port's torchvision-, timm-, Microsoft- and
facebook-named models.

Two sources of weights:

- :func:`state_dict_from_flax` takes the JAX package's variables as flat
  numpy arrays keyed by Flax paths (``params/layer1_0/Conv_0/kernel``,
  ``batch_stats/bn1/mean``, ``params/block0/attn/qkv/kernel``, ...: the
  ``/``-joined keys of the variables tree) and returns the port's
  ``state_dict``: HWIO → OIHW (ConvNeXt's depthwise (7, 7, 1, C) →
  (C, 1, 7, 7)), Dense (in, out) → (out, in), BatchNorm
  scale/bias/mean/var → weight/bias/running_mean/running_var, LayerNorm
  scale → weight. It tells a ViT, a Swin, a ConvNeXt, an MLP-Mixer, a
  DenseNet and a ResNet apart by the key set. The name rules are the
  inverses of the JAX package's torch → Flax rules (``torch_convert.py``:
  ``_swin_torch_name`` :191, ``_convnext_torch_name`` :169,
  ``_mixer_torch_name`` :100, ``_densenet_torch_name`` :147); for a ViT and
  a Swin it also undoes that
  package's head-major q/k/v packing (H, 3, D) into torch's 3-major one
  (3, H, D) (:424), which needs the head width (a Swin block's is its
  width over its bias table's head count), and for a Swin the order of
  patch merging's 2×2 neighbours (``_swin_merge_fixup`` :391).
- :func:`read_torch_checkpoint` reads a torchvision- or timm-named ``.pth``,
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


def vit_torch_key(flax_path: str) -> str:
    """``params/block0/attn/qkv/kernel`` → ``blocks.0.attn.qkv.weight``."""
    path = flax_path.partition("/")[2]
    if path in ("cls_token", "pos_embed"):
        return path
    base, _, leaf = path.rpartition("/")
    base = re.sub(r"^block(\d+)/", r"blocks.\1.", base)
    base = base.replace("patch_embed", "patch_embed.proj")
    return f"{base.replace('/', '.')}.{_PARAM_SUFFIX[leaf]}"


def qkv_to_torch(path: str, v: np.ndarray, head_dim: int) -> np.ndarray:
    """Undo the head-major q/k/v column order (C, H·3·D) of the JAX
    package's packed kernel (or bias) into torch's 3-major (3·H·D, ...)."""
    if path.endswith("kernel"):
        c = v.shape[0]
        h = v.shape[1] // 3 // head_dim
        return v.reshape(c, h, 3, head_dim).transpose(2, 1, 3, 0).reshape(3 * h * head_dim, c)
    h = v.shape[0] // 3 // head_dim
    return v.reshape(h, 3, head_dim).transpose(1, 0, 2).reshape(-1)


def swin_torch_key(flax_path: str) -> str:
    """``params/stage1_block0/attn/qkv/kernel`` → ``layers.1.blocks.0.attn.qkv.weight``;
    ``merge_norm2`` → ``layers.1.downsample.norm`` (Microsoft merges at the
    end of the stage before)."""
    base, _, leaf = flax_path.partition("/")[2].rpartition("/")
    merge = re.match(r"^merge_(norm|reduction)(\d+)$", base)
    if base == "patch_embed":
        base = "patch_embed.proj"
    elif base == "patch_norm":
        base = "patch_embed.norm"
    elif merge:
        base = f"layers.{int(merge.group(2)) - 1}.downsample.{merge.group(1)}"
    else:
        base = re.sub(r"^stage(\d+)_block(\d+)/", r"layers.\1.blocks.\2.", base)
        base = base.replace("mlp_fc", "mlp.fc")
    return f"{base.replace('/', '.')}.{_PARAM_SUFFIX.get(leaf, leaf)}"


def convnext_torch_key(flax_path: str) -> str:
    """``params/stage0_block0/dwconv/kernel`` → ``stages.0.0.dwconv.weight``;
    ``stem_conv`` → ``downsample_layers.0.0``, ``downsample_norm1`` →
    ``downsample_layers.1.0``, ``head_norm`` → ``norm``."""
    base, _, leaf = flax_path.partition("/")[2].rpartition("/")
    fixed = {"stem_conv": "downsample_layers.0.0", "stem_norm": "downsample_layers.0.1",
             "head_norm": "norm", "head": "head"}
    down = re.match(r"^downsample_(norm|conv)(\d+)$", base)
    if base in fixed:
        base = fixed[base]
    elif down:
        base = f"downsample_layers.{down.group(2)}.{0 if down.group(1) == 'norm' else 1}"
    else:
        base = re.sub(r"^stage(\d+)_block(\d+)", r"stages.\1.\2", base).replace("/", ".")
    return f"{base}.{_PARAM_SUFFIX.get(leaf, leaf)}"


def mixer_torch_key(flax_path: str) -> str:
    """``params/block0/mlp_tokens/fc1/kernel`` → ``blocks.0.mlp_tokens.fc1.weight``;
    ``stem`` → ``stem.proj``."""
    base, _, leaf = flax_path.partition("/")[2].rpartition("/")
    base = "stem.proj" if base == "stem" else re.sub(r"^block(\d+)/", r"blocks.\1.", base)
    return f"{base.replace('/', '.')}.{_PARAM_SUFFIX[leaf]}"


def densenet_torch_key(flax_path: str) -> str:
    """``params/denseblock1_layer2/_BNReLUConv_1/Conv_0/kernel`` →
    ``features.denseblock1.denselayer2.conv2.weight``;
    ``transition1/BatchNorm_0`` → ``features.transition1.norm``; ``conv0``,
    ``norm0``, ``norm5`` under ``features``; ``classifier`` as it is."""
    collection, _, path = flax_path.partition("/")
    base, _, leaf = path.rpartition("/")
    suffix = (_STAT_SUFFIX if collection == "batch_stats" else _PARAM_SUFFIX)[leaf]
    layer = re.match(r"^denseblock(\d+)_layer(\d+)/_BNReLUConv_(\d)/(Conv|BatchNorm)_0$", base)
    trans = re.match(r"^transition(\d+)/(Conv|BatchNorm)_0$", base)
    kind = {"Conv": "conv", "BatchNorm": "norm"}
    if layer:
        base = (f"features.denseblock{layer.group(1)}.denselayer{layer.group(2)}."
                f"{kind[layer.group(4)]}{int(layer.group(3)) + 1}")
    elif trans:
        base = f"features.transition{trans.group(1)}.{kind[trans.group(2)]}"
    elif base != "classifier":
        base = f"features.{base}"
    return f"{base}.{suffix}"


def merge_order(v: np.ndarray) -> np.ndarray:
    """Swap the middle two of four equal groups along the first axis: the
    JAX package's patch-merge order [x(0,0), x(0,1), x(1,0), x(1,1)] ↔
    Microsoft's [x(0,0), x(1,0), x(0,1), x(1,1)] (its own inverse)."""
    c = v.shape[0] // 4
    return np.concatenate([v[:c], v[2 * c:3 * c], v[c:2 * c], v[3 * c:]])


def _to_torch(path: str, v: np.ndarray) -> np.ndarray:
    """A Flax kernel in torch's layout: HWIO → OIHW, (in, out) → (out, in);
    every other leaf as it is."""
    if path.endswith("/kernel"):
        if v.ndim == 4:
            return v.transpose(3, 2, 0, 1)
        if v.ndim == 2:
            return v.T
    return v


def swin_state_dict_from_flax(flat: Mapping[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """Flat Flax Swin variables → the port's Microsoft-named ``state_dict``."""
    out: dict[str, torch.Tensor] = {}
    for path, value in flat.items():
        v = np.asarray(value)
        block = re.match(r"^(params/stage\d+_block\d+)/attn/qkv/(kernel|bias)$", path)
        if block:
            heads = np.shape(flat[f"{block.group(1)}/attn/relative_position_bias_table"])[1]
            v = qkv_to_torch(path, v, v.shape[-1] // 3 // heads)
        else:
            if re.search(r"/merge_(norm|reduction)\d+/", path):
                v = merge_order(v)
            v = _to_torch(path, v)
        out[swin_torch_key(path)] = torch.tensor(np.ascontiguousarray(v))
    return out


def _with_batch_counts(sd: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Add torch's ``num_batches_tracked`` beside every BatchNorm's statistics."""
    counts = {k.replace("running_mean", "num_batches_tracked"): torch.tensor(0)
              for k in sd if k.endswith("running_mean")}
    return {**sd, **counts}


def renamed_state_dict(flat: Mapping[str, np.ndarray], key) -> dict[str, torch.Tensor]:
    """Flat Flax variables of a family with no packed weights (ConvNeXt,
    MLP-Mixer, DenseNet) → the port's ``state_dict``: each leaf under
    ``key(path)`` in torch's layout, with the BatchNorm counts."""
    return _with_batch_counts({key(path): torch.tensor(np.ascontiguousarray(
        _to_torch(path, np.asarray(value)))) for path, value in flat.items()})


def vit_state_dict_from_flax(flat: Mapping[str, np.ndarray],
                             head_dim: int) -> dict[str, torch.Tensor]:
    """Flat Flax ViT variables → the port's timm-named ViT ``state_dict``."""
    out: dict[str, torch.Tensor] = {}
    for path, value in flat.items():
        v = np.asarray(value)
        if re.search(r"qkv/(kernel|bias)$", path):
            v = qkv_to_torch(path, v, head_dim)
        else:
            v = _to_torch(path, v)
        out[vit_torch_key(path)] = torch.tensor(np.ascontiguousarray(v))
    return out


def state_dict_from_flax(flat: Mapping[str, np.ndarray],
                         head_dim: int | None = None) -> dict[str, torch.Tensor]:
    """Flat Flax variables → the port's ``state_dict``: a ViT where the keys
    hold ``params/cls_token`` (``head_dim``, the attention head width, is
    then required), a Swin where they hold ``params/patch_norm/scale``, a
    ConvNeXt where they hold ``params/stem_conv/kernel``, an MLP-Mixer where
    they hold ``params/stem/kernel``, a DenseNet where they hold
    ``params/conv0/kernel``, else a ResNet."""
    if "params/cls_token" in flat:
        if head_dim is None:
            raise ValueError("a ViT's packed q/k/v needs head_dim to be unpacked")
        return vit_state_dict_from_flax(flat, head_dim)
    if "params/patch_norm/scale" in flat:
        return swin_state_dict_from_flax(flat)
    for marker, key in (("params/stem_conv/kernel", convnext_torch_key),
                        ("params/stem/kernel", mixer_torch_key),
                        ("params/conv0/kernel", densenet_torch_key)):
        if marker in flat:
            return renamed_state_dict(flat, key)
    out: dict[str, torch.Tensor] = {}
    for path, value in flat.items():
        key = resnet_torch_key(path)
        v = np.asarray(value)
        if v.ndim == 4:
            v = v.transpose(3, 2, 0, 1)  # HWIO → OIHW
        elif v.ndim == 2:
            v = v.T  # Dense (in, out) → Linear (out, in)
        out[key] = torch.tensor(v)
    return _with_batch_counts(out)


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
