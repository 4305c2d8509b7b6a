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
  scale → weight. It tells a ViT, a CLIP visual tower, a Swin, a ConvNeXt
  (V1 or V2), an MLP-Mixer, a DenseNet, the float CNN zoo's families
  (MobileNetV2/V3, EfficientNet, RegNet, RepVGG, ShuffleNetV2, GoogLeNet,
  the NAS stand-ins: :func:`zoo_state_dict_from_flax`) and a ResNet apart
  by the key set.
  The name rules are the inverses of the JAX package's torch → Flax rules
  (``torch_convert.py``: ``_swin_torch_name`` :191, ``_convnext_torch_name``
  :169, ``_clip_torch_name`` :211, ``_mixer_torch_name`` :100,
  ``_densenet_torch_name`` :147); for a ViT, CLIP and a Swin it also undoes
  that package's head-major q/k/v packing (H, 3, D) into torch's 3-major one
  (3, H, D) (:424), which needs the head width (a Swin block's is its
  width over its bias table's head count), for a Swin the order of
  patch merging's 2×2 neighbours (``_swin_merge_fixup`` :391), and for
  ConvNeXt-V2 it gives GRN's ``gamma`` and ``beta`` facebook's shape
  (1, 1, 1, C).
- :func:`load_clip_zero_shot` is the ``clip_zero_shot`` step of the JAX
  loader (``torch_convert.py:558-610``): a raw OpenAI CLIP checkpoint has
  no classifier, so ``zero_shot_weights`` comes from a ``.npz``/``.npy``
  (``weights``) or from the checkpoint's own text tower over the 80-prompt
  ensemble (``classnames`` + ``bpe``, ``models/clip_text.py``), its shape
  checked against the model's head.
- :func:`quantized_from_flax` takes a JAX ``Quantized*`` classifier's
  ``qparams`` (numpy: int8 HWIO or (in, out) weights, per-channel ``sw``,
  f32 biases, ``scale``/``inv_scale`` per site) and the port's float
  classifier of the same architecture, and returns the port's int8
  classifier (``models/quantize*.py``) with those parameters: the names
  and sites renamed, dense weights (out, in), q/k/v 3-major, each scale
  rounded to float32 as the JAX program takes it.
- :func:`read_torch_checkpoint` reads a torchvision- or timm-named ``.pth``,
  tolerating the reference's layouts: a dict under ``state_dict`` /
  ``model`` / ``net`` or a raw state dict, with optional ``module.``
  prefixes. ``saver.pretrain.path`` loads through it.
"""

from __future__ import annotations

import functools
import re
from typing import Iterable, Mapping

import numpy as np
import torch
from torch import nn

from robustart_torch.core.logging import get_logger
from robustart_torch.models.quantize import QuantizedClassifier, _conv_specs, _resnet_spec
from robustart_torch.models.quantize_swin import QuantizedSwin
from robustart_torch.models.quantize_vit import QuantizedViT
from robustart_torch.models.resnet import ResNet
from robustart_torch.models.swin import SwinTransformer
from robustart_torch.models.vit import VisionTransformer

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


def clip_torch_key(flax_path: str) -> str:
    """``params/resblock3/qkv/kernel`` →
    ``visual.transformer.resblocks.3.attn.in_proj_weight``; ``patch_embed``
    → ``visual.conv1``, ``out_proj`` → ``attn.out_proj``, ``mlp_fc`` /
    ``mlp_proj`` → ``mlp.c_fc`` / ``mlp.c_proj``; the embeddings, ``proj``
    and the LayerNorms under ``visual``; ``logit_scale`` and
    ``zero_shot_weights`` as they are (OpenAI's names)."""
    path = flax_path.partition("/")[2]
    if path in ("logit_scale", "zero_shot_weights"):
        return path
    if path in ("class_embedding", "positional_embedding", "proj"):
        return f"visual.{path}"
    base, _, leaf = path.rpartition("/")
    if base == "patch_embed":
        return "visual.conv1.weight"
    if base in ("ln_pre", "ln_post"):
        return f"visual.{base}.{_PARAM_SUFFIX[leaf]}"
    block = re.match(r"^resblock(\d+)/(\w+)$", base)
    if block is None:
        raise KeyError(f"no CLIP name for {flax_path!r}")
    part = {"qkv": "attn.in_proj", "out_proj": "attn.out_proj", "mlp_fc": "mlp.c_fc",
            "mlp_proj": "mlp.c_proj"}.get(block.group(2), block.group(2))
    sep = "_" if part == "attn.in_proj" else "."  # nn.MultiheadAttention's in_proj_weight
    return f"visual.transformer.resblocks.{block.group(1)}.{part}{sep}{_PARAM_SUFFIX[leaf]}"


def qkv_to_torch(path: str, v: np.ndarray, head_dim: int) -> np.ndarray:
    """Undo the head-major q/k/v column order (C, H·3·D) of the JAX
    package's packed kernel (or bias) into torch's 3-major (3·H·D, ...)."""
    if path.endswith("kernel"):
        c = v.shape[0]
        h = v.shape[1] // 3 // head_dim
        return v.reshape(c, h, 3, head_dim).transpose(2, 1, 3, 0).reshape(3 * h * head_dim, c)
    h = v.shape[0] // 3 // head_dim
    return v.reshape(h, 3, head_dim).transpose(1, 0, 2).reshape(-1)


def qkv_rows(v: np.ndarray, head_dim: int) -> np.ndarray:
    """Reorder the first axis of a packed q/k/v array (an (N, ...) weight,
    scale or bias) from the JAX package's head-major (H, 3, D) to torch's
    3-major (3, H, D)."""
    h = v.shape[0] // 3 // head_dim
    return v.reshape(h, 3, head_dim, *v.shape[1:]).swapaxes(0, 1).reshape(v.shape)


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


def _stat_key(key_base):
    """A rule on a Flax module path (``Conv_0`` of ``InvertedResidualV2_3/
    ConvBNAct_1``) → a key function on the whole variable path, the leaf
    renamed (kernel/scale → weight, mean/var → running_mean/var)."""

    def key(flax_path: str) -> str:
        collection, _, path = flax_path.partition("/")
        base, _, leaf = path.rpartition("/")
        suffix = (_STAT_SUFFIX if collection == "batch_stats" else _PARAM_SUFFIX)[leaf]
        return f"{key_base(base)}.{suffix}"

    return key


def _conv_bn_index(kind: str) -> int:
    return 0 if kind == "Conv" else 1


def mobilenet_v2_torch_base(base: str) -> str:
    """``InvertedResidualV2_3/ConvBNAct_1/BatchNorm_0`` →
    ``features.4.conv.1.1`` (``torch_convert.py:114-145``): the stem and the
    last conv ``features.0`` and ``.18``; block 0 (expand ratio 1) has no
    expansion conv, so its Sequential is [dw (0.0, 0.1), proj (1), bn (2)],
    the others' [expand (0.0, 0.1), dw (1.0, 1.1), proj (2), bn (3)]."""
    m = re.match(r"^ConvBNAct_(\d)/(Conv|BatchNorm)_0$", base)
    if m:
        return f"features.{0 if m.group(1) == '0' else 18}.{_conv_bn_index(m.group(2))}"
    if base == "classifier":
        return "classifier.1"
    m = re.match(r"^InvertedResidualV2_(\d+)/ConvBNAct_(\d)/(Conv|BatchNorm)_0$", base)
    block, part, j = int(m.group(1)), int(m.group(2)), _conv_bn_index(m.group(3))
    last = 1 if block == 0 else 2
    sub = f"{last + j}" if part == last else f"{part}.{j}"
    return f"features.{block + 1}.conv.{sub}"


def mobilenet_v3_torch_base(base: str, flat_bases: Iterable[str]) -> str:
    """``InvertedResidualV3_4/SqueezeExcite_0/fc1`` → ``features.5.block.2.fc1``
    (torchvision's names): a block's Sequential holds its ConvBNActs and
    squeeze-excite in the order the Flax block makes them, the squeeze-
    excite before the last ConvBNAct; ``pre_classifier`` and ``classifier``
    are ``classifier.0`` and ``.3``."""
    if base in ("pre_classifier", "classifier"):
        return f"classifier.{0 if base == 'pre_classifier' else 3}"
    m = re.match(r"^ConvBNAct_(\d)/(Conv|BatchNorm)_0$", base)
    if m:
        n_blocks = 1 + max(int(b.split("_")[1].split("/")[0]) for b in flat_bases
                           if b.startswith("InvertedResidualV3_"))
        feat = 0 if m.group(1) == "0" else n_blocks + 1
        return f"features.{feat}.{_conv_bn_index(m.group(2))}"
    m = re.match(r"^InvertedResidualV3_(\d+)/(ConvBNAct|SqueezeExcite)_(\d)/(.+)$", base)
    block, kind, k, rest = m.group(1), m.group(2), int(m.group(3)), m.group(4)
    prefix = f"InvertedResidualV3_{block}/"
    n_conv = len({b.split("/")[1] for b in flat_bases
                  if b.startswith(prefix) and b.split("/")[1].startswith("ConvBNAct_")})
    has_se = any(b.startswith(prefix + "SqueezeExcite_0") for b in flat_bases)
    if kind == "SqueezeExcite":
        return f"features.{int(block) + 1}.block.{n_conv - 1}.{rest}"
    pos = k + (1 if has_se and k == n_conv - 1 else 0)
    return f"features.{int(block) + 1}.block.{pos}.{_conv_bn_index(rest.split('_')[0])}"


def efficientnet_torch_base(base: str, stage_of: Mapping[int, tuple[int, int]]) -> str:
    """``MBConv_5/_ConvBNSiLU_2/Conv_0`` → ``features.3.1.block.3.0``
    (``torch_convert.py:268-326``); ``stage_of`` gives each MBConv's
    (stage 1-7, index in the stage)."""
    m = re.match(r"^_ConvBNSiLU_([01])/(Conv|BatchNorm)_0$", base)
    if m:
        return f"features.{0 if m.group(1) == '0' else 8}.{_conv_bn_index(m.group(2))}"
    if base == "classifier":
        return "classifier.1"
    m = re.match(r"^MBConv_(\d+)/(.+)$", base)
    stage, idx = stage_of[int(m.group(1))]
    expand = stage != 1  # the first stage's blocks have expand ratio 1
    rest = m.group(2)
    se = 2 if expand else 1
    if rest in ("se_reduce", "se_expand"):
        sub = f"{se}.fc{1 if rest == 'se_reduce' else 2}"
    else:
        c = re.match(r"^_ConvBNSiLU_(\d)/(Conv|BatchNorm)_0$", rest)
        k = int(c.group(1))
        pos = k + (1 if k == se else 0)  # the projection follows the squeeze-excite
        sub = f"{pos}.{_conv_bn_index(c.group(2))}"
    return f"features.{stage}.{idx}.block.{sub}"


def efficientnet_stages(flat: Mapping[str, np.ndarray]) -> dict[int, tuple[int, int]]:
    """Each MBConv's (stage, index in the stage), read from the variables:
    a block after the first of its stage keeps its width, its kernel size
    and whether it expands, and each stage's first block changes one of
    them (the base table's stages differ in expansion, kernel or width at
    every boundary)."""
    blocks = sorted({int(m.group(1)) for m in
                     (re.match(r"^params/MBConv_(\d+)/", p) for p in flat) if m})
    out, stage, idx, prev = {}, 0, 0, None
    for b in blocks:
        def kernel(k):
            return np.shape(flat[f"params/MBConv_{b}/_ConvBNSiLU_{k}/Conv_0/kernel"])

        expand = f"params/MBConv_{b}/_ConvBNSiLU_2/Conv_0/kernel" in flat
        first, dw, proj = kernel(0), kernel(int(expand)), kernel(1 + int(expand))
        sig = (expand, dw[0])
        # the block's input width: the expansion's in, or the depthwise's out
        width_in = first[2] if expand else first[3]
        if (sig, width_in) != (prev, proj[3]):
            stage, idx = stage + 1, 0
        prev = sig
        out[b] = (stage, idx)
        idx += 1
    return out


def regnet_torch_base(base: str) -> str:
    """``s1_b1/conv1`` → ``s1.b1.f.a`` (pycls, ``torch_convert.py:328-355``)."""
    fixed = {"stem_conv": "stem.conv", "stem_bn": "stem.bn", "fc": "head.fc"}
    if base in fixed:
        return fixed[base]
    block, _, rest = base.partition("/")
    rest = {"conv1": "f.a", "bn1": "f.a_bn", "conv2": "f.b", "bn2": "f.b_bn", "conv3": "f.c",
            "bn3": "f.c_bn", "proj": "proj", "proj_bn": "bn", "se_reduce": "f.se.f_ex.0",
            "se_expand": "f.se.f_ex.2"}[rest]
    return f"{block.replace('_', '.')}.{rest}"


def repvgg_torch_base(base: str) -> str:
    """``stage1_0/conv3x3`` → ``stage1.0.rbr_dense.conv`` (DingXiaoH's names,
    ``torch_convert.py:256-266``); the deploy form's ``fused`` →
    ``rbr_reparam``."""
    base = re.sub(r"^stage(\d)_(\d+)/", r"stage\1.\2.", base).replace("stage0/", "stage0.")
    for flax, torch_name in (("conv3x3", "rbr_dense.conv"), ("bn3x3", "rbr_dense.bn"),
                             ("conv1x1", "rbr_1x1.conv"), ("bn1x1", "rbr_1x1.bn"),
                             ("bn_id", "rbr_identity"), ("fused", "rbr_reparam")):
        base = base.replace(flax, torch_name)
    return base


def shufflenet_torch_base(base: str) -> str:
    """``stage2_0/_ConvBN_3/BatchNorm_0`` → ``stage2.0.branch2.4``
    (torchvision, ``torch_convert.py:235-254``)."""
    m = re.match(r"^_ConvBN_([01])/(Conv|BatchNorm)_0$", base)
    if m:
        return f"{'conv1' if m.group(1) == '0' else 'conv5'}.{_conv_bn_index(m.group(2))}"
    m = re.match(r"^stage(\d)_(\d+)/_ConvBN_(\d)/(Conv|BatchNorm)_0$", base)
    if m is None:
        return base
    stage, block, j = m.group(1), int(m.group(2)), int(m.group(3))
    off = _conv_bn_index(m.group(4))
    if block == 0 and j < 2:  # the strided unit's branch1: dw, 1×1
        return f"stage{stage}.{block}.branch1.{[0, 2][j] + off}"
    jj = j - 2 if block == 0 else j
    return f"stage{stage}.{block}.branch2.{[0, 3, 5][jj] + off}"


def googlenet_torch_base(base: str) -> str:
    """``inception3a/BasicConv2d_4/BatchNorm_0`` → ``inception3a.branch3.1.bn``,
    ``conv1/Conv_0`` → ``conv1.conv`` (torchvision's names)."""
    kind = {"Conv_0": "conv", "BatchNorm_0": "bn"}
    m = re.match(r"^(conv\d)/(Conv_0|BatchNorm_0)$", base)
    if m:
        return f"{m.group(1)}.{kind[m.group(2)]}"
    m = re.match(r"^(inception\w+)/BasicConv2d_(\d)/(Conv_0|BatchNorm_0)$", base)
    if m:
        branch = ("branch1", "branch2.0", "branch2.1", "branch3.0", "branch3.1",
                  "branch4.1")[int(m.group(2))]
        return f"{m.group(1)}.{branch}.{kind[m.group(3)]}"
    return base


def nas_resnet_torch_base(base: str) -> str:
    """The NAS stand-ins' ``layer2_0/Conv_2`` → ``layer2.0.downsample.0``,
    ``BatchNorm_1`` → ``bn2``; the deep stem's ``stem1`` / ``stem_bn2`` →
    ``conv1.3`` / ``bn1``."""
    m = re.match(r"^stem(_bn)?(\d)$", base)
    if m:
        i = int(m.group(2))
        if m.group(1):
            return "bn1" if i == 2 else f"conv1.{3 * i + 1}"
        return f"conv1.{3 * i}"
    m = re.match(r"^layer(\d)_(\d+)/(Conv|BatchNorm)_(\d)$", base)
    if m is None:
        return base
    k, j = int(m.group(4)), _conv_bn_index(m.group(3))
    part = f"downsample.{j}" if k == 2 else f"{'conv' if j == 0 else 'bn'}{k + 1}"
    return f"layer{m.group(1)}.{m.group(2)}.{part}"


def zoo_state_dict_from_flax(flat: Mapping[str, np.ndarray]) -> dict[str, torch.Tensor] | None:
    """Flat Flax variables of the float CNN zoo (MobileNetV2/V3,
    EfficientNet, RegNet, RepVGG in either form, ShuffleNetV2, GoogLeNet,
    the NAS stand-ins) → the port's ``state_dict``, or None for another
    family. The family is told by its marker key."""
    bases = [p.partition("/")[2].rpartition("/")[0] for p in flat]
    rules = (
        ("params/InvertedResidualV2_0/ConvBNAct_0/Conv_0/kernel", mobilenet_v2_torch_base),
        ("params/pre_classifier/kernel",
         functools.partial(mobilenet_v3_torch_base, flat_bases=bases)),
        ("params/s1_b1/conv1/kernel", regnet_torch_base),
        ("params/stage0/conv3x3/kernel", repvgg_torch_base),
        ("params/stage0/fused/kernel", repvgg_torch_base),
        ("params/stage2_0/_ConvBN_0/Conv_0/kernel", shufflenet_torch_base),
        ("params/inception3a/BasicConv2d_0/Conv_0/kernel", googlenet_torch_base),
        ("params/layer1_0/BatchNorm_0/scale", nas_resnet_torch_base),
    )
    if "params/MBConv_0/_ConvBNSiLU_0/Conv_0/kernel" in flat:
        stage_of = efficientnet_stages(flat)
        return renamed_state_dict(flat, _stat_key(
            lambda b: efficientnet_torch_base(b, stage_of)))
    for marker, rule in rules:
        if marker in flat:
            return renamed_state_dict(flat, _stat_key(rule))
    return None


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
    if re.search(r"/grn/(gamma|beta)$", path):  # facebook's ConvNeXt-V2 shape
        return v.reshape(1, 1, 1, -1)
    return v


def flax_ndim(torch_key: str, value: torch.Tensor) -> int:
    """The number of axes of a port parameter's JAX-package counterpart:
    the torch tensor's, except where :func:`_to_torch` reshapes (GRN's
    ``gamma`` and ``beta``, (C,) in Flax, (1, 1, 1, C) here)."""
    if re.search(r"(^|\.)grn\.(gamma|beta)$", torch_key):
        return 1
    return value.dim()


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


def clip_state_dict_from_flax(flat: Mapping[str, np.ndarray],
                              head_dim: int) -> dict[str, torch.Tensor]:
    """Flat Flax CLIP variables → the port's OpenAI-named ``state_dict``."""
    out: dict[str, torch.Tensor] = {}
    for path, value in flat.items():
        v = np.asarray(value)
        v = qkv_to_torch(path, v, head_dim) if "/qkv/" in path else _to_torch(path, v)
        out[clip_torch_key(path)] = torch.tensor(np.array(v))  # a 0-d logit_scale stays 0-d
    return out


def state_dict_from_flax(flat: Mapping[str, np.ndarray],
                         head_dim: int | None = None) -> dict[str, torch.Tensor]:
    """Flat Flax variables → the port's ``state_dict``: a ViT where the keys
    hold ``params/cls_token`` and CLIP where they hold
    ``params/class_embedding`` (``head_dim``, the attention head width, is
    then required), a Swin where they hold ``params/patch_norm/scale``, a
    ConvNeXt where they hold ``params/stem_conv/kernel``, an MLP-Mixer where
    they hold ``params/stem/kernel``, a DenseNet where they hold
    ``params/conv0/kernel``, else a ResNet."""
    for marker, bridge in (("params/cls_token", vit_state_dict_from_flax),
                           ("params/class_embedding", clip_state_dict_from_flax)):
        if marker in flat:
            if head_dim is None:
                raise ValueError("a packed q/k/v needs head_dim to be unpacked")
            return bridge(flat, head_dim)
    if "params/patch_norm/scale" in flat:
        return swin_state_dict_from_flax(flat)
    zoo = zoo_state_dict_from_flax(flat)
    if zoo is not None:
        return zoo
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


def flatten_flax(tree: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    """A nested Flax variables tree (``{"params": {...}, "batch_stats":
    {...}}``, as a msgpack checkpoint holds it) → flat ``/``-joined numpy
    leaves, bfloat16 tensors widened to float32 (exactly)."""
    out: dict[str, np.ndarray] = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(flatten_flax(v, path + "/"))
        elif isinstance(v, torch.Tensor):
            out[path] = v.float().numpy()
        else:
            out[path] = np.asarray(v)
    return out


def model_head_dim(model: nn.Module) -> int | None:
    """The attention head width the bridge needs for a packed q/k/v."""
    width = getattr(model, "embed_dim", None) or getattr(model, "width", None)
    heads = getattr(model, "num_heads", None)
    return width // heads if width and isinstance(heads, int) else None


def state_dict_from_flax_tree(tree: Mapping, model: nn.Module) -> dict[str, torch.Tensor]:
    """:func:`state_dict_from_flax` of a nested variables tree, for
    ``model`` (which gives the head width)."""
    return state_dict_from_flax(flatten_flax(tree), head_dim=model_head_dim(model))


def _site_key(site: str) -> str:
    """A JAX ResNet's requantize site → the port's: ``layer1_0.a1`` →
    ``layer1.0.a1``."""
    return re.sub(r"^layer(\d)_(\d+)\.", r"layer\1.\2.", site)


def _scales(qp: Mapping, rename=lambda k: k) -> dict:
    return {table: {rename(k): float(np.float32(v)) for k, v in qp[table].items()}
            for table in ("scale", "inv_scale")}


def quantized_from_flax(clf, qparams: Mapping, device=None, stem_pad_vals=None):
    """A JAX int8 classifier's ``qparams`` → the port's int8 classifier of
    ``clf``'s architecture (a float
    :class:`~robustart_torch.models.classifier.Classifier` of any family
    with an int8 path), on ``device`` (default: ``clf``'s).
    ``stem_pad_vals`` (where the JAX classifier holds them beside its
    ``qparams``: ResNet, RepVGG, ShuffleNetV2) defaults to
    ``round(255·mean − 128)`` of ``clf``'s mean, as the JAX quantizers
    make them."""
    module = clf.model
    device = device or next(module.parameters()).device

    def t(v):
        return torch.tensor(np.ascontiguousarray(np.asarray(v)), device=device)

    def dense(e, columns=lambda v: v):
        """{"w" (K, N), "sw", "b"} → (N, K), ``columns`` reordering the
        outputs."""
        b = e.get("b")
        return {"w": t(columns(np.asarray(e["w"]).T)), "sw": t(columns(e["sw"])),
                "b": None if b is None else t(columns(b))}

    def norm(e):
        return {"scale": t(e["scale"]), "bias": t(e["bias"])}

    def head(e):
        return {"weight": t(np.asarray(e["w"]).T), "bias": t(e["b"])}

    common = dict(name=f"{clf.name}@int8", mean=clf.mean, std=clf.std,
                  num_classes=clf.num_classes, input_size=clf.input_size)
    if isinstance(module, ResNet):
        blocks, head_site = _resnet_spec(module)
        qp = _scales(qparams, _site_key)
        for name, e in qparams.items():
            if name in ("scale", "inv_scale"):
                continue
            if name == "fc":
                qp["fc"] = {"weight": t(np.asarray(e["kernel"]).T), "bias": t(e["bias"])}
                continue
            key = "stem" if name == "stem" else resnet_torch_key(f"params/{name}/kernel")
            qp[key.removesuffix(".weight")] = {"w": t(e["w"]), "sw": t(e["sw"]),
                                               "b": t(e["b"])}
        missing = {c.name for c in _conv_specs(blocks)} - set(qp)
        if missing:
            raise ValueError(f"qparams lack the convolutions {sorted(missing)}")
        if stem_pad_vals is None:
            stem_pad_vals = tuple(int(round(v)) for v in
                                  255.0 * np.asarray(clf.mean, np.float64) - 128.0)
        return QuantizedClassifier(qparams=qp, blocks=blocks, head_site=head_site,
                                   stem_pad_vals=tuple(stem_pad_vals), **common)

    if isinstance(module, VisionTransformer):
        hd = module.embed_dim // module.num_heads
        qkv = functools.partial(qkv_rows, head_dim=hd)
        qp = _scales(qparams)
        qp.update(cls_token=t(qparams["cls_token"]), pos_embed=t(qparams["pos_embed"]),
                  norm=norm(qparams["norm"]), head=head(qparams["head"]))
        e = qparams["patch"]
        qp["patch"] = {"w": t(e["wq"]), "sw": t(e["sw"]), "b": t(e["bq"])}
        for key, e in qparams.items():
            if key.startswith("block"):
                qp[key] = (norm(e) if "scale" in e else
                           dense(e, qkv if key.endswith("attn/qkv") else lambda v: v))
        return QuantizedViT(qparams=qp, depth=len(module.blocks), num_heads=module.num_heads,
                            patch_size=module.patch_embed.proj.kernel_size[0], **common)

    if isinstance(module, SwinTransformer):
        qp = _scales(qparams)
        qp.update(patch_norm=norm(qparams["patch_norm"]), norm=norm(qparams["norm"]),
                  head=head(qparams["head"]))
        e = qparams["patch_embed"]
        qp["patch_embed"] = {"w": t(e["wq"]), "sw": t(e["sw"]), "b": t(e["bq"])}
        for key, e in qparams.items():
            block = re.match(r"^stage(\d+)_block\d+/(.+)$", key)
            if key.startswith("merge_norm"):
                qp[key] = norm(e)
            elif key.startswith("merge_reduction"):
                qp[key] = dense(e)
            elif block and block.group(2) == "rel_bias":
                qp[key] = t(e).float()
            elif block and block.group(2).startswith("norm"):
                qp[key] = norm(e)
            elif block:
                heads = module.num_heads[int(block.group(1))]
                hd = module.embed_dim * 2 ** int(block.group(1)) // heads
                qkv = functools.partial(qkv_rows, head_dim=hd)
                qp[key] = dense(e, qkv if block.group(2) == "attn/qkv" else lambda v: v)
        return QuantizedSwin(qparams=qp, embed_dim=module.embed_dim, depths=module.depths,
                             num_heads=module.num_heads, window_size=module.window_size,
                             **common)
    for family, quantized in _int8_families().items():
        if isinstance(module, family):
            qp = _scales(qparams)
            pads = qparams.get("stem_pad_vals", stem_pad_vals)
            if pads is None:
                pads = np.round(255.0 * np.asarray(clf.mean, np.float64) - 128.0)
            qp["stem_pad_vals"] = tuple(int(v) for v in pads)
            for key, e in qparams.items():
                if isinstance(e, Mapping) and key not in ("scale", "inv_scale"):
                    qp[key] = _int8_entry(key, e, t)
            return quantized.of(clf, qp)
    raise ValueError(f"no int8 path for {type(module).__name__}")


def _int8_families() -> dict:
    """Float model class → the port's int8 classifier class, for the
    families of ``models/quantize_net.py``."""
    from robustart_torch.models import (convnext, densenet, efficientnet, mlp_mixer, mobilenet,
                                        quantize_convnext, quantize_densenet,
                                        quantize_efficientnet, quantize_mixer,
                                        quantize_mobilenet, quantize_mobilenet_v3,
                                        quantize_regnet, quantize_repvgg,
                                        quantize_shufflenet, regnet, repvgg, shufflenet)

    return {repvgg.RepVGG: quantize_repvgg.QuantizedRepVGG,
            regnet.RegNetX: quantize_regnet.QuantizedRegNet,
            mobilenet.MobileNetV2: quantize_mobilenet.QuantizedMobileNetV2,
            mobilenet.MobileNetV3: quantize_mobilenet_v3.QuantizedMobileNetV3,
            efficientnet.EfficientNet: quantize_efficientnet.QuantizedEfficientNet,
            shufflenet.ShuffleNetV2: quantize_shufflenet.QuantizedShuffleNet,
            densenet.DenseNet: quantize_densenet.QuantizedDenseNet,
            convnext.ConvNeXt: quantize_convnext.QuantizedConvNeXt,
            mlp_mixer.MlpMixer: quantize_mixer.QuantizedMixer}


def _int8_entry(key: str, e: Mapping, t) -> dict:
    """One entry of a JAX int8 ``qparams`` of the ``quantize_net.py``
    families in the port's layout: the exact stem's ``wq``/``sw``/``bq`` as
    ``w``/``sw``/``b``, a head's ``kernel``/``bias`` as ``w``/``b``, a
    dense weight (K, N) as (N, K), ConvNeXt's depthwise (7, 7, 1, C) as
    K11's (C, 1, 7, 7); convolution kernels stay HWIO."""
    if "wq" in e:
        e = {"w": e["wq"], "sw": e["sw"], "b": e["bq"]}
    if "kernel" in e:
        e = {{"kernel": "w", "bias": "b"}.get(f, f): v for f, v in e.items()}
    out = {}
    for f, v in e.items():
        v = np.asarray(v)
        if f == "w" and v.ndim == 2:
            v = v.T
        elif f == "w" and key.endswith("/dwconv"):
            v = v.transpose(3, 2, 0, 1)
        out[f] = t(v)
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
def load_clip_zero_shot(model: nn.Module, state_dict: Mapping, spec: Mapping,
                        device: str | torch.device = "cuda") -> None:
    """Set a CLIP model's ``zero_shot_weights`` from
    ``saver.pretrain.clip_zero_shot``: ``{weights: path}`` to a ``.npz``
    (its first array) or ``.npy``, or ``{classnames: text file, one class a
    line; bpe: the merges file[; num_heads]}``, the checkpoint's text tower
    run on ``device``. A head of another shape than the model's is
    refused."""
    if spec.get("weights"):
        zs = np.load(spec["weights"])
        if hasattr(zs, "files"):  # npz
            zs = zs[zs.files[0]]
        zs = np.asarray(zs, np.float32)
    else:
        from robustart_torch.models.clip_text import SimpleTokenizer, compute_zero_shot_weights

        with open(spec["classnames"]) as f:
            classnames = [ln.strip() for ln in f if ln.strip()]
        # OpenAI's text towers have width // 64 heads; num_heads overrides it
        zs = compute_zero_shot_weights(state_dict, classnames,
                                       tokenizer=SimpleTokenizer(spec["bpe"]),
                                       num_heads=spec.get("num_heads"), device=device)
    want = tuple(model.zero_shot_weights.shape)
    if zs.shape != want:
        raise ValueError(f"zero_shot_weights shape {zs.shape} != model head {want}")
    model.zero_shot_weights.copy_(torch.from_numpy(zs))
    logger.info("clip zero-shot head: %d classes computed/loaded", zs.shape[1])


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
