"""MLP-Mixer: ``mixer_b16_224`` and ``mixer_L16_224``.

Counterpart of ``robustart_tpu/models/mlp_mixer.py``. Parameter names follow
timm (``stem.proj``, ``blocks.N.norm1``, ``blocks.N.mlp_tokens.fc1/fc2``,
``blocks.N.norm2``, ``blocks.N.mlp_channels.fc1/fc2``, ``norm``, ``head``),
so a timm checkpoint loads through ``saver.pretrain.path`` as it is, and
``models/convert.py`` maps the JAX package's variables onto the same keys.

Each block is the JAX module's deterministic branch (``mlp_mixer.py:123-128``):

- the token mix is K10 (``ops/mlp.py::token_mlp``) with the LayerNorm
  ``norm1`` as its prologue and the raw pre-norm x as the residual; in
  bf16 on the weights padded for its kernel (``pack_token_weights``), packed
  once per block and again only after a weight changes
  (:meth:`MixerBlock.token_pack`);
- the channel mix is K7 (``ops/mlp.py::mlp``) with ``norm2`` as its prologue
  and the raw x as the residual, the form ViT uses.

The token MLP's width is the token count, so a model is built for one image
size (224 for the registered names). ``dtype=torch.bfloat16`` keeps the
stem and block weights in bf16 and computes there; biases, LayerNorm
parameters and the head stay float32, and the head runs in float32 on the
token mean. The forward is eval only.
"""

from __future__ import annotations

import torch
from torch import nn

from robustart_torch.models.layers import PatchEmbed, full_f32, init_lecun, layer_norm
from robustart_torch.ops.mlp import mlp, pack_token_weights, token_mlp

LN_EPS = 1e-6


class MixerMlp(nn.Module):
    def __init__(self, dim: int, hidden_dim: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, dim)


class MixerBlock(nn.Module):
    def __init__(self, dim: int, tokens: int, tokens_mlp_dim: int, channels_mlp_dim: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp_tokens = MixerMlp(tokens, tokens_mlp_dim)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp_channels = MixerMlp(dim, channels_mlp_dim)
        # (fc1's and fc2's (data_ptr, _version), their pack_token_weights)
        self._token_pack: tuple | None = None

    def token_pack(self) -> tuple[torch.Tensor, torch.Tensor]:
        """K10's bf16 weights as its kernel reads them
        (``ops/mlp.py::pack_token_weights``), packed once and reused while
        ``mlp_tokens.fc1.weight`` and ``fc2.weight`` are the same tensors at
        the same version (``data_ptr``, ``_version``), so a state dict
        loaded or a weight changed in place packs anew. A tensor made under
        ``torch.inference_mode`` has no version counter: such a weight is
        replaced once by a normal tensor of the same values (a new
        Parameter), whose counter then tracks in-place changes, so that the
        model does not pack at every forward."""
        tok = self.mlp_tokens
        for lin in (tok.fc1, tok.fc2):
            if lin.weight.is_inference():
                with torch.inference_mode(False):
                    lin.weight = nn.Parameter(lin.weight.clone(),
                                              requires_grad=lin.weight.requires_grad)
        key = tuple((w.data_ptr(), w._version) for w in (tok.fc1.weight, tok.fc2.weight))
        if self._token_pack is None or self._token_pack[0] != key:
            self._token_pack = (key, pack_token_weights(tok.fc1.weight, tok.fc2.weight))
        return self._token_pack[1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, C) → (B, T, C) in x's type: K10, then K7. In bf16 K10
        takes the packed weights (:meth:`token_pack`)."""
        tok, ch = self.mlp_tokens, self.mlp_channels
        packed = self.token_pack() if x.dtype == torch.bfloat16 else None
        x = token_mlp(x, tok.fc1.weight, tok.fc1.bias, tok.fc2.weight, tok.fc2.bias,
                      ln=(self.norm1.weight, self.norm1.bias), ln_eps=LN_EPS,
                      residual_input=True, packed=packed)
        return mlp(x, ch.fc1.weight, ch.fc1.bias, ch.fc2.weight, ch.fc2.bias,
                   ln=(self.norm2.weight, self.norm2.bias), ln_eps=LN_EPS, residual=x)


class MlpMixer(nn.Module):
    """MLP-Mixer on normalized NHWC images → (N, num_classes) float32 logits."""

    def __init__(self, patch_size: int = 16, embed_dim: int = 768, depth: int = 12,
                 tokens_mlp_dim: int = 384, channels_mlp_dim: int = 3072,
                 num_classes: int = 1000, drop_path: float = 0.0, img_size: int = 224,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.num_classes = num_classes
        self.drop_path = float(drop_path)  # identity at eval
        tokens = (img_size // patch_size) ** 2
        self.stem = PatchEmbed(patch_size, 3, embed_dim)
        self.blocks = nn.ModuleList([
            MixerBlock(embed_dim, tokens, tokens_mlp_dim, channels_mlp_dim)
            for _ in range(depth)
        ])
        self.norm = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.head = nn.Linear(embed_dim, num_classes)
        for blk in self.blocks:
            for lin in (blk.mlp_tokens.fc1, blk.mlp_tokens.fc2, blk.mlp_channels.fc1,
                        blk.mlp_channels.fc2):
                lin.weight.data = lin.weight.data.to(dtype)
        self.stem.proj.weight.data = self.stem.proj.weight.data.to(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) normalized → (N, num_classes) float32 logits."""
        if self.training and self.drop_path:
            raise NotImplementedError("training is not ported (ROADMAP.md, item 7)")
        with full_f32():
            x = self.stem(x, self.dtype)
            for blk in self.blocks:
                x = blk(x)
            x = layer_norm(x, self.norm.weight, self.norm.bias, LN_EPS).mean(dim=1).float()
            return torch.matmul(x, self.head.weight.t()) + self.head.bias


@torch.no_grad()
def init_mixer(model: MlpMixer, generator: torch.Generator) -> None:
    """Random weights from ``generator`` by the JAX package's initializers:
    the stem, every Linear and the head lecun-normal with zero bias,
    LayerNorm at identity (:func:`init_lecun`)."""
    init_lecun(model, generator)


def mixer_b16_224(**kw):
    kw.pop("bn", None)  # reference bn{use_sync_bn}: a Mixer has none
    kw.pop("drop_path_rate", None)
    return MlpMixer(patch_size=16, embed_dim=768, depth=12, tokens_mlp_dim=384,
                    channels_mlp_dim=3072, **kw)


def mixer_L16_224(**kw):
    kw.pop("bn", None)
    kw.pop("drop_path_rate", None)
    return MlpMixer(patch_size=16, embed_dim=1024, depth=24, tokens_mlp_dim=512,
                    channels_mlp_dim=4096, **kw)
