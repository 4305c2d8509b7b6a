"""CLIP's text tower and BPE tokenizer: the zero-shot head of a raw OpenAI
checkpoint.

Counterpart of ``robustart_tpu/models/clip_text.py`` (:99-387). An OpenAI
CLIP checkpoint holds both towers and no classifier; the head the vision
classifier takes (``models/clip_vit.py``: ``zero_shot_weights``, embed_dim ×
n_classes) is made from the checkpoint's own text tower over the standard
80-prompt ImageNet ensemble:

- :class:`SimpleTokenizer`: byte-level BPE with openai/CLIP's
  ``simple_tokenizer.py`` semantics (lower-casing, whitespace cleaning, no
  ``ftfy``). Its merges file (``bpe_simple_vocab_16e6.txt.gz``) is not in
  an OpenAI checkpoint; pass its path, or pre-tokenized ids;
  :func:`tokenize` pads to the context length and keeps the EOT when it
  truncates;
- :func:`encode_text`: token and position embeddings, the causal-mask
  transformer with quick_gelu MLPs, ``ln_final`` and the projection at the
  EOT position (the argmax of the ids), in float32 plain torch on the state
  dict's tensors (the JAX module is plain XLA: no kernel);
- :func:`compute_zero_shot_weights`: per class, every prompt embedded and
  L2-normalized, the mean normalized again (openai/CLIP's
  ``zeroshot_classifier``).

This is conversion-time tooling, run once per checkpoint
(``tools/clip_zero_shot.py``, or ``saver.pretrain.clip_zero_shot``).
"""

from __future__ import annotations

import gzip
import html
import re
from functools import lru_cache
from typing import Iterable, Mapping, Sequence

import numpy as np
import torch

from robustart_torch.models.layers import full_f32

# The standard 80-template ImageNet prompt ensemble
# (openai/CLIP notebooks/Prompt_Engineering_for_ImageNet.ipynb)
OPENAI_IMAGENET_TEMPLATES = (
    "a bad photo of a {}.", "a photo of many {}.",
    "a sculpture of a {}.", "a photo of the hard to see {}.",
    "a low resolution photo of the {}.", "a rendering of a {}.",
    "graffiti of a {}.", "a bad photo of the {}.",
    "a cropped photo of the {}.", "a tattoo of a {}.",
    "the embroidered {}.", "a photo of a hard to see {}.",
    "a bright photo of a {}.", "a photo of a clean {}.",
    "a photo of a dirty {}.", "a dark photo of the {}.",
    "a drawing of a {}.", "a photo of my {}.",
    "the plastic {}.", "a photo of the cool {}.",
    "a close-up photo of a {}.", "a black and white photo of the {}.",
    "a painting of the {}.", "a painting of a {}.",
    "a pixelated photo of the {}.", "a sculpture of the {}.",
    "a bright photo of the {}.", "a cropped photo of a {}.",
    "a plastic {}.", "a photo of the dirty {}.",
    "a jpeg corrupted photo of a {}.", "a blurry photo of the {}.",
    "a photo of the {}.", "a good photo of the {}.",
    "a rendering of the {}.", "a {} in a video game.",
    "a photo of one {}.", "a doodle of a {}.",
    "a close-up photo of the {}.", "a photo of a {}.",
    "the origami {}.", "the {} in a video game.",
    "a sketch of a {}.", "a doodle of the {}.",
    "a origami {}.", "a low resolution photo of a {}.",
    "the toy {}.", "a rendition of the {}.",
    "a photo of the clean {}.", "a photo of a large {}.",
    "a rendition of a {}.", "a photo of a nice {}.",
    "a photo of a weird {}.", "a blurry photo of a {}.",
    "a cartoon {}.", "art of a {}.",
    "a sketch of the {}.", "a embroidered {}.",
    "a pixelated photo of a {}.", "itap of the {}.",
    "a jpeg corrupted photo of the {}.", "a good photo of a {}.",
    "a plushie {}.", "a photo of the nice {}.",
    "a photo of the small {}.", "a photo of the weird {}.",
    "the cartoon {}.", "art of the {}.",
    "a drawing of the {}.", "a photo of the large {}.",
    "a black and white photo of a {}.", "the plushie {}.",
    "a dark photo of a {}.", "itap of a {}.",
    "graffiti of the {}.", "a toy {}.",
    "itap of my {}.", "a photo of a cool {}.",
    "a photo of a small {}.", "a tattoo of the {}.",
)


# ---------------------------------------------------------------------------
# BPE tokenizer (openai/CLIP simple_tokenizer.py semantics)
# ---------------------------------------------------------------------------


@lru_cache()
def bytes_to_unicode() -> dict[int, str]:
    """Reversible byte → printable-unicode map (avoids control chars)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(2**8):
        if b not in bs:
            bs.append(b)
            cs.append(2**8 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


def get_pairs(word: tuple[str, ...]) -> set[tuple[str, str]]:
    return set(zip(word[:-1], word[1:]))


def _basic_clean(text: str) -> str:
    return html.unescape(html.unescape(text)).strip()


def _whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


class SimpleTokenizer:
    """Byte-level BPE with the CLIP merge table.

    ``bpe_path``: the standard ``bpe_simple_vocab_16e6.txt.gz`` (or an
    uncompressed/truncated merge list for tests). The vocabulary is
    byte-alphabet + byte-alphabet</w> + one token per merge +
    <|startoftext|>/<|endoftext|> — for the full file that is the familiar
    49408.
    """

    def __init__(self, bpe_path: str, n_merges: int | None = 48894):
        opener = gzip.open if bpe_path.endswith(".gz") else open
        with opener(bpe_path, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")
        # line 0 is a version header in the shipped file; merge list is
        # then capped to the CLIP vocab budget (simple_tokenizer.py:64)
        merges = merges[1 : (n_merges + 1) if n_merges else None]
        merges = [tuple(m.split()) for m in merges if m.strip()]
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for merge in merges:
            vocab.append("".join(merge))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {
            "<|startoftext|>": "<|startoftext|>",
            "<|endoftext|>": "<|endoftext|>",
        }
        # the upstream pattern uses \p{L}/\p{N} via the `regex` module,
        # which the project does not depend on; on the ascii prompt
        # ensemble this equivalent matches identically
        self.pat = re.compile(
            r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
            r"|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+",
            re.IGNORECASE,
        )

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(
                pairs, key=lambda p: self.bpe_ranks.get(p, float("inf"))
            )
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: list[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if (
                    word[i] == first
                    and i < len(word) - 1
                    and word[i + 1] == second
                ):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> list[int]:
        bpe_tokens: list[int] = []
        text = _whitespace_clean(_basic_clean(text)).lower()
        for token in re.findall(self.pat, text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            bpe_tokens.extend(
                self.encoder[t] for t in self.bpe(token).split(" ")
            )
        return bpe_tokens


def tokenize(
    texts: str | Sequence[str],
    tokenizer: SimpleTokenizer,
    context_length: int = 77,
) -> np.ndarray:
    """(n, context_length) int32 with <|startoftext|> ... <|endoftext|> pads
    of 0 (clip.py:tokenize; truncates overflow keeping the EOT)."""
    if isinstance(texts, str):
        texts = [texts]
    sot = tokenizer.encoder["<|startoftext|>"]
    eot = tokenizer.encoder["<|endoftext|>"]
    result = np.zeros((len(texts), context_length), np.int32)
    for i, text in enumerate(texts):
        toks = [sot] + tokenizer.encode(text) + [eot]
        if len(toks) > context_length:
            toks = toks[: context_length - 1] + [eot]
        result[i, : len(toks)] = toks
    return result


# ---------------------------------------------------------------------------
# Text transformer forward (openai/CLIP model.py encode_text semantics)
# ---------------------------------------------------------------------------


def _ln(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in f32 with the two-pass variance, as the JAX tower's."""
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * w + b


def text_params(state_dict: Mapping, device="cpu") -> dict:
    """The text tower of an OpenAI CLIP state dict (numpy arrays or torch
    tensors) as f32 tensors on ``device``: raw ``attn.in_proj_weight`` keys
    or the dotted ``attn.in_proj.weight`` form; the head count defaults to
    width // 64, OpenAI's rule."""
    sd = {k.replace("in_proj.weight", "in_proj_weight").replace("in_proj.bias", "in_proj_bias"):
          torch.as_tensor(v).to(device=device, dtype=torch.float32)
          for k, v in state_dict.items()}
    depth = 1 + max(int(m.group(1)) for k in sd
                    if (m := re.match(r"transformer\.resblocks\.(\d+)\.", k)))
    blocks = []
    for i in range(depth):
        p = f"transformer.resblocks.{i}."
        blocks.append({name: sd[p + key] for name, key in (
            ("ln_1_w", "ln_1.weight"), ("ln_1_b", "ln_1.bias"),
            ("qkv_w", "attn.in_proj_weight"), ("qkv_b", "attn.in_proj_bias"),
            ("out_w", "attn.out_proj.weight"), ("out_b", "attn.out_proj.bias"),
            ("ln_2_w", "ln_2.weight"), ("ln_2_b", "ln_2.bias"),
            ("fc_w", "mlp.c_fc.weight"), ("fc_b", "mlp.c_fc.bias"),
            ("proj_w", "mlp.c_proj.weight"), ("proj_b", "mlp.c_proj.bias"))})
    emb = sd["token_embedding.weight"]
    return {"token_embedding": emb, "positional_embedding": sd["positional_embedding"],
            "blocks": blocks, "ln_final_w": sd["ln_final.weight"],
            "ln_final_b": sd["ln_final.bias"], "text_projection": sd["text_projection"],
            "heads": max(1, emb.shape[1] // 64)}


def encode_text(params: dict, tokens, num_heads: int | None = None) -> torch.Tensor:
    """(n, context) int tokens → (n, embed_dim) float32 text features, on
    the device of ``params``: causal-mask multi-head attention (q/k/v
    3-major, as ``in_proj_weight`` packs them), quick_gelu MLPs, the
    features at the EOT position (the argmax over the ids: EOT is the
    largest id)."""
    emb = params["token_embedding"]
    tokens = torch.as_tensor(tokens, device=emb.device).long()
    width = emb.shape[1]
    heads = num_heads or params["heads"]
    d = width // heads
    n, n_ctx = tokens.shape
    mask = torch.full((n_ctx, n_ctx), float("-inf"), device=emb.device).triu(1)
    x = emb[tokens] + params["positional_embedding"][:n_ctx]
    for blk in params["blocks"]:
        y = _ln(x, blk["ln_1_w"], blk["ln_1_b"])
        qkv = torch.matmul(y, blk["qkv_w"].t()) + blk["qkv_b"]
        q, k, v = (t.reshape(n, n_ctx, heads, d) for t in qkv.split(width, dim=-1))
        att = torch.einsum("bqhd,bkhd->bhqk", q / np.sqrt(d), k) + mask
        o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(att, -1), v).reshape(n, n_ctx, width)
        x = x + torch.matmul(o, blk["out_w"].t()) + blk["out_b"]
        y = _ln(x, blk["ln_2_w"], blk["ln_2_b"])
        h = torch.matmul(y, blk["fc_w"].t()) + blk["fc_b"]
        h = h * torch.sigmoid(1.702 * h)
        x = x + torch.matmul(h, blk["proj_w"].t()) + blk["proj_b"]
    x = _ln(x, params["ln_final_w"], params["ln_final_b"])
    eot = tokens.argmax(-1)
    return torch.matmul(x[torch.arange(n, device=x.device), eot], params["text_projection"])


@torch.no_grad()
def compute_zero_shot_weights(
    state_dict: Mapping,
    classnames: Sequence[str] | None = None,
    *,
    templates: Iterable[str] = OPENAI_IMAGENET_TEMPLATES,
    tokenizer: SimpleTokenizer | None = None,
    num_heads: int | None = None,
    class_tokens: Sequence | None = None,
    device: str | torch.device = "cuda",
) -> np.ndarray:
    """(embed_dim, n_classes) float32 zero-shot weights from a raw CLIP
    state dict, the text tower run on ``device`` (cuda unless the caller
    asks for the CPU). Give ``classnames`` + ``tokenizer`` (the BPE merges
    file), or ``class_tokens``: a list of pre-tokenized (n_prompts, context)
    arrays, one a class. Per class: embed every prompt, L2-normalize each,
    average, L2-normalize the mean."""
    params = text_params(state_dict, device)
    if class_tokens is None:
        if classnames is None or tokenizer is None:
            raise ValueError("pass classnames+tokenizer, or pre-tokenized class_tokens")
        # the context length follows the checkpoint's position table
        ctx = int(params["positional_embedding"].shape[0])
        templates = tuple(templates)
        class_tokens = [tokenize([t.format(name) for t in templates], tokenizer,
                                 context_length=ctx) for name in classnames]
    heads = int(num_heads or params["heads"])
    with full_f32():
        cols = []
        for toks in class_tokens:
            feats = encode_text(params, toks, heads)
            feats = feats / feats.norm(dim=-1, keepdim=True)
            mean = feats.mean(0)
            cols.append(mean / mean.norm())
    return torch.stack(cols, dim=1).cpu().numpy().astype(np.float32)
