"""The port's CLIP text tower, tokenizer and zero-shot head against the JAX
package (``robustart_tpu/models/clip_text.py``).

No BPE merges file and no OpenAI checkpoint is in the repository, so the
tokenizer runs on a small merge list written here (the one
``tests/test_clip_text.py`` writes, plus merges for the class names), and
the text tower on a tiny random state dict in OpenAI's key layout (width
32, 4 heads, depth 2, context 16, embed 24). Tolerances: token ids equal;
``encode_text`` and the zero-shot weights (unit columns) within 1e-5 of the
JAX functions' (both f32; the sums run in other orders).
"""

import numpy as np
import pytest
import torch

from robustart_torch.core.config import Config as PortConfig
from robustart_torch.models import clip_text as port_text
from robustart_torch.models import create_classifier
from robustart_torch.solvers.base import Solver as PortSolver
from robustart_torch.tools import clip_zero_shot as port_tool
from robustart_tpu.models import clip_text as jax_text

WIDTH, HEADS, DEPTH, CTX, EMBED = 32, 4, 2, 16, 24
MERGES = ["#version: tiny", "h e", "l l", "he ll", "o</w> o</w>", "hell o</w>", "a</w> a</w>",
          "c a", "ca t</w>", "d o", "do g</w>", "p h", "ph o", "pho t", "phot o</w>"]
VISION = dict(patch_size=14, width=64, depth=1, num_heads=4, embed_dim=EMBED, num_classes=2)


@pytest.fixture()
def bpe_path(tmp_path):
    p = tmp_path / "bpe.txt"
    p.write_text("\n".join(MERGES) + "\n")
    return str(p)


def _text_state_dict(vocab: int, seed: int = 0) -> dict:
    """A random text tower in OpenAI's key layout (numpy, f32)."""
    rng = np.random.default_rng(seed)

    def n(*shape, s=0.1):
        return rng.normal(0.0, s, shape).astype(np.float32)

    sd = {"token_embedding.weight": n(vocab, WIDTH, s=0.5),
          "positional_embedding": n(CTX, WIDTH, s=0.1),
          "ln_final.weight": 1.0 + n(WIDTH), "ln_final.bias": n(WIDTH),
          "text_projection": n(WIDTH, EMBED, s=WIDTH ** -0.5)}
    for i in range(DEPTH):
        p = f"transformer.resblocks.{i}."
        sd.update({p + "ln_1.weight": 1.0 + n(WIDTH), p + "ln_1.bias": n(WIDTH),
                   p + "attn.in_proj_weight": n(3 * WIDTH, WIDTH, s=WIDTH ** -0.5),
                   p + "attn.in_proj_bias": n(3 * WIDTH),
                   p + "attn.out_proj.weight": n(WIDTH, WIDTH, s=WIDTH ** -0.5),
                   p + "attn.out_proj.bias": n(WIDTH),
                   p + "ln_2.weight": 1.0 + n(WIDTH), p + "ln_2.bias": n(WIDTH),
                   p + "mlp.c_fc.weight": n(4 * WIDTH, WIDTH, s=WIDTH ** -0.5),
                   p + "mlp.c_fc.bias": n(4 * WIDTH),
                   p + "mlp.c_proj.weight": n(WIDTH, 4 * WIDTH, s=(4 * WIDTH) ** -0.5),
                   p + "mlp.c_proj.bias": n(WIDTH)})
    return sd


def test_tokenizer_ids_equal_jax(bpe_path):
    port = port_text.SimpleTokenizer(bpe_path, n_merges=None)
    ref = jax_text.SimpleTokenizer(bpe_path, n_merges=None)
    assert port.encoder == ref.encoder and port.bpe_ranks == ref.bpe_ranks
    for word in ("hello", "hell", "xy", "cat", "photo", "dog"):
        assert port.bpe(word) == ref.bpe(word)
    texts = ["hello hello", "  HeLLo \n hello ", "a photo of a cat.", "itap of my dog!",
             "&amp;quot; it's 3 o'clock", "hello " * 20, ""]
    for text in texts:
        assert port.encode(text) == ref.encode(text)
    for ctx in (6, 16, 77):
        got = port_text.tokenize(texts, port, context_length=ctx)
        np.testing.assert_array_equal(got, jax_text.tokenize(texts, ref, context_length=ctx))
        assert got.dtype == np.int32
    # truncation keeps the EOT
    long = port_text.tokenize(["hello " * 20], port, context_length=6)
    assert long[0, -1] == port.encoder["<|endoftext|>"]
    assert port_text.OPENAI_IMAGENET_TEMPLATES == jax_text.OPENAI_IMAGENET_TEMPLATES
    assert port_text.bytes_to_unicode() == jax_text.bytes_to_unicode()


def test_encode_text_matches_jax():
    sd = _text_state_dict(vocab=64)
    rng = np.random.default_rng(1)
    tokens = np.zeros((5, CTX), np.int32)
    for i in range(5):
        n = int(rng.integers(3, CTX + 1))
        tokens[i, :n] = rng.integers(1, 60, n)
        tokens[i, n - 1] = 63  # EOT, the largest id, at the sequence's end
    ref = np.asarray(jax_text.encode_text(jax_text._text_params(sd), tokens, num_heads=HEADS))
    params = port_text.text_params(sd)
    assert params["heads"] == 1  # width // 64, OpenAI's rule
    got = port_text.encode_text(params, tokens, num_heads=HEADS).numpy()
    assert got.shape == (5, EMBED)
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    # the dotted in_proj keys of a converted state dict read the same
    dotted = {k.replace("in_proj_weight", "in_proj.weight").replace("in_proj_bias",
                                                                     "in_proj.bias"): v
              for k, v in sd.items()}
    again = port_text.encode_text(port_text.text_params(dotted), tokens, num_heads=HEADS)
    assert torch.equal(again, torch.from_numpy(got))


def test_zero_shot_weights_match_jax(bpe_path):
    tok = port_text.SimpleTokenizer(bpe_path, n_merges=None)
    sd = _text_state_dict(vocab=len(tok.encoder), seed=2)
    names = ["cat", "dog", "hello"]
    templates = ("a photo of a {}.", "a drawing of a {}.", "itap of my {}.")
    ref = jax_text.compute_zero_shot_weights(
        sd, names, templates=templates,
        tokenizer=jax_text.SimpleTokenizer(bpe_path, n_merges=None), num_heads=HEADS)
    got = port_text.compute_zero_shot_weights(sd, names, templates=templates, tokenizer=tok,
                                              num_heads=HEADS, device="cpu")
    assert got.shape == (EMBED, 3) and got.dtype == np.float32
    assert np.abs(got - ref).max() <= 1e-5
    np.testing.assert_allclose(np.linalg.norm(got, axis=0), 1.0, atol=1e-6)
    # pre-tokenized ids give the same head
    ids = [port_text.tokenize([t.format(n) for t in templates], tok, context_length=CTX)
           for n in names]
    same = port_text.compute_zero_shot_weights(sd, class_tokens=ids, num_heads=HEADS,
                                               device="cpu")
    np.testing.assert_array_equal(same, got)
    with pytest.raises(ValueError, match="classnames"):
        port_text.compute_zero_shot_weights(sd, names, device="cpu")


def _checkpoint(tmp_path, vocab: int):
    """A raw CLIP checkpoint: a tiny visual tower (OpenAI names) and the
    text tower, no classifier head."""
    vision = create_classifier("clip_vit_l_14", seed=4, device="cpu", input_size=28,
                               **VISION).model.state_dict()
    sd = {k: v for k, v in vision.items() if k != "zero_shot_weights"}
    text = _text_state_dict(vocab, seed=3)
    sd.update({k: torch.from_numpy(v) for k, v in text.items()})
    path = tmp_path / "clip_raw.pt"
    torch.save(sd, path)
    return str(path), text, vision


def _solver(path: str, zero_shot: dict) -> PortSolver:
    cfg = PortConfig({"model": {"type": "clip_vit_l_14",
                                "kwargs": {**VISION, "input_size": 28}},
                      "saver": {"pretrain": {"path": path, "clip_zero_shot": zero_shot}}})
    return PortSolver(cfg, device="cpu")


def test_load_pretrain_builds_zero_shot_head(bpe_path, tmp_path):
    """``saver.pretrain.clip_zero_shot`` as ``{classnames, bpe, num_heads}``
    (the checkpoint's own text tower; the JAX function's head on the same
    state dict) and as ``{weights: .npz}``; a head of the wrong shape is
    refused, as the JAX loader refuses it."""
    tok = port_text.SimpleTokenizer(bpe_path, n_merges=None)
    path, text, vision = _checkpoint(tmp_path, len(tok.encoder))
    names = tmp_path / "classes.txt"
    names.write_text("cat\ndog\n")
    clf = _solver(path, {"classnames": str(names), "bpe": bpe_path,
                         "num_heads": HEADS}).build_model(seed=9)
    ref = jax_text.compute_zero_shot_weights(
        text, ["cat", "dog"], tokenizer=jax_text.SimpleTokenizer(bpe_path, n_merges=None),
        num_heads=HEADS)
    head = clf.model.zero_shot_weights.detach().numpy()
    assert np.abs(head - ref).max() <= 1e-5
    # the visual tower came from the checkpoint
    assert torch.equal(clf.model.visual.proj.detach(), vision["visual.proj"])
    npz = tmp_path / "zs.npz"
    np.savez(npz, zero_shot_weights=head * 2.0)
    clf = _solver(path, {"weights": str(npz)}).build_model(seed=9)
    np.testing.assert_array_equal(clf.model.zero_shot_weights.detach().numpy(), head * 2.0)
    np.savez(npz, zero_shot_weights=np.zeros((EMBED, 3), np.float32))
    with pytest.raises(ValueError, match="zero_shot_weights shape"):
        _solver(path, {"weights": str(npz)}).build_model(seed=9)


def test_clip_zero_shot_tool_writes_what_the_loader_reads(bpe_path, tmp_path, capsys):
    tok = port_text.SimpleTokenizer(bpe_path, n_merges=None)
    path, text, _ = _checkpoint(tmp_path, len(tok.encoder))
    names = tmp_path / "classes.txt"
    names.write_text("cat\ndog\n")
    templates = tmp_path / "templates.txt"
    templates.write_text("a photo of a {}.\nitap of my {}.\n")
    out = tmp_path / "head.npz"
    port_tool.main(["--ckpt", path, "--classnames", str(names), "--bpe", bpe_path,
                    "--out", str(out), "--templates", str(templates), "--device", "cpu"])
    assert "2 classes, 2 templates" in capsys.readouterr().out
    written = np.load(out)["zero_shot_weights"]
    want = port_text.compute_zero_shot_weights(
        text, ["cat", "dog"], templates=("a photo of a {}.", "itap of my {}."), tokenizer=tok,
        device="cpu")
    np.testing.assert_array_equal(written, want)
    clf = _solver(path, {"weights": str(out)}).build_model(seed=9)
    np.testing.assert_array_equal(clf.model.zero_shot_weights.detach().numpy(), written)
