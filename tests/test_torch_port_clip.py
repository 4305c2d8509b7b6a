"""The port's CLIP visual tower, its weight bridge and its registry names
against the JAX package.

A tiny CLIP (patch 14, 56², depth 2, embed 32, 10 classes) has its
variables drawn from numpy on the shapes of ``jax.eval_shape`` (the class
and position embeddings and ``proj`` at std 0.5, ``logit_scale`` at
log(1/0.07)), moved by ``robustart_torch.models.convert`` into the port's
OpenAI-named model. The JAX model runs its XLA form
(``attention_impl="xla"``). At width 64 with 4 heads the port's blocks take
the unfused branch (LN, q/k/v product, K8's plain version, proj); at width
128 with 2 heads ``block_kernel_head_groups`` is not None and they take
K6's plain version, as CLIP-L does on the card. Both take K7's plain version
with quick_gelu. Tolerances: f32 max|Δlogit| ≤ 1e-5·max|logit| and equal
argmax; bf16 ≤ 3e-2·max|logit| (the JAX XLA form rounds to bf16 after
each product and each bias add; K6 and K7 add the biases and the residual
in f32 and round once); the input gradient f32 ≤ 1e-4·max|g|, as for the
other models.
"""

import tests.torch_port_threads  # noqa: F401  (before any torch work)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustart_torch.core.config import Config as PortConfig
from robustart_torch.models import clip_vit as port_clip
from robustart_torch.models import convert, create_classifier
from robustart_torch.models import registry as port_registry
from robustart_torch.models.classifier import Classifier as PortClassifier
from robustart_torch.models.layers import CLIP_MEAN, CLIP_STD
from robustart_torch.ops.attention import window_block_qkv
from robustart_torch.solvers.base import Solver as PortSolver
from robustart_tpu.attacks import gradient as jg
from robustart_tpu.models import clip_vit as jax_clip
from robustart_tpu.models.classifier import Classifier as JaxClassifier
from robustart_tpu.models.torch_convert import convert_state_dict, flatten, unflatten
from tests.test_torch_port_resnet import numpy_variables

SIZE = 56
WIDTHS = {"w64": (64, 4), "w128": (128, 2)}  # (width, heads); w128 takes K6


def _kw(width, heads):
    return dict(patch_size=14, width=width, depth=2, num_heads=heads, embed_dim=32,
                num_classes=10)


def _flat(jm, seed=0):
    """numpy variables of the JAX module with the embeddings and ``proj`` at
    std 0.5 and ``logit_scale`` at its init, log(1/0.07)."""
    flat = numpy_variables(jm, SIZE, seed)
    rng = np.random.default_rng(seed + 100)
    for name in ("class_embedding", "positional_embedding", "proj", "zero_shot_weights"):
        key = f"params/{name}"
        flat[key] = rng.normal(0.0, 0.5, flat[key].shape).astype(np.float32)
    flat["params/logit_scale"] = np.asarray(np.log(1 / 0.07), np.float32)
    return flat


def _pair(tag, jdt=jnp.float32, tdt=torch.float32, seed=0):
    width, heads = WIDTHS[tag]
    jm = jax_clip.CLIPVisionClassifier(**_kw(width, heads), attention_impl="xla", dtype=jdt)
    flat = _flat(jm, seed)
    pm = port_clip.CLIPVisionClassifier(**_kw(width, heads), img_size=SIZE, dtype=tdt).eval()
    pm.load_state_dict(convert.state_dict_from_flax(flat, head_dim=width // heads))
    return jm, flat, pm


def _x(seed=1, n=2):
    return np.random.default_rng(seed).normal(0, 1, (n, SIZE, SIZE, 3)).astype(np.float32)


@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("tag", list(WIDTHS))
def test_clip_matches_jax(tag, kind):
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[kind]
    jm, flat, pm = _pair(tag, jdt, tdt)
    assert all(blk.fused == (tag == "w128") for blk in pm.blocks())
    x = _x()
    ref = np.asarray(jax.jit(jm.apply)(unflatten(flat), x), np.float32)
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32 and got.shape == (2, 10)
    top = np.abs(ref).max()
    if kind == "f32":
        assert np.abs(got - ref).max() <= 1e-5 * top
        np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))
    else:
        assert np.abs(got - ref).max() <= 3e-2 * top


@pytest.mark.parametrize("tag", list(WIDTHS))
def test_clip_input_gradient_matches_jax(tag):
    """The image gradient of the mean cross-entropy through CLIP's
    normalization, f32: the port's ``_ce_grad`` against ``jax.grad``."""
    from robustart_torch.attacks import gradient as pg

    jm, flat, pm = _pair(tag)
    jclf = JaxClassifier("clip", jm, unflatten(flat), mean=CLIP_MEAN, std=CLIP_STD,
                         input_size=SIZE, num_classes=10)
    pclf = PortClassifier("clip", pm, mean=CLIP_MEAN, std=CLIP_STD, input_size=SIZE,
                          num_classes=10)
    rng = np.random.default_rng(3)
    x = rng.uniform(0, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    y = rng.integers(0, 10, 2).astype(np.int32)
    ref = np.asarray(jax.jit(lambda v, xx, yy: jg._ce_grad(jclf.logits_fn(), v, xx, yy))(
        jclf.variables, x, y))
    got = pg._ce_grad(pclf, torch.from_numpy(x), torch.from_numpy(y).long()).numpy()
    assert np.abs(ref).max() > 0
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()


def test_clip_bridge_unpacks_distinct_heads():
    """Each head's q, k and v rows land where ``nn.MultiheadAttention``
    keeps them: the JAX kernel is (C, H, 3, D) head-major
    (``clip_vit.py:59-60``), ``in_proj_weight`` rows [q; k; v] each (H, D).
    The heads differ, so a wrong permutation cannot pass. The bridge is
    the inverse of the JAX package's torch → Flax converter."""
    width, heads = 64, 4
    d = width // heads
    jm = jax_clip.CLIPVisionClassifier(**_kw(width, heads), attention_impl="xla")
    flat = _flat(jm, 5)
    sd = convert.state_dict_from_flax(flat, head_dim=d)
    wj = flat["params/resblock1/qkv/kernel"].reshape(width, heads, 3, d)
    bj = flat["params/resblock1/qkv/bias"].reshape(heads, 3, d)
    w = sd["visual.transformer.resblocks.1.attn.in_proj_weight"].numpy()
    b = sd["visual.transformer.resblocks.1.attn.in_proj_bias"].numpy()
    for h in range(heads):
        for i in range(3):  # q, k, v
            rows = slice(i * width + h * d, i * width + (h + 1) * d)
            np.testing.assert_array_equal(w[rows], wj[:, h, i, :].T)
            np.testing.assert_array_equal(b[rows], bj[h, i])
    assert not np.array_equal(wj[:, 0, 0], wj[:, 1, 0])
    assert set(sd) == set(port_clip.CLIPVisionClassifier(**_kw(width, heads),
                                                         img_size=SIZE).state_dict())
    assert convert.clip_torch_key("params/patch_embed/kernel") == "visual.conv1.weight"
    assert (convert.clip_torch_key("params/resblock0/mlp_proj/bias")
            == "visual.transformer.resblocks.0.mlp.c_proj.bias")
    # the JAX loader reads in_proj's dotted form (read_torch_state_dict)
    dotted = {k.replace("in_proj_weight", "in_proj.weight").replace("in_proj_bias", "in_proj.bias"):
              v.numpy() for k, v in sd.items()}
    variables = unflatten({k: np.zeros_like(v) for k, v in flat.items()})
    back, missing = convert_state_dict(dotted, variables, "CLIPVisionClassifier", head_dim=d)
    assert missing == []
    for name, value in flatten(back).items():
        np.testing.assert_array_equal(np.asarray(value), flat[name])


def test_clip_loads_openai_state_dict(tmp_path):
    """An OpenAI-named checkpoint built here (``in_proj_weight`` flat, q/k/v
    concatenated 3-major, dense weights (out, in), ``proj`` (width, embed),
    text-tower keys beside it) loads through ``saver.pretrain.path`` into a
    classifier whose logits are the JAX model's on the same variables."""
    width, heads = 128, 2
    d = width // heads
    jm = jax_clip.CLIPVisionClassifier(**_kw(width, heads), attention_impl="xla")
    flat = _flat(jm, 7)
    p = {k.partition("/")[2]: v for k, v in flat.items()}
    sd = {"visual.conv1.weight": p["patch_embed/kernel"].transpose(3, 2, 0, 1),
          "visual.class_embedding": p["class_embedding"],
          "visual.positional_embedding": p["positional_embedding"],
          "visual.proj": p["proj"], "logit_scale": p["logit_scale"],
          "zero_shot_weights": p["zero_shot_weights"],
          "token_embedding.weight": np.zeros((8, 64), np.float32)}
    for ln in ("ln_pre", "ln_post"):
        sd[f"visual.{ln}.weight"], sd[f"visual.{ln}.bias"] = p[f"{ln}/scale"], p[f"{ln}/bias"]
    for i in range(2):
        pre, blk = f"visual.transformer.resblocks.{i}.", f"resblock{i}/"
        w = p[blk + "qkv/kernel"].reshape(width, heads, 3, d)
        b = p[blk + "qkv/bias"].reshape(heads, 3, d)
        sd[pre + "attn.in_proj_weight"] = np.concatenate(
            [w[:, :, j].reshape(width, width).T for j in range(3)])
        sd[pre + "attn.in_proj_bias"] = np.concatenate([b[:, j].reshape(-1) for j in range(3)])
        for jax_name, name in (("out_proj", "attn.out_proj"), ("mlp_fc", "mlp.c_fc"),
                               ("mlp_proj", "mlp.c_proj")):
            sd[pre + name + ".weight"] = p[f"{blk}{jax_name}/kernel"].T
            sd[pre + name + ".bias"] = p[f"{blk}{jax_name}/bias"]
        for ln in ("ln_1", "ln_2"):
            sd[f"{pre}{ln}.weight"], sd[f"{pre}{ln}.bias"] = p[f"{blk}{ln}/scale"], p[f"{blk}{ln}/bias"]
    path = tmp_path / "clip.pt"
    torch.save({"state_dict": {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}},
               path)
    cfg = PortConfig({"model": {"type": "clip_vit_l_14",
                                "kwargs": {**_kw(width, heads), "input_size": SIZE}},
                      "saver": {"pretrain": {"path": str(path)}}})
    solver = PortSolver(cfg, device="cpu")
    clf = solver.build_model(seed=3)
    assert (clf.mean, clf.std) == (CLIP_MEAN, CLIP_STD)
    x = np.random.default_rng(2).uniform(0, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    jclf = JaxClassifier("clip", jm, unflatten(flat), mean=CLIP_MEAN, std=CLIP_STD,
                         input_size=SIZE, num_classes=10)
    ref = np.asarray(jax.jit(lambda v, xx: jclf.logits_fn()(v, xx))(jclf.variables, x))
    with torch.no_grad():
        got = clf(torch.from_numpy(x)).numpy()
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def test_clip_fused_branch_zero_bias_is_no_bias():
    """K6 with CLIP's zero (H, 1, 1) bias gives the bits of K6 with none."""
    g = torch.Generator().manual_seed(0)
    c, h = 128, 2
    x = torch.randn((2, 17, c), generator=g)
    args = (x, torch.rand(c, generator=g) + 0.5, torch.randn(c, generator=g) * 0.1,
            torch.randn((3 * c, c), generator=g) / c ** 0.5, torch.randn(3 * c, generator=g),
            torch.randn((c, c), generator=g) / c ** 0.5, torch.randn(c, generator=g))
    for dtype in (torch.float32, torch.bfloat16):
        a = [t.to(dtype) if t.ndim == 2 or t is x else t for t in args]
        a[0] = x.to(dtype)
        none = window_block_qkv(*a, num_heads=h, eps=1e-5)
        zero = window_block_qkv(*a, torch.zeros((h, 1, 1)), num_heads=h, eps=1e-5)
        assert torch.equal(none, zero)


def test_registry_resolves_clip_and_the_new_names():
    names = ("clip_vit_l_14", "clip_vit_l_14_fare2_clip", "clip_vit_l_14_tecoa2_clip",
             "convnextv2_base", "convnext_base_cvst", "swin_base_384")
    for name in names:
        meta = port_registry.model_meta(name)
        clip = name.startswith("clip")
        assert meta["input_size"] == (384 if name == "swin_base_384" else 224)
        assert (meta["mean"], meta["std"]) == ((CLIP_MEAN, CLIP_STD) if clip else
                                               ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225)))
    for name in names[:3]:
        clf = create_classifier(name, seed=0, device="cpu", input_size=SIZE,
                                **_kw(64, 4))
        m = clf.model
        assert isinstance(m, port_clip.CLIPVisionClassifier)
        # the position table follows input_size: (56/14)² + 1 tokens
        assert tuple(m.visual.positional_embedding.shape) == (17, 64)
        assert (clf.mean, clf.std, clf.input_size) == (CLIP_MEAN, CLIP_STD, SIZE)
        assert abs(float(m.logit_scale.detach()) - np.log(1 / 0.07)) < 1e-6
        assert m.visual.conv1.bias is None
    full = port_clip.clip_vit_l_14(dtype=torch.bfloat16)
    blk = full.blocks()[0]
    assert blk.fused and blk.attn.in_proj_weight.dtype == torch.bfloat16
    assert tuple(full.visual.positional_embedding.shape) == (257, 1024)
    assert sum(p.numel() for p in full.parameters()) > 3.0e8
