"""The last transformer names of the JAX registry in the port: ConvNeXt-V2
(GRN), Swin at window 12 (``swin_base_384``'s form), the CvSt alias and the
registry's coverage.

Each tiny model's variables are drawn from numpy on the shapes of
``jax.eval_shape`` (GRN's ``gamma`` and ``beta`` and Swin's bias tables at
std 0.5, LayerNorm scales U(0.5, 1.5): at their inits GRN is the identity
and a bias table all but zero, and an error would not show), moved by
``robustart_torch.models.convert`` into the port's facebook- and
Microsoft-named models. The JAX models run their XLA forms; the port runs
the plain versions of K11 (ConvNeXt-V2's dwconv + LN) and of K6 and K7
(Swin). Tolerances: f32 max|Δlogit| ≤ 2e-4·max|logit| and equal argmax,
as for ConvNeXt-B and Swin; bf16 ≤ 3e-2·max|logit| (the JAX XLA forms
round to bf16 after each product and add; K6 and K7 add biases and the
residual in f32 and round once; GRN's square and sums are bf16 in both).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustart_torch.models import convert, create_classifier
from robustart_torch.models import convnext as port_convnext
from robustart_torch.models import registry as port_registry
from robustart_torch.models import swin as port_swin
from robustart_tpu.models import convnext as jax_convnext
from robustart_tpu.models import registry as jax_registry
from robustart_tpu.models import swin as jax_swin
from robustart_tpu.models.torch_convert import convert_state_dict, flatten, unflatten
from tests.test_torch_port_resnet import numpy_variables

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
V2 = dict(depths=(1, 1), dims=(32, 64), num_classes=10)
V2_SIZE = 32
# window 12 at 96²: stage 0 is 24 × 24, four windows of 144 tokens shifted
# by 6 (C = 128, 4 heads of 32: K6's Swin form with bias and mask); stage 1
# is one 12 × 12 window with no shift (Swin-B-384's stage 3)
SWIN = dict(embed_dim=128, depths=(2, 2), num_heads=(4, 8), window_size=12, num_classes=10,
            drop_path=0.0)
SWIN_SIZE = 96


def _drawn(flat: dict, seed: int, wide: tuple) -> dict:
    """``flat`` with the leaves named in ``wide`` redrawn at std 0.5."""
    rng = np.random.default_rng(seed + 50)
    return {k: (rng.normal(0.0, 0.5, v.shape).astype(np.float32)
                if k.rsplit("/", 1)[-1] in wide else v) for k, v in flat.items()}


def _compare(got, ref, kind):
    top = np.abs(ref).max()
    assert got.dtype == np.float32 and np.isfinite(got).all()
    if kind == "f32":
        assert np.abs(got - ref).max() <= 2e-4 * top
        np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))
    else:
        assert np.abs(got - ref).max() <= 3e-2 * top


@pytest.mark.parametrize("kind", list(DTYPES))
def test_convnextv2_matches_jax(kind):
    """Stem, a V2 block, downsample, a V2 block, head: K11, fc1 + exact
    GELU, GRN, fc2 and the shortcut, no layer-scale."""
    jdt, tdt = DTYPES[kind]
    jm = jax_convnext.ConvNeXt(**V2, use_grn=True, block_impl="xla", mlp_impl="xla", dtype=jdt)
    flat = _drawn(numpy_variables(jm, V2_SIZE, 0), 0, ("gamma", "beta"))
    assert "params/stage0_block0/grn/gamma" in flat
    assert not any(k.endswith("stage0_block0/gamma") for k in flat)
    pm = port_convnext.ConvNeXt(**V2, use_grn=True, dtype=tdt).eval()
    sd = convert.state_dict_from_flax(flat)
    assert tuple(sd["stages.1.0.grn.gamma"].shape) == (1, 1, 1, 256)
    pm.load_state_dict(sd)
    assert all(blk.gamma is None and blk.grn is not None for st in pm.stages for blk in st)
    x = np.random.default_rng(1).normal(0, 0.5, (2, V2_SIZE, V2_SIZE, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda v, xx: jm.apply(v, xx, train=False))(unflatten(flat), x),
                     np.float32)
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    _compare(got, ref, kind)


@pytest.mark.parametrize("kind", list(DTYPES))
def test_grn_matches_jax(kind):
    """GRN alone on a (2, 5, 7, 24) NHWC input: f32 within 1e-6·max, bf16
    within one bf16 ulp of max|out| (its result is f32 from bf16 sums)."""
    jdt, tdt = DTYPES[kind]
    rng = np.random.default_rng(4)
    x = rng.normal(0, 1, (2, 5, 7, 24)).astype(np.float32)
    gamma, beta = rng.normal(0, 0.5, (2, 24)).astype(np.float32)
    ref = np.asarray(jax_convnext.GRN(24).apply(
        {"params": {"gamma": gamma, "beta": beta}}, jnp.asarray(x, jdt)), np.float32)
    grn = port_convnext.GRN(24)
    with torch.no_grad():
        grn.gamma.copy_(torch.from_numpy(gamma).reshape(1, 1, 1, -1))
        grn.beta.copy_(torch.from_numpy(beta).reshape(1, 1, 1, -1))
        got = grn(torch.from_numpy(x).to(tdt))
    assert got.dtype == torch.float32
    top = np.abs(ref).max()
    bound = 1e-6 * top if kind == "f32" else 2.0 ** (np.floor(np.log2(top)) - 7)
    assert np.abs(got.numpy() - ref).max() <= bound


def test_convnextv2_bridge_is_inverse_of_jax_converter():
    jm = jax_convnext.ConvNeXt(**V2, use_grn=True, block_impl="xla", mlp_impl="xla")
    flat = _drawn(numpy_variables(jm, V2_SIZE, 3), 3, ("gamma", "beta"))
    sd = convert.state_dict_from_flax(flat)
    assert set(sd) == set(port_convnext.ConvNeXt(**V2, use_grn=True).state_dict())
    variables = unflatten({k: np.zeros_like(v) for k, v in flat.items()})
    back, missing = convert_state_dict({k: v.numpy() for k, v in sd.items()}, variables,
                                       "ConvNeXt")
    assert missing == []
    for name, value in flatten(back).items():
        np.testing.assert_array_equal(np.asarray(value), flat[name])


def test_convnextv2_init_and_probe():
    """Published init: GRN at zero (the identity), no layer-scale; the probe
    init draws GRN's parameters so that they reach the logits."""
    kw = dict(depths=(1, 1), dims=(32, 64), seed=0, device="cpu")
    plain = create_classifier("convnextv2_base", **kw).model
    blk = plain.stages[1][0]
    assert blk.gamma is None and not any("gamma" == k.rsplit(".", 1)[-1]
                                         for k in plain.state_dict() if ".grn." not in k)
    assert torch.equal(blk.grn.gamma.detach(), torch.zeros(1, 1, 1, 256))
    probe = create_classifier("convnextv2_base", probe_init=True, **kw).model
    assert float(probe.stages[1][0].grn.beta.detach().abs().max()) > 0.1


@pytest.mark.parametrize("kind", list(DTYPES))
def test_swin_window12_matches_jax(kind):
    jdt, tdt = DTYPES[kind]
    jax_swin.shift_attn_mask(24, 24, 12, 6)  # numpy from jnp ops: made outside the trace
    np.testing.assert_array_equal(port_swin.shift_attn_mask(24, 24, 12, 6),
                                  jax_swin.shift_attn_mask(24, 24, 12, 6))
    jm = jax_swin.SwinTransformer(**SWIN, attention_impl="xla", dtype=jdt)
    flat = _drawn(numpy_variables(jm, SWIN_SIZE, 1), 1, ("relative_position_bias_table",))
    assert flat["params/stage0_block0/attn/relative_position_bias_table"].shape == (529, 4)
    pm = port_swin.SwinTransformer(**SWIN, img_size=SWIN_SIZE, dtype=tdt).eval()
    pm.load_state_dict(convert.state_dict_from_flax(flat))
    blocks = pm.blocks()
    assert [(b.ws, b.shift, b.fused) for b in blocks] == [(12, 0, True), (12, 6, True),
                                                          (12, 0, True), (12, 0, True)]
    x = np.random.default_rng(2).normal(0, 1, (2, SWIN_SIZE, SWIN_SIZE, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda v, xx: jm.apply(v, xx, train=False))(unflatten(flat), x),
                     np.float32)
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    _compare(got, ref, kind)


def test_swin_base_384_and_cvst_names():
    """``swin_base_384``: Swin-B at 384² with window 12, its table (2·12 −
    1)² rows, stage 0 shifted by 6 and stage 3 a single unshifted window;
    ``convnext_base_cvst``: ConvNeXt-B (V1, layer-scale)."""
    assert port_registry.MODELS["convnext_base_cvst"] is port_convnext.convnext_base
    assert port_registry.MODELS["convnextv2_base"] is port_convnext.convnextv2_base
    cvst = create_classifier("convnext_base_cvst", seed=0, device="cpu", depths=(1, 1),
                             dims=(32, 64)).model
    assert all(blk.grn is None and blk.gamma is not None for st in cvst.stages for blk in st)
    m = port_registry.get_model("swin_base_384", img_size=384)
    assert (m.embed_dim, m.depths, m.num_heads, m.window_size) == (128, (2, 2, 18, 2),
                                                                  (4, 8, 16, 32), 12)
    blocks = m.blocks()
    assert (blocks[0].ws, blocks[1].ws, blocks[1].shift) == (12, 12, 6)
    assert (blocks[-1].ws, blocks[-1].shift) == (12, 0)
    assert tuple(blocks[0].attn.relative_position_bias_table.shape) == (529, 4)
    assert all(b.fused for b in blocks)


def test_every_jax_transformer_name_resolves_in_the_port():
    """Every name of the JAX registry whose factory is a ViT, CLIP, Swin,
    ConvNeXt or MLP-Mixer resolves in the port, with the JAX package's input
    size, mean and std."""
    families = {"vit", "clip_vit", "swin", "convnext", "mlp_mixer"}
    names = [n for n in jax_registry.MODELS.names()
             if jax_registry.MODELS.get(n).__module__.rsplit(".", 1)[-1] in families
             or n.startswith("swin")]
    assert len(names) == 20
    for name in names:
        assert port_registry.model_meta(name) == jax_registry._META[name], name
        assert port_registry.MODELS[name].__module__.rsplit(".", 1)[-1] in families
