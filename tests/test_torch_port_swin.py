"""The port's Swin Transformer and its weight bridge against the JAX package.

The JAX model's variables (LayerNorm parameters, biases and the relative-
position bias tables randomized from numpy, so that a mapping error shows)
go through ``robustart_torch.models.convert`` into the port's
Microsoft-named model; both forwards then take the same normalized NHWC
batch. The JAX model runs its XLA path (``attention_impl="xla"``): on the
CPU the port runs the plain versions of K6, K7 and K9. Tolerance at f32:
max|Δlogit| ≤ 2e-4·max|logit| and equal argmax, the tolerance of the JAX
package's own fused-against-XLA tests.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustart_torch.core.config import Config as PortConfig
from robustart_torch.core.config import load_config
from robustart_torch.models import convert, create_classifier
from robustart_torch.models import registry as port_registry
from robustart_torch.models import swin as port_swin
from robustart_torch.solvers import MultiEvalSolver as PortSolver
from robustart_tpu.models import registry as jax_registry
from robustart_tpu.models import swin as jax_swin
from robustart_tpu.models.torch_convert import convert_state_dict, flatten, unflatten
from robustart_tpu.ops import pallas_attention as ja

# fused: every block through K6 (C = 128); unfused: C = 24 and 48, LN +
# q/k/v product + K9 (head width 8 here: the CPU plain version takes any)
TINY = {"fused": dict(embed_dim=128, depths=(2,), num_heads=(4,)),
        "unfused": dict(embed_dim=24, depths=(2, 2), num_heads=(3, 6))}
SIZE = 56  # 14² tokens after the 4×4 patches: two windows of 7 a side, shift 3


def _jax_model(cfg, dtype=jnp.float32):
    return jax_swin.SwinTransformer(**cfg, window_size=7, num_classes=10, drop_path=0.0,
                                    attention_impl="xla", dtype=dtype)


def _port_model(cfg, dtype=torch.float32):
    return port_swin.SwinTransformer(**cfg, window_size=7, num_classes=10, drop_path=0.0,
                                     img_size=SIZE, dtype=dtype).eval()


@functools.lru_cache(maxsize=None)
def _init(kind):
    """One jitted init of a kind's f32 module, the key its argument: every
    dtype has the same f32 parameters, and every seed takes the one compile."""
    jax_swin.shift_attn_mask(14, 14, 7, 3)  # numpy built from jnp ops: made outside the jit
    jm = _jax_model(TINY[kind])
    return jax.jit(lambda k: jm.init(k, jnp.zeros((1, SIZE, SIZE, 3)), train=False))


def _flax_vars(kind, seed):
    """Flat numpy variables with every LayerNorm parameter, bias and bias
    table drawn from numpy (fresh ones are 1, 0 or near 0 and hide errors)."""
    v = _init(kind)(jax.random.key(seed))
    rng = np.random.default_rng(seed)
    flat = {}
    for name, a in flatten(v).items():
        a = np.asarray(a, np.float32)
        leaf = name.rsplit("/", 1)[-1]
        if leaf == "scale":
            a = rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        elif leaf == "bias":
            a = rng.normal(0.0, 0.1, a.shape).astype(np.float32)
        elif leaf == "relative_position_bias_table":
            a = rng.normal(0.0, 0.5, a.shape).astype(np.float32)
        flat[name] = a
    return flat


def _pair(kind, seed, jdtype=jnp.float32, tdtype=torch.float32):
    jm = _jax_model(TINY[kind], jdtype)
    flat = _flax_vars(kind, seed)
    pm = _port_model(TINY[kind], tdtype)
    pm.load_state_dict(convert.state_dict_from_flax(flat))
    x = np.random.default_rng(seed + 1).normal(0, 0.5, (2, SIZE, SIZE, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda v, xx: jm.apply(v, xx, train=False))(unflatten(flat), x),
                     np.float32)
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    return pm, got, ref


@pytest.mark.parametrize("kind", ["fused", "unfused"])
def test_swin_matches_jax(kind):
    """C = 128, 4 heads takes K6 with the bias and shift mask in both
    blocks; C = 24/48 the unfused branch with K9 and a patch merge; all K7."""
    pm, got, ref = _pair(kind, 0)
    assert all(blk.fused == (kind == "fused") for blk in pm.blocks())
    assert pm.blocks()[1].shift == 3
    assert np.abs(got - ref).max() <= 2e-4 * np.abs(ref).max()
    np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))


@pytest.mark.parametrize("kind", ["fused", "unfused"])
def test_bf16_swin_matches_jax(kind):
    """bf16 against the JAX XLA path in bf16. The two round at different
    places (the port's kernels add biases and residuals in f32 and cast
    once, K9 keeps f32 scores; XLA rounds to bf16 after each product and
    add), each rounding worth up to 2^-9 relative. Held to 3e-2·max|logit|,
    the bound of the ViT test."""
    _, got, ref = _pair(kind, 2, jnp.bfloat16, torch.bfloat16)
    assert got.dtype == np.float32 and np.isfinite(got).all()
    assert np.abs(got - ref).max() <= 3e-2 * np.abs(ref).max()


@pytest.mark.parametrize("kind", ["fused", "unfused"])
def test_bridge_is_inverse_of_jax_converter(kind):
    """Flax → the port's Microsoft-named state dict → the JAX package's
    torch→Flax converter (its head-major q/k/v and merge-order fixups
    included) gives back every tensor unchanged."""
    flat = _flax_vars(kind, 3)
    sd = convert.state_dict_from_flax(flat)
    head_dim = TINY[kind]["embed_dim"] // TINY[kind]["num_heads"][0]
    variables = unflatten({k: np.zeros_like(v) for k, v in flat.items()})
    back, missing = convert_state_dict({k: v.numpy() for k, v in sd.items()}, variables,
                                       "SwinTransformer", head_dim=head_dim)
    assert missing == []
    for name, value in flatten(back).items():
        np.testing.assert_array_equal(np.asarray(value), flat[name])
    assert set(sd) == set(_port_model(TINY[kind]).state_dict())


@pytest.mark.parametrize("name", ["swin_tiny", "swin_small", "swin_base"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_branch_choice_is_the_jax_rule(name, dtype):
    """Each block's fused/unfused branch is ``block_kernel_head_groups`` of
    the JAX package at its width, heads and item size: Swin-B fused in all
    24 blocks; Swin-T unfused in its 4 blocks at C = 96 and 192 (K9) and
    fused in the 8 at C = 384 and 768; no shift where the window is the
    resolution (stage 3 at 224²)."""
    model = port_registry.get_model(name, dtype=dtype)
    itemsize = torch.empty((), dtype=dtype).element_size()
    want = [ja.block_kernel_head_groups(blk.norm1.normalized_shape[0], blk.attn.num_heads,
                                        itemsize) is not None for blk in model.blocks()]
    assert [blk.fused for blk in model.blocks()] == want
    if name == "swin_base":
        assert all(want)
    if name == "swin_tiny":
        assert want == [False] * 4 + [True] * 8
    assert all(blk.shift == 0 for blk in model.layers[3].blocks)
    assert all(blk.shift == (3 if i % 2 else 0) for i, blk in enumerate(model.layers[0].blocks))


def test_create_classifier_swin_init_and_names():
    """Published init: bias tables of std 0.02 cut at two std; ``probe_init``
    draws them at unit scale. The products' weights follow the dtype, the
    tables, LN parameters and the head stay f32. The names are in both
    registries."""
    clf = create_classifier("swin_tiny", seed=0, device="cpu")
    table = clf.model.layers[0].blocks[0].attn.relative_position_bias_table.detach()
    assert float(table.abs().max()) <= 0.04 and 0.015 < float(table.std()) < 0.025
    probe = create_classifier("swin_tiny", seed=0, device="cpu", probe_init=True)
    table = probe.model.layers[0].blocks[0].attn.relative_position_bias_table.detach()
    assert 0.8 < float(table.std()) < 1.2
    with torch.no_grad():
        out = probe(torch.rand((1, 224, 224, 3), generator=torch.Generator().manual_seed(0)))
    assert out.shape == (1, 1000) and torch.isfinite(out).all()
    model = port_registry.get_model("swin_base_224", dtype=torch.bfloat16, bn={})
    blk = model.layers[2].blocks[0]
    assert blk.attn.qkv.weight.dtype == torch.bfloat16 and blk.attn.qkv.bias.dtype == torch.float32
    assert blk.attn.relative_position_bias_table.dtype == torch.float32
    assert model.layers[0].downsample.reduction.weight.dtype == torch.bfloat16
    assert model.head.weight.dtype == torch.float32
    names = {"swin_tiny", "swin_small", "swin_base", "swin_base_224"}
    assert names <= set(port_registry.model_names()) & set(jax_registry.model_names())


def test_swin_config_and_official_checkpoint_reach_the_model(tmp_path):
    """``exprs/exp/swin/config.yaml``'s model block builds the model, and a
    checkpoint with Microsoft's names (and its buffers, which the port
    computes instead: ``relative_position_index``, ``attn_mask``) under
    ``saver.pretrain.path`` loads every tensor."""
    src = create_classifier("swin_tiny", seed=5, device="cpu", probe_init=True).model
    sd = dict(src.state_dict())
    sd["layers.0.blocks.0.attn.relative_position_index"] = torch.zeros((49, 49), dtype=torch.long)
    sd["layers.0.blocks.1.attn_mask"] = torch.zeros((64, 49, 49))
    path = tmp_path / "swin.pth"
    torch.save({"model": sd}, path)
    cfg = load_config("exprs/exp/swin/config.yaml")
    cfg = PortConfig({**dict(cfg), "model": {**dict(cfg.model), "type": "swin_tiny"},
                      "saver": {"pretrain": {"path": str(path)}}})
    clf = PortSolver(cfg, device="cpu").build_model(seed=0)
    for name, value in src.state_dict().items():
        assert torch.equal(clf.model.state_dict()[name], value), name
