"""The port's ViT/DeiT, its weight bridge and its solver path against the
JAX package.

The JAX model's variables (LayerNorm parameters and biases randomized from
numpy, so that a mapping error shows) go through
``robustart_torch.models.convert`` into the port's timm-named model; both
forwards then take the same normalized NHWC batch. The JAX model runs its
XLA path (``attention_impl="xla"``). Tolerance at f32: max|Δlogit| ≤
2e-4·max|logit| and equal argmax, the tolerance of the JAX package's own
fused-against-XLA ViT test (tests/test_pallas_window_block.py:261).
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustart_torch.core.config import Config as PortConfig
from robustart_torch.core.config import load_config
from robustart_torch.models import convert, create_classifier
from robustart_torch.models import registry as port_registry
from robustart_torch.models import vit as port_vit
from robustart_torch.solvers import MultiEvalSolver as PortSolver
from robustart_tpu.core.config import Config
from robustart_tpu.models import registry as jax_registry
from robustart_tpu.models import vit as jax_vit
from robustart_tpu.models.torch_convert import convert_state_dict, flatten, unflatten
from robustart_tpu.noise.corruptions import jax_kernels as jk
from robustart_tpu.solvers import MultiEvalSolver as JaxSolver
from tests.test_torch_port_resnet import numpy_init

TINY = {"fused": dict(embed_dim=128, num_heads=4), "unfused": dict(embed_dim=96, num_heads=3)}


def _jax_model(embed_dim, num_heads, dtype=jnp.float32):
    return jax_vit.VisionTransformer(patch_size=8, embed_dim=embed_dim, depth=2,
                                     num_heads=num_heads, num_classes=10,
                                     attention_impl="xla", dtype=dtype)


def _port_model(embed_dim, num_heads, dtype=torch.float32):
    return port_vit.VisionTransformer(patch_size=8, embed_dim=embed_dim, depth=2,
                                      num_heads=num_heads, num_classes=10, img_size=32,
                                      dtype=dtype).eval()


@functools.lru_cache(maxsize=None)
def _init(kind):
    """One jitted init of a kind's f32 module, the key its argument: every
    dtype has the same f32 parameters, and every seed takes the one compile."""
    jm = _jax_model(**TINY[kind])
    return jax.jit(lambda k: jm.init(k, jnp.zeros((1, 32, 32, 3)), train=False))


def _flax_vars(kind, seed):
    """Flat numpy variables with every LayerNorm parameter, bias and the
    class token drawn from numpy (fresh ones are 1 or 0 and hide errors)."""
    v = _init(kind)(jax.random.key(seed))
    rng = np.random.default_rng(seed)
    flat = {}
    for name, a in flatten(v).items():
        a = np.asarray(a, np.float32)
        leaf = name.rsplit("/", 1)[-1]
        if leaf == "scale":
            a = rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        elif leaf in ("bias", "cls_token"):
            a = rng.normal(0.0, 0.1, a.shape).astype(np.float32)
        flat[name] = a
    return flat


def _pair(kind, seed, jdtype=jnp.float32, tdtype=torch.float32):
    cfg = TINY[kind]
    jm = _jax_model(**cfg, dtype=jdtype)
    flat = _flax_vars(kind, seed)
    pm = _port_model(**cfg, dtype=tdtype)
    head_dim = cfg["embed_dim"] // cfg["num_heads"]
    pm.load_state_dict(convert.state_dict_from_flax(flat, head_dim=head_dim))
    x = np.random.default_rng(seed + 1).normal(0, 0.5, (2, 32, 32, 3)).astype(np.float32)
    apply = jax.jit(lambda v, xx: jm.apply(v, xx, train=False))
    ref = np.asarray(apply(unflatten(flat), x), np.float32)
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    return pm, got, ref


@pytest.mark.parametrize("kind", ["fused", "unfused"])
def test_vit_matches_jax(kind):
    """C = 128, 4 heads takes K6 in every block; C = 96, 3 heads the unfused
    branch with K8; both the K7 MLP."""
    pm, got, ref = _pair(kind, 0)
    assert all(blk.fused == (kind == "fused") for blk in pm.blocks)
    assert np.abs(got - ref).max() <= 2e-4 * np.abs(ref).max()
    np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))


@pytest.mark.parametrize("kind", ["fused", "unfused"])
def test_bf16_vit_matches_jax(kind):
    """bf16 against the JAX XLA path in bf16. The two round at different
    places (the fused kernels add biases and residuals in f32 and cast once,
    XLA rounds to bf16 after each product and each add), each rounding worth
    up to 2^-9 relative: the JAX package's own bf16 and f32 logits differ by
    about 1e-2·max|logit| here. Held to 3e-2·max|logit|."""
    _, got, ref = _pair(kind, 2, jnp.bfloat16, torch.bfloat16)
    assert got.dtype == np.float32 and np.isfinite(got).all()
    assert np.abs(got - ref).max() <= 3e-2 * np.abs(ref).max()


def test_bridge_is_inverse_of_jax_converter():
    """Flax → the port's timm-named state dict → the JAX package's
    torch→Flax converter gives back every tensor unchanged."""
    flat = _flax_vars("fused", 3)
    sd = convert.state_dict_from_flax(flat, head_dim=32)
    variables = unflatten({k: np.zeros_like(v) for k, v in flat.items()})
    back, missing = convert_state_dict({k: v.numpy() for k, v in sd.items()}, variables,
                                       "VisionTransformer", head_dim=32)
    assert missing == []
    for name, value in flatten(back).items():
        np.testing.assert_array_equal(np.asarray(value), flat[name])
    assert set(sd) == set(_port_model(**TINY["fused"]).state_dict())
    with pytest.raises(ValueError, match="head_dim"):
        convert.state_dict_from_flax(flat)


def test_create_classifier_builds_deit_tiny_and_vit_base():
    """The registry takes num_classes from the model, not from a ResNet's
    ``fc``; DeiT-Tiny takes the unfused branch, ViT-B the fused one in both
    types; the ViT init rule."""
    deit = create_classifier("deit_tiny_b16_224", seed=0, device="cpu")
    assert deit.num_classes == 1000 and not any(b.fused for b in deit.model.blocks)
    model = deit.model
    assert torch.equal(model.cls_token, torch.zeros_like(model.cls_token))
    assert float(model.pos_embed.detach().abs().max()) <= 0.04
    assert 0.015 < float(model.pos_embed.detach().std()) < 0.025
    assert torch.equal(model.blocks[0].norm1.weight, torch.ones(192))
    assert not model.blocks[0].attn.qkv.bias.detach().any()
    with torch.no_grad():
        out = deit(torch.rand((1, 224, 224, 3), generator=torch.Generator().manual_seed(0)))
    assert out.shape == (1, 1000) and torch.isfinite(out).all()
    for dtype in (torch.float32, torch.bfloat16):
        vit = port_registry.get_model("vit_base", dtype=dtype, qkv_bias=True, drop_path=0.1,
                                      dropout=0.0, attention_dropout=0.0, bn={})
        assert vit.dtype == dtype and all(b.fused for b in vit.blocks)
        assert vit.blocks[0].attn.qkv.weight.dtype == dtype
        assert vit.blocks[0].attn.qkv.bias.dtype == torch.float32
        assert vit.head.weight.dtype == torch.float32
    names = {"vit_b16_224", "vit_base", "vit_b32_224", "deit_tiny_b16_224",
             "deit_small_b16_224", "deit_base_b16_224", "vit_base_cvst"}
    assert names <= set(port_registry.model_names()) & set(jax_registry.model_names())


def test_vit_config_kwargs_and_timm_checkpoint_reach_the_model(tmp_path):
    """``config_vit_base.yaml``'s model block builds the model, and a
    timm-named checkpoint under ``saver.pretrain.path`` loads in full."""
    src = create_classifier("deit_tiny_b16_224", seed=5, device="cpu").model
    path = tmp_path / "deit.pth"
    torch.save({"model": {f"module.{k}": v for k, v in src.state_dict().items()}}, path)
    cfg = load_config("exprs/exp/imagenet_c_loop_mini/config_vit_base.yaml")
    model_cfg = dict(cfg.model)
    model_cfg["type"] = "deit_tiny_b16_224"
    cfg = PortConfig({**dict(cfg), "model": model_cfg,
                      "saver": {"pretrain": {"path": str(path)}}})
    solver = PortSolver(cfg, device="cpu")
    clf = solver.build_model(seed=0)
    for name, value in src.state_dict().items():
        assert torch.equal(clf.model.state_dict()[name], value), name


def _solver_cfg(results):
    cfg = load_config("exprs/exp/imagenet_c_loop_mini/config_vit_base.yaml")
    out = {k: v for k, v in dict(cfg).items() if k not in ("saver", "data")}
    out["model"] = {**dict(cfg.model), "type": "vit_tiny_test"}
    out["data"] = {
        "batch_size": 4, "num_workers": 2, "input_size": 32, "test_resize": 36,
        "read_from": "fake", "fake_size": 8, "fake_num_classes": 10,
        "test": {"imagenet_c_online": True, "transforms": {"type": "JUSTNORM"},
                 "sampler": {"type": "distributed"}, "limit_samples": 8,
                 "corruptions": ["gaussian_noise", "glass_blur"], "severities": [1, 3],
                 "evaluator": {"type": "imagenetc", "kwargs": {"topk": [1, 5]}}},
    }
    out["saver"] = {"results_dir": str(results)}
    return out


def test_online_solver_matches_jax_with_zero_draws(tmp_path, monkeypatch):
    """Both solvers online on a fake-backend copy of config_vit_base.yaml
    with a tiny ViT (the fused branch) and the same weights, every random
    draw zero: the same top-1 in every result file, logits within the f32
    tolerance."""
    cfg = TINY["fused"]
    jax_factory = lambda **kw: _jax_model(**cfg)  # noqa: E731
    port_factory = lambda **kw: _port_model(**cfg)  # noqa: E731
    monkeypatch.setitem(jax_registry.MODELS._factories, "vit_tiny_test", jax_factory)
    monkeypatch.setitem(jax_registry._META, "vit_tiny_test",
                        {**jax_registry._META["vit_b16_224"], "input_size": 32})
    monkeypatch.setitem(port_registry.MODELS, "vit_tiny_test", port_factory)
    monkeypatch.setitem(port_registry._META, "vit_tiny_test", port_registry._META["vit_base"])
    # zero draws: no Gaussian noise, glass offsets all (0, 0)
    monkeypatch.setitem(jk.CORRUPTIONS, "gaussian_noise", lambda x, key, severity=1: x)
    monkeypatch.setattr(jax.random, "randint",
                        lambda key, shape, lo, hi, *a, **k: jnp.zeros(shape, jnp.int32))
    from robustart_torch.noise import corruptions as pc
    from robustart_torch.solvers import multi_eval_solver as pme

    monkeypatch.setitem(pme.NOISE_SEVERITY, "gaussian_noise", [0.0] * 5)
    glass = pc.CORRUPTIONS["glass_blur"]

    def glass_zero(x, severity=1, *, generator=None):
        iters = pc.GLASS_SEVERITY[severity - 1][2]
        return glass(x, severity, offsets=torch.zeros((iters, *x.shape[:3], 2)))

    monkeypatch.setitem(pc.CORRUPTIONS, "glass_blur", glass_zero)

    numpy_init(monkeypatch)
    jax_solver = JaxSolver(Config(_solver_cfg(tmp_path / "jax")))
    jax_solver.build_model(seed=0)
    jax_summary = jax_solver.evaluate()
    port = PortSolver(PortConfig(_solver_cfg(tmp_path / "port")), device="cpu")
    port.build_model(seed=0)
    flat = {k: np.asarray(v) for k, v in flatten(jax_solver.classifier.variables).items()}
    port.classifier.model.load_state_dict(convert.state_dict_from_flax(flat, head_dim=32))
    port_summary = port.evaluate()
    assert port_summary["top1_per_corruption"] == jax_summary["top1_per_corruption"]
    for corr in ("gaussian_noise", "glass_blur"):
        for sev in ("1", "3"):
            a = [json.loads(x) for x in open(tmp_path / "jax" / corr / sev / "results.txt.all")]
            b = [json.loads(x) for x in open(tmp_path / "port" / corr / sev / "results.txt.all")]
            sa, sb = np.array([r["score"] for r in a]), np.array([r["score"] for r in b])
            assert sa.shape == sb.shape == (8, 10)
            np.testing.assert_array_equal(sa.argmax(-1), sb.argmax(-1))
            assert np.abs(sa - sb).max() <= 2e-4 * np.abs(sa).max()
