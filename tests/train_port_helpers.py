"""Shared set-up of the training tests: tiny models registered under the
same name in both packages, and configs for the two packages' training
solvers on the fake backend."""

import functools

import numpy as np
import torch

from robustart_torch.models import convert
from robustart_torch.models import registry as port_registry
from robustart_torch.models import resnet as port_resnet
from robustart_torch.models import vit as port_vit
from robustart_tpu.models import registry as jax_registry
from robustart_tpu.models import resnet as jax_resnet
from robustart_tpu.models import vit as jax_vit
from robustart_tpu.models.torch_convert import flatten

SIZE = 32
CLASSES = 10
TINY = {
    # a ResNet of one basic block a stage
    "tiny_resnet": (functools.partial(jax_resnet.ResNet, block=jax_resnet.BasicBlock,
                                      stage_sizes=(1, 1, 1, 1)),
                    functools.partial(port_resnet.ResNet, port_resnet.BasicBlock, (1, 1, 1, 1))),
    # a ViT of two blocks at width 128 in 2 heads: K6's and K7's plain versions
    "tiny_vit": (functools.partial(jax_vit.VisionTransformer, patch_size=8, embed_dim=128,
                                   depth=2, num_heads=2),
                 functools.partial(port_vit.VisionTransformer, patch_size=8, embed_dim=128,
                                   depth=2, num_heads=2, img_size=SIZE)),
}


def register_tiny(monkeypatch):
    """Register :data:`TINY` in both registries (the JAX side's variables
    then come from ``numpy_init``)."""
    meta = {"input_size": SIZE, "mean": (0.485, 0.456, 0.406), "std": (0.229, 0.224, 0.225)}
    for name, (jax_factory, port_factory) in TINY.items():
        monkeypatch.setitem(jax_registry.MODELS._factories, name, jax_factory)
        monkeypatch.setitem(jax_registry._META, name, dict(meta))
        monkeypatch.setitem(port_registry.MODELS, name, port_factory)
        monkeypatch.setitem(port_registry._META, name, dict(meta))


def recipe(kind: str, root, dtype: str | None = None) -> dict:
    """A 3-step training config on 8 fake images in batches of 8 (the test
    process has 8 CPU devices), one step an epoch, ``save_many`` so the JAX
    run leaves its state after every step (``ckpt_e{step}.msgpack``)."""
    cfg = {
        "seed": 0,
        "lr_scheduler": {"type": "Step", "kwargs": {"base_lr": 0.005, "warmup_lr": 0.01,
                                                    "warmup_steps": 1, "lr_steps": [2],
                                                    "lr_mults": [0.5], "max_iter": 3}},
        "label_smooth": 0.1,
        "ema": {"enable": True, "kwargs": {"decay": 0.9}},
        "data": {"read_from": "fake", "fake_size": 8, "fake_num_classes": CLASSES,
                 "batch_size": 8, "num_workers": 2, "input_size": SIZE, "test_resize": 36,
                 "train": {"sampler": {"type": "distributed_iteration"},
                           "transforms": {"type": "STANDARD"}},
                 "test": {"transforms": {"type": "ONECROP"}}},
        "saver": {"print_freq": 1, "val_freq": 100, "save_many": True,
                  "save_dir": str(root / "ckpt"), "results_path": str(root / "results.txt.all")},
    }
    if kind == "sgd_mix":
        cfg["model"] = {"type": "tiny_resnet", "kwargs": {"num_classes": CLASSES}}
        cfg["optimizer"] = {"type": "SGD", "kwargs": {"momentum": 0.9, "nesterov": True,
                                                      "weight_decay": 1e-4}}
        cfg["mixup"], cfg["cutmix"] = 0.2, 1.0
    else:
        cfg["model"] = {"type": "tiny_vit", "kwargs": {"num_classes": CLASSES}}
        cfg["optimizer"] = {"type": "AdamW", "kwargs": {"betas": [0.9, 0.999],
                                                        "weight_decay": 0.05}, "no_wd": True}
        cfg["lr_scheduler"]["kwargs"].update(base_lr=5e-4, warmup_lr=1e-3)
        if kind == "adamw_pgd":
            cfg["adv_train"] = {"enable": True, "attack": "pgd_linf",
                                "kwargs": {"eps": 0.01569, "rel_stepsize": 0.333, "steps": 2}}
    if dtype:
        cfg["model"]["dtype"] = dtype
    return cfg


def torch_state(variables, model_name: str) -> dict:
    """JAX variables → the port model's ``state_dict``."""
    flat = {k: np.asarray(v) for k, v in flatten(variables).items()}
    head_dim = 64 if model_name == "tiny_vit" else None
    return convert.state_dict_from_flax(flat, head_dim=head_dim)


def save_torch(variables, model_name: str, path) -> str:
    torch.save({"state_dict": torch_state(variables, model_name)}, path)
    return str(path)


def step_mix_key(seed: int, step: int):
    """The mix key of the JAX training step: ``fold_in(key(seed + 1), step)``
    → ``split(3)``, the first."""
    import jax

    return jax.random.split(jax.random.fold_in(jax.random.key(seed + 1), step), 3)[0]


def jax_draws(rng_mix, batch: int, h: int, w: int, mixup: float, cutmix: float):
    """The JAX ``mixup_cutmix``'s draws from its key, in its split order
    (``split(5)``)."""
    import jax
    import jax.numpy as jnp

    k_perm, k_lam_mix, k_lam_cut, k_switch, k_pos = jax.random.split(rng_mix, 5)
    one = jnp.float32(1.0)
    return (jax.random.permutation(k_perm, batch),
            jax.random.beta(k_lam_mix, mixup, mixup) if mixup > 0 else one,
            jax.random.beta(k_lam_cut, cutmix, cutmix) if cutmix > 0 else one,
            jax.random.bernoulli(k_switch, 0.5),
            jax.random.randint(k_pos, (), 0, h),
            jax.random.randint(jax.random.fold_in(k_pos, 1), (), 0, w))


def as_mix_draws(values):
    """JAX draws (``jax_draws``' tuple, as numpy) → the port's ``MixDraws``."""
    from robustart_torch.solvers.optim import MixDraws

    perm, lam_mix, lam_cut, use_mix, cy, cx = [torch.from_numpy(np.array(v)) for v in values]
    return MixDraws(perm.long(), lam_mix.float(), lam_cut.float(), use_mix.bool(), cy.long(),
                    cx.long())


def encoded_flax(shapes) -> dict:
    """Flat Flax leaves on ``shapes``, each filled with its own index: the
    weight bridge moves values, so a torch tensor's value names the leaf it
    came from."""
    return {k: np.full(s, i, np.float32) for i, (k, s) in enumerate(shapes.items())}


def assert_no_wd_mask_follows_flax(model, shapes, state_dict, name="") -> None:
    """The port's ``no_wd`` mask on ``model`` equals the JAX package's
    ``_no_wd_mask`` (decay a leaf with more than one axis) on the Flax
    shapes each parameter came from (``state_dict``: the bridge's output
    on :func:`encoded_flax`)."""
    from robustart_torch.solvers.optim import no_wd_mask

    paths = list(shapes)
    for key, decays in no_wd_mask(model).items():
        src = paths[int(state_dict[key].flatten()[0])]
        assert src.startswith("params/") and decays == (len(shapes[src]) > 1), (name, key, src)
