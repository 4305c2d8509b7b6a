"""The float CNN zoo's parameters against the JAX package's: for every zoo
name the JAX module's variables, on the shapes ``jax.eval_shape`` of its
init gives at 32² (nothing compiled or run), renamed by
``robustart_torch.models.convert`` are exactly the port model's
``state_dict`` keys and shapes (``test_torch_port_registry_shapes.py``
does the earlier families, ``test_torch_port_cnn_zoo_shapes_mobile.py``
the MobileNet and EfficientNet groups).

The shapes are traced with every initializer replaced by zeros of the
shape it is asked for (a Flax ``Scope.param`` patch: the shapes do not
change, the trace of the random draws is skipped), and modules that differ
only in dropout are traced once. The port models are built on the ``meta``
device. The NAS budgets whose widths repeat across a strided stage boundary
fail at their first forward in the JAX package; the port's fail alike.
"""

import tests.torch_port_threads  # noqa: F401  (before any torch work)
import jax
import jax.numpy as jnp
import pytest
import torch
from flax.core import scope as flax_scope

from robustart_torch.models import convert
from robustart_torch.models import registry as port_registry
from robustart_tpu.models import registry as jax_registry
from robustart_tpu.models.torch_convert import flatten
from tests.train_port_helpers import assert_no_wd_mask_follows_flax, encoded_flax

_ZOO_MODULES = {f"robustart_torch.models.{m}" for m in (
    "mobilenet", "efficientnet", "regnet", "repvgg", "shufflenet", "googlenet", "nas_zoo")}
ZOO = [n for n in port_registry.model_names()
       if port_registry.MODELS[n].__module__ in _ZOO_MODULES]
GROUPS = {
    "mobilenet": ("mobilenet",),
    "efficientnet": ("efficientnet",),
    "regnetx": ("regnetx",),
    "regnety": ("regnety",),
    "repvgg_shufflenet_googlenet": ("repvgg", "shufflenet", "googlenet"),
    "nas_resnet18": ("bignas_resnet18", "dmcp", "dmna"),
    "nas_other": ("bignas_det", "bignas_resnet50", "oneshot", "crnas", "resnet18c"),
}


def _group(group):
    return [n for n in ZOO if n.startswith(GROUPS[group])]


def test_groups_cover_the_zoo():
    assert sorted(n for g in GROUPS for n in _group(g)) == ZOO and len(ZOO) == 85


def _jax_shapes(module, size=32):
    """Flat {path: shape} of the module's variables, or None where its
    forward fails (the trace of init runs it)."""
    try:
        tree = jax.eval_shape(lambda: module.init(
            {"params": jax.random.key(0)}, jnp.zeros((1, size, size, 3)), train=False))
    except TypeError:
        return None
    return {k: v.shape for k, v in flatten(tree).items()}


@pytest.fixture
def zero_init(monkeypatch):
    param = flax_scope.Scope.param

    def zero_param(self, name, init_fn, *args, **kwargs):
        return param(self, name, lambda key, shape, dtype=jnp.float32, *a: jnp.zeros(shape, dtype),
                     *args, **kwargs)

    monkeypatch.setattr(flax_scope.Scope, "param", zero_param)


# the groups this file checks; test_torch_port_cnn_zoo_shapes_mobile.py
# checks the others (a file each keeps the two under a minute)
MOBILE_GROUPS = ("mobilenet", "efficientnet")


@pytest.mark.parametrize("group", [g for g in GROUPS if g not in MOBILE_GROUPS])
def test_parameter_shapes_match_jax(group, zero_init):
    check_group(group)


def check_group(group):
    """Every name of ``group``: the bridged JAX shapes are the port model's
    state_dict, and the port's ``no_wd`` mask is the JAX package's rule."""
    traced = {}
    for name in _group(group):
        module = jax_registry.get_model(name, num_classes=10)
        key = module.clone(**{f: 0.0 for f in ("dropout", "drop_path") if hasattr(module, f)})
        if key not in traced:
            traced[key] = _jax_shapes(module)
        shapes = traced[key]
        if shapes is None:
            model = port_registry.get_model(name, num_classes=10).eval()
            with pytest.raises(RuntimeError):
                model(torch.zeros(1, 32, 32, 3))
            continue
        with torch.device("meta"):
            model = port_registry.get_model(name, num_classes=10)
        want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
        sd = convert.state_dict_from_flax(encoded_flax(shapes))
        got = {k: tuple(v.shape) for k, v in sd.items()}
        assert got == want, name
        assert_no_wd_mask_follows_flax(model, shapes, sd, name)
