"""The port's registry against the JAX package's: the same names, input
sizes, means and stds; and for every name of the families before the float
CNN zoo (``test_torch_port_cnn_zoo_shapes.py`` does the zoo) the same
parameters: the JAX module's variables, on the shapes ``jax.eval_shape``
of its init gives at the model's own input size (a ViT's position table, a
Swin's windows and a Mixer's token MLP follow it), renamed by
``robustart_torch.models.convert`` (a packed q/k/v with the model's head
width) are exactly the port model's ``state_dict`` keys and shapes. The
initializers are patched to zeros as in the zoo's file, and aliases (one
JAX module at one size) are traced once.
"""

import tests.torch_port_threads  # noqa: F401  (before any torch work)
import pytest
import torch

from robustart_torch.models import convert
from robustart_torch.models import registry as port_registry
from robustart_tpu.models import registry as jax_registry
from robustart_tpu.models import swin as jax_swin
from tests.test_torch_port_cnn_zoo_shapes import ZOO, _jax_shapes, zero_init  # noqa: F401
from tests.train_port_helpers import assert_no_wd_mask_follows_flax, encoded_flax

EARLIER = [n for n in port_registry.model_names() if n not in ZOO]
# (JAX module, input size) → its names: aliases are traced once
DISTINCT = {}
for _name in EARLIER:
    _size = port_registry.model_meta(_name)["input_size"]
    DISTINCT.setdefault((jax_registry.get_model(_name, num_classes=10), _size), []).append(_name)
DISTINCT = list(DISTINCT.items())


def test_model_names_and_meta_equal_jax():
    assert port_registry.model_names() == jax_registry.model_names()
    for name in port_registry.model_names():
        want, got = jax_registry.model_meta(name), port_registry.model_meta(name)
        assert got["input_size"] == want["input_size"], name
        assert tuple(got["mean"]) == tuple(want["mean"]), name
        assert tuple(got["std"]) == tuple(want["std"]), name


def _head_dim(model):
    """The attention head width the bridge needs for a packed q/k/v."""
    width = getattr(model, "embed_dim", None) or getattr(model, "width", None)
    return width // model.num_heads if width and isinstance(model.num_heads, int) else None


@pytest.mark.parametrize("chunk", range(3))
def test_earlier_families_parameter_shapes_match_jax(chunk, zero_init):
    for size, ws in ((224, 7), (384, 12)):  # Swin's numpy masks: made outside the trace
        for r in (size // 4, size // 8, size // 16):
            jax_swin.shift_attn_mask(r, r, ws, ws // 2)
    for (module, size), names in DISTINCT[chunk::3]:
        shapes = _jax_shapes(module, size)
        flat = encoded_flax(shapes)
        for name in names:
            sized = port_registry.MODELS[name] in port_registry._SIZED
            with torch.device("meta"):
                model = port_registry.get_model(name, num_classes=10,
                                                **({"img_size": size} if sized else {}))
            want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
            sd = convert.state_dict_from_flax(flat, head_dim=_head_dim(model))
            got = {k: tuple(v.shape) for k, v in sd.items()}
            assert got == want, name
            assert_no_wd_mask_follows_flax(model, shapes, sd, name)
