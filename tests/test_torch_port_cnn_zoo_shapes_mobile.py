"""The MobileNet and EfficientNet groups of the float CNN zoo's parameter
check (``test_torch_port_cnn_zoo_shapes.py``: every name's JAX variables,
on ``jax.eval_shape``'s shapes at 32², renamed by
``robustart_torch.models.convert``, are exactly the port model's
``state_dict`` keys and shapes, and its ``no_wd`` mask the JAX rule)."""

import tests.torch_port_threads  # noqa: F401  (before any torch work)
import pytest

from tests.test_torch_port_cnn_zoo_shapes import MOBILE_GROUPS, check_group, zero_init  # noqa: F401


@pytest.mark.parametrize("group", MOBILE_GROUPS)
def test_parameter_shapes_match_jax(group, zero_init):
    check_group(group)
