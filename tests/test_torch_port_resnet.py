"""The port's ResNet and weight bridge against the JAX package.

The JAX model's variables (every one drawn from numpy on the shapes of its
init, BatchNorm statistics and affine parameters too: fresh BN is the
identity and would hide a mapping error) go through
``robustart_torch.models.convert`` into the port's torchvision-named ResNet;
both forwards then take the same normalized NHWC batch in float32.
Tolerance: max|Δlogit| ≤ 1e-4·max|logit| (the two frameworks sum
convolutions in different orders) and equal argmax.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustart_torch.core.config import load_config
from robustart_torch.models import convert, create_classifier
from robustart_torch.models import resnet as port_resnet
from robustart_tpu.models import registry as jax_registry
from robustart_tpu.models import resnet as jax_resnet
from robustart_tpu.models.classifier import Classifier
from robustart_tpu.models.torch_convert import convert_state_dict, flatten, unflatten


def numpy_variables(module, size, seed):
    """Flat numpy variables of a Flax module, on the shapes its init makes
    (``jax.eval_shape``: nothing is compiled or run), every one drawn from
    numpy: kernels N(0, 2/fan_in), BatchNorm means and biases N(0, 0.1),
    variances and scales U(0.5, 1.5), any other leaf N(0, 0.02)."""
    shapes = jax.eval_shape(lambda: module.init(
        {"params": jax.random.key(0)}, jnp.zeros((1, size, size, 3)), train=False))
    rng = np.random.default_rng(seed)
    flat = {}
    for name, s in flatten(shapes).items():
        leaf = name.rsplit("/", 1)[-1]
        if leaf == "kernel":
            v = rng.normal(0.0, np.sqrt(2.0 / np.prod(s.shape[:-1])), s.shape)
        elif leaf in ("var", "scale"):
            v = rng.uniform(0.5, 1.5, s.shape)
        elif leaf in ("mean", "bias"):
            v = rng.normal(0.0, 0.1, s.shape)
        else:
            v = rng.normal(0.0, 0.02, s.shape)
        flat[name] = v.astype(np.float32)
    return flat


def numpy_init(monkeypatch):
    """Make the JAX package's ``create_classifier`` (and so a JAX solver's
    ``build_model``) take :func:`numpy_variables` seeded by its ``rng``, in
    place of Flax's init, which runs op by op and compiles each op and
    shape on its own (seconds for one ResNet)."""

    def init(name, module, rng=0, input_size=224, mean=None, std=None, num_classes=None):
        return Classifier(name=name, module=module,
                          variables=unflatten(numpy_variables(module, input_size, rng)),
                          mean=mean, std=std, input_size=input_size,
                          num_classes=num_classes or getattr(module, "num_classes", 1000))

    monkeypatch.setattr(jax_registry, "init_classifier", init)


def _parity(jax_module, port_model, size, seed):
    flat = numpy_variables(jax_module, size, seed)
    port_model.load_state_dict(convert.state_dict_from_flax(flat))
    port_model.eval()
    x = np.random.default_rng(seed + 1).normal(0, 1, (2, size, size, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda v, xx: jax_module.apply(v, xx, train=False))(
        unflatten(flat), x))
    with torch.no_grad():
        got = port_model(torch.from_numpy(x)).numpy()
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= 1e-4 * scale
    np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))


def test_bottleneck_resnet_matches_jax():
    _parity(
        jax_resnet._resnet(jax_resnet.Bottleneck, (1, 1, 1, 1), num_classes=10),
        port_resnet._resnet(port_resnet.Bottleneck, (1, 1, 1, 1), num_classes=10),
        32, 0,
    )


def test_resnet50_matches_jax():
    _parity(jax_resnet.resnet50(), port_resnet.resnet50(), 64, 1)


def test_bridge_is_inverse_of_jax_converter():
    """Flax → port state dict → the JAX package's torch→Flax converter gives
    back every tensor unchanged."""
    flat = numpy_variables(jax_resnet.resnet18(num_classes=10), 32, 2)
    sd = {k: v.numpy() for k, v in convert.state_dict_from_flax(flat).items()}
    variables = unflatten({k: np.zeros_like(v) for k, v in flat.items()})
    back, missing = convert_state_dict(sd, variables, "ResNet")
    assert missing == []
    for name, value in flatten(back).items():
        np.testing.assert_array_equal(np.asarray(value), flat[name])
    port = create_classifier("resnet18", device="cpu", num_classes=10)
    port.model.load_state_dict(convert.state_dict_from_flax(flat))


@pytest.mark.parametrize("wrap", ["state_dict", "model", "net", None])
def test_read_torch_checkpoint_layouts(tmp_path, wrap):
    model = create_classifier("resnet18", seed=3, device="cpu", num_classes=10).model
    sd = {f"module.{k}": v for k, v in model.state_dict().items()}
    path = tmp_path / "ckpt.pth"
    torch.save({wrap: sd, "epoch": 1} if wrap else sd, path)
    loaded = convert.read_torch_checkpoint(str(path))
    assert set(loaded) == set(model.state_dict())
    fresh = create_classifier("resnet18", seed=4, device="cpu", num_classes=10).model
    assert convert.load_pretrain(fresh, loaded, ignore_model=[r"^fc\."]) == len(loaded) - 2
    torch.testing.assert_close(fresh.conv1.weight, model.conv1.weight, rtol=0, atol=0)
    assert not torch.equal(fresh.fc.weight, model.fc.weight)


def test_bf16_body_f32_head_and_s2d_flag():
    x = torch.rand((2, 32, 32, 3), generator=torch.Generator().manual_seed(0))
    f32 = create_classifier("resnet18", seed=0, device="cpu", num_classes=10)
    s2d = create_classifier("resnet18", seed=0, device="cpu", num_classes=10,
                            stem_s2d=True)
    bf16 = create_classifier("resnet18", seed=0, device="cpu", num_classes=10,
                             dtype=torch.bfloat16)
    assert bf16.model.conv1.weight.dtype == torch.bfloat16
    assert bf16.model.fc.weight.dtype == torch.float32
    assert bf16.model.conv1.weight.is_contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        a, b, c = f32(x), s2d(x), bf16(x)
    assert torch.equal(a, b)
    assert c.dtype == torch.float32 and torch.isfinite(c).all()
    assert torch.allclose(a, c, atol=0.1 * float(a.abs().max()))


def test_config_expands_env(tmp_path, monkeypatch):
    path = tmp_path / "c.yaml"
    path.write_text("data:\n  root: ${RA_TEST_ROOT:-/d}/x\n  other: ${RA_TEST_SET}/y\n")
    monkeypatch.delenv("RA_TEST_ROOT", raising=False)
    monkeypatch.setenv("RA_TEST_SET", "/s")
    cfg = load_config(str(path))
    assert cfg.data.root == "/d/x" and cfg.get_path("data.other") == "/s/y"
