"""The port's float CNN zoo (MobileNetV2/V3, EfficientNet, RegNetX/Y, RepVGG,
ShuffleNetV2, GoogLeNet, the NAS stand-ins) against the JAX package.

Each family's small member takes the JAX model's variables (every one drawn
from numpy on the shapes of its init, ``test_torch_port_resnet.numpy_variables``)
through ``robustart_torch.models.convert``; both forwards then take the same
normalized NHWC batch in float32. Tolerance: max|Δlogit| ≤ 1e-5·max|logit|
(the frameworks sum convolutions in different orders) and equal argmax.

Also: the bridge is the inverse of the JAX package's torch → Flax converter
where it has rules; ShuffleNet's channel order on distinct per-channel
values; GoogLeNet's pools at odd sizes; RepVGG's deploy form against JAX's
``deploy_classifier`` (fused weights bitwise, logits 1e-5) and the solver's
deploy default; ``model.quantize: int8`` taken by each family's int8
quantizer (``models/quantize_<family>.py``), and the float path kept,
with a warning, on GoogLeNet and the NAS stand-ins, which neither package
quantizes.
"""

import tests.torch_port_threads  # noqa: F401  (before any torch work)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustart_torch.core.config import Config as PortConfig
from robustart_torch.models import convert, create_classifier
from robustart_torch.models import efficientnet as pe
from robustart_torch.models import googlenet as pg
from robustart_torch.models import mobilenet as pm
from robustart_torch.models import nas_zoo as pn
from robustart_torch.models import regnet as pr
from robustart_torch.models import repvgg as prv
from robustart_torch.models import shufflenet as ps
from robustart_torch.models.layers import MaxPool2d
from robustart_torch.solvers import Solver as PortSolver
from robustart_torch.solvers import base as solver_base
from robustart_tpu.models import efficientnet as je
from robustart_tpu.models import googlenet as jg
from robustart_tpu.models import mobilenet as jm
from robustart_tpu.models import nas_zoo as jn
from robustart_tpu.models import regnet as jr
from robustart_tpu.models import repvgg as jrv
from robustart_tpu.models import shufflenet as js
from robustart_tpu.models.classifier import Classifier as JaxClassifier
from robustart_tpu.models.layers import MaxPool2d as JaxMaxPool2d
from robustart_tpu.models.torch_convert import (convert_state_dict, flatten, resolve_rule,
                                                unflatten)
from tests.test_torch_port_resnet import numpy_variables

REGNET_TINY = dict(w0=24, wa=24.48, wm=2.54, depth=5, group_width=8, num_classes=10)

# family → (JAX module, port module, input size)
FAMILIES = {
    "mobilenet_v2": lambda: (jm.MobileNetV2(scale=0.35, num_classes=10),
                             pm.MobileNetV2(scale=0.35, num_classes=10), 32),
    "mobilenet_v3_large": lambda: (jm.MobileNetV3(scale=0.35, mode="large", num_classes=10),
                                   pm.MobileNetV3(scale=0.35, mode="large", num_classes=10), 32),
    "mobilenet_v3_small": lambda: (jm.MobileNetV3(scale=0.35, mode="small", num_classes=10),
                                   pm.MobileNetV3(scale=0.35, mode="small", num_classes=10), 32),
    "efficientnet": lambda: (je.EfficientNet(width_mult=0.25, depth_mult=0.3, num_classes=10),
                             pe.EfficientNet(width_mult=0.25, depth_mult=0.3, num_classes=10), 32),
    "regnetx": lambda: (jr.RegNetX(**REGNET_TINY), pr.RegNetX(**REGNET_TINY), 32),
    "regnety": lambda: (jr.RegNetX(**REGNET_TINY, se_ratio=0.25),
                        pr.RegNetX(**REGNET_TINY, se_ratio=0.25), 32),
    "repvgg": lambda: (jrv.RepVGG(num_blocks=(1, 2, 1, 1), width_a=0.25, width_b=0.25,
                                  num_classes=10),
                       prv.RepVGG((1, 2, 1, 1), 0.25, 0.25, num_classes=10), 32),
    "shufflenet": lambda: (js.ShuffleNetV2(stage_channels=(16, 32, 64, 128),
                                           stage_repeats=(2, 2, 2), num_classes=10),
                           ps.ShuffleNetV2((16, 32, 64, 128), (2, 2, 2), num_classes=10), 32),
    "googlenet": lambda: (jg.GoogLeNet(num_classes=10), pg.GoogLeNet(num_classes=10), 35),
    "nas_budget": lambda: (jn.NAS_FACTORIES["bignas_resnet18_107M"](num_classes=10),
                           pn.NAS_FACTORIES["bignas_resnet18_107M"](num_classes=10), 33),
    "nas_deep_stem": lambda: (jn.NAS_FACTORIES["resnet18c_x0_125"](num_classes=10),
                              pn.NAS_FACTORIES["resnet18c_x0_125"](num_classes=10), 33),
}


def _jax_logits(module, flat, x):
    return np.asarray(jax.jit(lambda v, xx: module.apply(v, xx, train=False))(unflatten(flat), x))


def _within(got, ref):
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))


def _loaded(family, seed=0):
    jax_module, port_model, size = FAMILIES[family]()
    flat = numpy_variables(jax_module, size, seed)
    port_model.load_state_dict(convert.state_dict_from_flax(flat))
    x = np.random.default_rng(seed + 1).normal(0, 1, (2, size, size, 3)).astype(np.float32)
    return jax_module, port_model.eval(), flat, x


@pytest.mark.parametrize("family", list(FAMILIES))
def test_family_matches_jax(family):
    jax_module, port_model, flat, x = _loaded(family)
    with torch.no_grad():
        got = port_model(torch.from_numpy(x)).numpy()
    _within(got, _jax_logits(jax_module, flat, x))


@pytest.mark.parametrize("family", ["mobilenet_v2", "efficientnet", "regnety", "repvgg",
                                    "shufflenet"])
def test_bridge_is_inverse_of_jax_converter(family):
    """Flax → port state dict → the JAX package's torch → Flax converter
    gives back every tensor unchanged, for the families it has rules for."""
    jax_module, _, size = FAMILIES[family]()
    flat = numpy_variables(jax_module, size, 2)
    sd = {k: v.numpy() for k, v in convert.state_dict_from_flax(flat).items()}
    variables = unflatten({k: np.zeros_like(v) for k, v in flat.items()})
    back, missing = convert_state_dict(sd, variables, resolve_rule(jax_module))
    assert missing == []
    for name, value in flatten(back).items():
        np.testing.assert_array_equal(np.asarray(value), flat[name])


def test_shufflenet_channel_order():
    """Channel c of the input holds the value c: the port's NCHW shuffle
    gives the JAX package's NHWC order."""
    c = 12
    x = np.broadcast_to(np.arange(c, dtype=np.float32), (1, 3, 2, c))
    ref = np.asarray(js.channel_shuffle(jnp.asarray(x), 2))[0, 0, 0]
    got = ps.channel_shuffle(torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2), 2)
    np.testing.assert_array_equal(got[0, :, 0, 0].numpy(), ref)
    np.testing.assert_array_equal(ref, np.arange(c).reshape(2, 6).T.reshape(-1))


@pytest.mark.parametrize("size", [13, 14, 15])
def test_googlenet_pools_at_odd_sizes(size):
    """The three pools GoogLeNet takes (3×3/2 pad 1, 3×3/1 pad 1, 2×2/2) give
    the JAX package's ``MaxPool2d`` sizes and values, negative inputs too."""
    x = np.random.default_rng(size).normal(0, 1, (1, size, size + 2, 4)).astype(np.float32) - 2
    for window, stride, pad in ((3, 2, 1), (3, 1, 1), (2, 2, 0)):
        ref = np.asarray(JaxMaxPool2d(window, stride, pad).apply({}, jnp.asarray(x)))
        got = MaxPool2d(window, stride, pad)(torch.from_numpy(x).permute(0, 3, 1, 2))
        np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), ref)


def test_repvgg_deploy_matches_jax_deploy_classifier():
    jax_module, port_model, flat, x = _loaded("repvgg", seed=3)
    clf = JaxClassifier(name="repvgg", module=jax_module, variables=unflatten(flat),
                        input_size=32, num_classes=10)
    jax_deploy = jrv.deploy_classifier(clf)
    port_deploy = prv.reparameterize(port_model)
    assert port_deploy.deploy and not port_model.deploy
    sd = port_deploy.state_dict()
    for name, value in flatten(jax_deploy.variables["params"]).items():
        base, leaf = name.rsplit("/", 1)
        if not base.endswith("fused"):
            continue
        key = f"{convert.repvgg_torch_base(base)}.{'weight' if leaf == 'kernel' else 'bias'}"
        v = np.asarray(value)
        np.testing.assert_array_equal(sd[key].numpy(), v.transpose(3, 2, 0, 1) if v.ndim == 4 else v)
    with torch.no_grad():
        got = port_deploy(torch.from_numpy(x)).numpy()
        train = port_model(torch.from_numpy(x)).numpy()
    ref = np.asarray(jax.jit(lambda v, xx: jax_deploy.module.apply(v, xx, train=False))(
        jax_deploy.variables, x))
    _within(got, ref)
    _within(got, train)


def _solver(tmp_path, model_type, **model):
    return PortSolver(PortConfig({
        "model": {"type": model_type, "kwargs": {"num_classes": 10}, **model},
        "data": {"batch_size": 2, "num_workers": 1, "input_size": 32, "read_from": "fake",
                 "fake_size": 4, "fake_num_classes": 10, "test": {}},
        "saver": {"results_dir": str(tmp_path)},
    }), device="cpu")


@pytest.mark.parametrize("deploy", [None, False])
def test_solver_evaluates_repvgg_deploy_form_by_default(tmp_path, deploy):
    solver = _solver(tmp_path, "repvgg_A0", **({} if deploy is None else {"deploy": deploy}))
    solver.build_model(seed=0)
    train = solver.classifier.model
    images = np.random.default_rng(0).integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
    with torch.no_grad():
        ref = train(torch.from_numpy(images).float().div(255.0).sub(
            torch.tensor(solver.classifier.mean)).div(torch.tensor(solver.classifier.std)))
        got = solver.eval_fn(images)
    assert solver.classifier.model.deploy is (deploy is None)
    assert torch.allclose(got, ref, rtol=0, atol=1e-4 * float(ref.abs().max()))


@pytest.mark.parametrize("name, quantizer", [
    ("mobilenet_v2", "quantize_mobilenet_v2"), ("mobilenet_v3_large_x1_0", "quantize_mobilenet_v3"),
    ("efficientnet_b0", "quantize_efficientnet"), ("regnetx_400m", "quantize_regnet"),
    ("repvgg_A0", "quantize_repvgg"), ("shufflenet_v2_x0_5", "quantize_shufflenet")])
def test_int8_taken_by_the_family_quantizer(tmp_path, name, quantizer, monkeypatch):
    """Each registry family takes its own int8 quantizer; the families the
    JAX package warns about are named in a warning that quotes no figure."""
    warnings = []
    monkeypatch.setattr(solver_base.logger, "warning", lambda msg, *a: warnings.append(msg % a))
    solver = _solver(tmp_path, name, quantize="int8")
    solver.build_model(seed=0)
    assert solver._quantizer.__name__ == quantizer
    family = type(solver.classifier.model).__name__
    assert bool(warnings) == (family in solver_base.Solver._INT8_WARNED)
    for w in warnings:
        rest = w.replace(family, "").replace("int8", "").replace("bf16", "")
        assert family in w and "PERF.md" in w and not any(ch.isdigit() for ch in rest), w


@pytest.mark.parametrize("name", ["googlenet", "bignas_resnet18_107M"])
def test_int8_keeps_float_on_families_neither_package_quantizes(tmp_path, name, monkeypatch):
    warnings = []
    monkeypatch.setattr(solver_base.logger, "warning", lambda msg, *a: warnings.append(msg % a))
    solver = _solver(tmp_path, name, quantize="int8")
    solver.build_model(seed=0)
    assert solver._quantizer is None
    assert any("keeping float eval" in w for w in warnings)


@pytest.mark.parametrize("name", ["mobilenet_v3_small_x0_35", "shufflenet_v2_x0_5"])
def test_bf16_body_f32_head(name):
    x = torch.rand((2, 32, 32, 3), generator=torch.Generator().manual_seed(0))
    f32 = create_classifier(name, seed=0, device="cpu", num_classes=10)
    bf16 = create_classifier(name, seed=0, device="cpu", num_classes=10, dtype=torch.bfloat16)
    for child_name, child in bf16.model.named_children():
        want = torch.float32 if child_name in bf16.model.HEAD else torch.bfloat16
        assert all(p.dtype == want for p in child.parameters()), child_name
    with torch.no_grad():
        a, b = f32(x), bf16(x)
    assert b.dtype == torch.float32 and torch.isfinite(b).all()
    assert torch.allclose(a, b, atol=0.1 * float(a.abs().max()))
