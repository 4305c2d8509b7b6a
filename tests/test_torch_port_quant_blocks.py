"""The port's int8 eval path of ConvNeXt (V1 and V2), the MLP-Mixer and
DenseNet against the JAX package's, on the CPU at tiny sizes, and
``model.quantize: int8`` in the solver for all nine families that
``models/quantize_net.py`` serves.

The tiny models: ConvNeXt at depths (1, 1), dims (32, 64), 32² (LayerScale
γ from U(0.5, 1.5), GRN's γ and β from N(0, 0.5²): at their inits the
blocks are all but the identity); the Mixer at patch 8, width 32, two
blocks, 40² (25 tokens: its token MLP's fc1 has K = 25 and fc2 N = 25,
which ``int_mm`` pads to 32); DenseNet at blocks (2, 2), growth 8. Their
variables are drawn from numpy on ``jax.eval_shape``'s shapes
(``test_torch_port_resnet.py::numpy_variables``), quantized once a model
for the module by both packages on the same 16 uint8 calibration images,
and checked as ``test_torch_port_quant_zoo.py`` checks the CNN zoo: the
quantizers (scales within rel 1e-5, int8 weights equal but at ties, none
measured), then the int8 forwards on the carried ``qparams`` with every
requantized activation recorded.

DenseNet's int8 forward is bitwise at every site. ConvNeXt's and the
Mixer's part, as the ViT's do (``test_torch_port_quant.py``): every bf16
step rounds where the JAX program writes it, where XLA keeps a fused bf16
chain in f32; ConvNeXt's depthwise 7×7 + LN is K11's function (its plain
version here), which does not round the convolution to bf16 before the LN
as the JAX forward's XLA reference does, so its first requantized site
already differs at 4% of values (measured 4.2% V1, 3.6% V2), by one level.
Each flipped level carries through the per-tensor scales. Bounds at each
test, with the measured values.
"""

import tests.torch_port_threads  # noqa: F401  (before any torch work)
import functools
import types

import numpy as np
import pytest
import torch

from robustart_torch.models import convnext, densenet, efficientnet, mlp_mixer
from robustart_torch.models import mobilenet, regnet, repvgg, shufflenet
from robustart_torch.models import quantize_convnext as pq_cnx
from robustart_torch.models import quantize_densenet as pq_dn
from robustart_torch.models import quantize_mixer as pq_mix
from robustart_torch.models.classifier import Classifier as PortClassifier
from robustart_torch.models.quantize import Int8Model
from robustart_torch.ops import convnext as port_convnext_ops
from robustart_torch.solvers import MultiEvalSolver as PortSolver
from robustart_tpu.models import convnext as jax_convnext
from robustart_tpu.models import densenet as jax_densenet
from robustart_tpu.models import mlp_mixer as jax_mixer
from robustart_tpu.models import quantize_convnext as jq_cnx
from robustart_tpu.models import quantize_densenet as jq_dn
from robustart_tpu.models import quantize_mixer as jq_mix
from tests.test_torch_port_cnn_zoo import REGNET_TINY
from tests.test_torch_port_quant import _int8_cfg, _tiny
from tests.quant_port_helpers import (MEAN, STD, as_torch, compare_params, int8_forwards,
                                      quantize_both, site_flips)

CONVNEXT = dict(depths=(1, 1), dims=(32, 64), num_classes=10)
MIXER = dict(patch_size=8, embed_dim=32, depth=2, tokens_mlp_dim=16, channels_mlp_dim=64,
             num_classes=10)
DENSENET = dict(block_config=(2, 2), growth_rate=8, num_init_features=16, num_classes=10)

# model: (its tiny JAX and port models and input size, the JAX and the
# port's quantizer modules, the quantizer's name)
MODELS = {
    "convnext_v1": (lambda: (jax_convnext.ConvNeXt(**CONVNEXT, block_impl="xla", mlp_impl="xla"),
                             convnext.ConvNeXt(**CONVNEXT), 32), jq_cnx, pq_cnx,
                    "quantize_convnext"),
    "convnext_v2": (lambda: (jax_convnext.ConvNeXt(**CONVNEXT, use_grn=True, block_impl="xla",
                                                   mlp_impl="xla"),
                             convnext.ConvNeXt(**CONVNEXT, use_grn=True), 32), jq_cnx, pq_cnx,
                    "quantize_convnext"),
    "mixer": (lambda: (jax_mixer.MlpMixer(**MIXER, mlp_impl="xla"),
                       mlp_mixer.MlpMixer(**MIXER, img_size=40), 40), jq_mix, pq_mix,
              "quantize_mixer"),
    "densenet": (lambda: (jax_densenet.DenseNet(**DENSENET, concat_impl="concat"),
                          densenet.DenseNet(**DENSENET), 32), jq_dn, pq_dn, "quantize_densenet"),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _redraw(flat):
    """LayerScale γ from U(0.5, 1.5), GRN's γ and β from N(0, 0.5²)."""
    rng = np.random.default_rng(11)
    for key, v in flat.items():
        if key.endswith("grn/gamma") or key.endswith("grn/beta"):
            flat[key] = rng.normal(0.0, 0.5, v.shape).astype(np.float32)
        elif key.endswith("/gamma"):
            flat[key] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _quantized(model):
    models, jq, pq, name = MODELS[model]
    return quantize_both(model, *models(), getattr(jq, name), getattr(pq, name), _redraw)


@pytest.mark.parametrize("model", list(MODELS))
def test_quantizer_matches_jax(model):
    """Scales and float parameters within rel 1e-5, int8 weights equal but
    at rounding ties, at most 0.1% of them (measured: none)."""
    differ, total = compare_params(*_quantized(model)[1:])
    assert differ <= 1e-3 * total, (differ, total)


# model: (the first site's share of flipped values, the share of equal
# values over all sites, the most levels a value moves, rel max|Δlogit|,
# the least cosine per image); measured: ConvNeXt V1 4.2%, 83%, 3, 2.1e-2,
# 0.99987; V2 3.6%, 89%, 3, 1.5e-2, 0.99990; Mixer 0, 85%, 3, 7.4e-3,
# 0.99996; DenseNet bitwise, logits 2.2e-7
BOUNDS = {"convnext_v1": (0.1, 0.7, 6, 5e-2, 0.999), "convnext_v2": (0.1, 0.7, 6, 5e-2, 0.999),
          "mixer": (0.0, 0.7, 6, 3e-2, 0.999), "densenet": (0.0, 1.0, 0, 1e-5, 0.999999)}


@pytest.mark.parametrize("model", list(MODELS))
def test_int8_forward_matches_jax(model, monkeypatch):
    jax_q, port_q, bridged = _quantized(model)
    first, equal, levels, rel, cos_min = BOUNDS[model]
    size = bridged.input_size
    x = np.random.default_rng(5).integers(-128, 128, (2, size, size, 3), np.int8)
    (got, acts), (ref, ref_acts) = int8_forwards(monkeypatch, MODELS[model][1], jax_q, bridged,
                                                 x)
    f0, n0, most0 = site_flips(acts[:1], ref_acts[:1])
    assert f0 <= first * n0 and most0 <= 1, (f0, n0, most0)
    flips, total, most = site_flips(acts, ref_acts)
    assert flips <= (1 - equal) * total and most <= levels, (flips, total, most)
    for logits in (got, port_q(as_torch(x)).numpy()):
        assert np.abs(logits - ref).max() <= rel * np.abs(ref).max()
        cos = (logits * ref).sum(-1) / (np.linalg.norm(logits, axis=-1)
                                        * np.linalg.norm(ref, axis=-1))
        assert cos.min() >= cos_min, cos


def test_convnext_int8_runs_k11_once_a_block(monkeypatch):
    """The int8 forward takes each block's depthwise 7×7 + LN through K11's
    wrapper (its plain version on CPU tensors) on the bf16 activation;
    calibration takes the plain version in float32."""
    calls = []
    wrapper = port_convnext_ops.dwconv_ln

    def counted(x, *args):
        calls.append(x.dtype)
        return wrapper(x, *args)

    monkeypatch.setattr(pq_cnx, "dwconv_ln", counted)
    _, port_q, _ = _quantized("convnext_v1")
    port_q(as_torch(np.zeros((1, 32, 32, 3), np.int8)))
    assert calls == [torch.bfloat16] * sum(CONVNEXT["depths"])
    calls.clear()
    pq_cnx.quantize_convnext(_port_classifier("convnext_v1"), np.zeros((2, 32, 32, 3), np.uint8),
                             calib_batch_size=2)
    assert calls == []


def _port_classifier(model):
    _, pm, size = MODELS[model][0]()
    return PortClassifier(model, pm.eval(), MEAN, STD, input_size=size, num_classes=10)


# the nine families, each a tiny model under a test name in the port's registry
FAMILIES = {
    "convnext": (lambda **kw: convnext.ConvNeXt(**CONVNEXT), pq_cnx.QuantizedConvNeXt),
    "mixer": (lambda **kw: mlp_mixer.MlpMixer(**MIXER, img_size=32), pq_mix.QuantizedMixer),
    "densenet": (lambda **kw: densenet.DenseNet(**DENSENET), pq_dn.QuantizedDenseNet),
    "mobilenet_v2": (lambda **kw: mobilenet.MobileNetV2(scale=0.35, num_classes=10), None),
    "mobilenet_v3": (lambda **kw: mobilenet.MobileNetV3(0.35, "small", num_classes=10), None),
    "efficientnet": (lambda **kw: efficientnet.EfficientNet(0.25, 0.3, num_classes=10), None),
    "regnet": (lambda **kw: regnet.RegNetX(**REGNET_TINY, se_ratio=0.25), None),
    "repvgg": (lambda **kw: repvgg.RepVGG((1, 2, 1, 1), 0.25, 0.25, num_classes=10), None),
    "shufflenet": (lambda **kw: shufflenet.ShuffleNetV2((16, 32, 64, 128), (2, 2, 2),
                                                        num_classes=10), None),
}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_solver_int8_builds_every_family(family, tmp_path, monkeypatch):
    """``model.quantize: int8`` (the Mixer under ``quantize_force``) builds
    the family's int8 classifier from the first batch and the solver's
    eval forward answers with it; a RepVGG is quantized on its deploy
    form."""
    factory, cls = FAMILIES[family]
    _tiny(monkeypatch, f"{family}_tiny_test", factory)
    force = {"quantize_force": True} if family == "mixer" else {}
    solver = PortSolver(_int8_cfg(tmp_path, {}, {"type": f"{family}_tiny_test"}, **force),
                        device="cpu")
    solver.build_model()
    images = np.random.default_rng(2).integers(0, 256, (4, 32, 32, 3), np.uint8)
    batch = types.SimpleNamespace(image=images, mask=np.ones(4, bool))
    assert solver.maybe_quantize([batch])
    q = solver.quantized
    assert isinstance(q, Int8Model) and q.name == f"{solver.classifier.name}@int8"
    assert cls is None or isinstance(q, cls)
    if family == "repvgg":
        assert solver.classifier.model.deploy
    with torch.inference_mode():
        logits = solver.eval_fn(images[:2])
    assert logits.shape == (2, 10) and torch.isfinite(logits).all()


def test_solver_refuses_mixer_int8_without_force(tmp_path, monkeypatch):
    _tiny(monkeypatch, "mixer_tiny_test", FAMILIES["mixer"][0])
    with pytest.raises(ValueError, match="quantize_force"):
        PortSolver(_int8_cfg(tmp_path, {}, {"type": "mixer_tiny_test"}),
                   device="cpu").build_model()
