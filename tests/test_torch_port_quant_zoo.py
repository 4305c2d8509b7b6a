"""The port's int8 eval path of RepVGG, RegNetX/Y and ShuffleNetV2 against
the JAX package's, on the CPU at tiny sizes, and ``ops/quant.py``'s
grouped-convolution routes and padded products
(``test_torch_port_quant_mobile.py`` does MobileNetV2/V3 and EfficientNet).

Each family's small member (``test_torch_port_cnn_zoo.py``'s RepVGG and
RegNetX/Y, the two one class; ShuffleNetV2 at 20 channels in every stage,
so that its 10-channel 1×1s pad N and the stages repeat one another's
weight shapes, which the JAX quantizer's eager arithmetic compiles once)
takes the JAX model's variables, drawn from numpy on ``jax.eval_shape``'s
shapes (``test_torch_port_resnet.py::numpy_variables``), through
``models/convert.py``. The JAX quantizer and the port's run on the
same float weights and the same uint8 calibration images (16 of 32²,
batches of 8), once a family for the module
(``tests/quant_port_helpers.py::quantize_both``); then two checks:

- the quantizers: the same requantize sites, scales within rel 1e-5, the
  same ``stem_pad_vals``, every float parameter within rel 1e-5 of its
  tensor's max, int8 weights equal but at rounding ties, at most 0.1% of
  them and one level each (measured: none);
- the int8 forwards on the JAX ``qparams`` carried across by
  ``quantized_from_flax``, on the same int8 input: every requantized
  activation, recorded in call order by patching the modules'
  ``requantize``, bitwise equal (measured: all), logits within rel 1e-5
  of max|logit| (measured ≤ 4e-7), the same argmax; the port's own
  parameters' logits within rel 1e-4 (measured ≤ 1.3e-6).

Every JAX forward is one jit (the quantizers jit their calibration). The
grouped convolutions take ``ops/quant.py``'s grouped route; its int32
accumulators and the block-diagonal product's are held bitwise to
``lax.conv_general_dilated`` at grouped shapes of the tiny models.
"""

import tests.torch_port_threads  # noqa: F401  (before any torch work)
import functools

import numpy as np
import pytest
import torch

from robustart_torch.models import quantize_regnet as pq_reg
from robustart_torch.models import quantize_repvgg as pq_rep
from robustart_torch.models import quantize_shufflenet as pq_shf
from robustart_torch.models import shufflenet as port_shufflenet
from robustart_torch.ops import quant as pops
from robustart_tpu.models import quantize_regnet as jq_reg
from robustart_tpu.models import quantize_repvgg as jq_rep
from robustart_tpu.models import quantize_shufflenet as jq_shf
from robustart_tpu.models import shufflenet as jax_shufflenet
from robustart_tpu.ops import quant as jops
from tests.quant_port_helpers import as_torch, check_cnn_int8_forward, compare_params, quantize_both
from tests.test_torch_port_cnn_zoo import FAMILIES

SHUFFLE = dict(stage_channels=(20, 20, 20, 40), stage_repeats=(2, 1, 1), num_classes=10)

# family: (its tiny JAX and port models and input size, the JAX and the
# port's quantizer)
ZOO = {
    "repvgg": (FAMILIES["repvgg"], jq_rep.quantize_repvgg, pq_rep.quantize_repvgg, jq_rep),
    "regnetx": (FAMILIES["regnetx"], jq_reg.quantize_regnet, pq_reg.quantize_regnet, jq_reg),
    "regnety": (FAMILIES["regnety"], jq_reg.quantize_regnet, pq_reg.quantize_regnet, jq_reg),
    "shufflenet": (lambda: (jax_shufflenet.ShuffleNetV2(**SHUFFLE),
                            port_shufflenet.ShuffleNetV2(**SHUFFLE), 32),
                   jq_shf.quantize_shufflenet, pq_shf.quantize_shufflenet, jq_shf),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _quantized(family):
    models, jax_quantize, port_quantize, _ = ZOO[family]
    return quantize_both(family, *models(), jax_quantize, port_quantize)


@pytest.mark.parametrize("family", list(ZOO))
def test_quantizer_matches_jax(family):
    jax_q, port_q, bridged = _quantized(family)
    differ, total = compare_params(port_q, bridged)
    assert differ <= 1e-3 * total, (differ, total)


@pytest.mark.parametrize("family", list(ZOO))
def test_int8_forward_matches_jax(family, monkeypatch):
    check_cnn_int8_forward(ZOO[family][3], *_quantized(family), monkeypatch)


def test_regnet_routes_agree():
    """RegNetY's grouped 3×3s (group width 8) on the block-diagonal product
    give the grouped route's logits bitwise."""
    _, _, bridged = _quantized("regnety")
    grouped = {k for k, p in bridged.packed.items() if p.route == "grouped"}
    assert grouped and all(k.endswith("/conv2") for k in grouped)
    x = as_torch(np.random.default_rng(6).integers(-128, 128, (2, 32, 32, 3), np.int8))
    want = bridged(x)
    product = {k: pops.pack_conv(bridged.qparams[k]["w"], p.groups, "product")
               for k, p in bridged.packed.items()}
    bridged.packed, packed = product, bridged.packed
    try:
        assert torch.equal(bridged(x), want)
    finally:
        bridged.packed = packed


# grouped shapes of the tiny models (H, C, k, stride, groups, Cout):
# RegNetY's group width 8, the depthwise 3×3s (strided too) and
# EfficientNet's and MobileNetV3's 5×5s
GROUPED = [(16, 24, 3, 2, 3, 24), (8, 16, 3, 1, 16, 16), (9, 20, 3, 2, 20, 20),
           (5, 40, 5, 1, 40, 40), (7, 24, 5, 2, 24, 24)]


@pytest.mark.parametrize("shape", GROUPED)
def test_grouped_routes_match_jax_bitwise(shape):
    """Both routes' int32 accumulators equal the JAX ``conv_i8``'s, with
    inputs at ±127 and −128 (the extremes of the exactness bound)."""
    h, c, k, stride, groups, cout = shape
    rng = np.random.default_rng(h * c + k)
    x = rng.integers(-128, 128, (2, h, h + 1, c), np.int8)
    x[0, 0, :, :] = 127
    w = rng.integers(-127, 128, (k, k, c // groups, cout), np.int8)
    w[..., 0] = -127
    ref = np.asarray(jops.conv_i8(x, w, stride, k // 2, groups))
    for route in ("grouped", "product"):
        got = pops.conv_i8(as_torch(x), as_torch(w), stride, k // 2, groups, route)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), ref, err_msg=route)
    assert pops.pack_conv(as_torch(w), groups).route == "grouped"


def test_grouped_route_bound_and_padded_products(monkeypatch):
    """The grouped route is taken only where float32 is exact (and refused
    past it), and ``int_mm`` pads N and K to multiples of 8 (the Mixer's
    196-token products and ShuffleNetV2 x2.0's 122 and 244 channels), and
    computes a shape cuBLASLt refuses (here: every N not a multiple of 32,
    as the H100's refuses N = 72 at K = 32) with N padded to 32s."""
    real = torch._int_mm

    def refusing(a, b):
        if b.shape[1] % 32:
            raise RuntimeError("CUDA error: CUBLAS_STATUS_NOT_SUPPORTED when calling "
                               "cublasLtMatmul")
        return real(a, b)

    monkeypatch.setattr(torch, "_int_mm", refusing)
    assert pops.grouped_exact(3, 48) and pops.grouped_exact(3, 72)
    assert not pops.grouped_exact(3, 128) and not pops.grouped_exact(7, 24)
    w = torch.zeros((3, 3, 128, 256), dtype=torch.int8)
    assert pops.pack_conv(w, 2).route == "product"
    with pytest.raises(ValueError, match="not exact"):
        pops.pack_conv(w, 2, "grouped")
    rng = np.random.default_rng(7)
    for m, k, n in ((5, 384, 196), (9, 196, 384), (6, 116, 122), (7, 244, 244), (4, 32, 72)):
        a = rng.integers(-127, 128, (m, k), np.int8)
        b = rng.integers(-127, 128, (n, k), np.int8)
        got = pops.int_mm(as_torch(a), as_torch(b))
        assert got.shape == (m, n) and got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), a.astype(np.int64) @ b.T.astype(np.int64))
