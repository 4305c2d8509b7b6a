"""The port's int8 eval path of MobileNetV2, MobileNetV3 and EfficientNet
against the JAX package's, on the CPU at tiny sizes, checked as
``test_torch_port_quant_zoo.py`` checks RepVGG, RegNetY and ShuffleNetV2:
the quantizers (scales within rel 1e-5, int8 weights equal but at rounding
ties, at most 0.1% of them; measured: none), then the int8 forwards on the
carried ``qparams`` (every requantized activation bitwise, logits within
rel 1e-5, the same argmax; the port's own parameters within rel 1e-4).

The tiny members: MobileNetV2 and MobileNetV3-small at scale 0.1 and
EfficientNet at width 0.1 (depth 0.3), 32²: their channel counts repeat, so
that the JAX quantizers' eager weight arithmetic (a few small XLA programs
a distinct weight shape) compiles fewer shapes. Their depthwise 3×3s and
5×5s, strided too, take ``ops/quant.py``'s grouped route; the SE gates,
hardswish and SiLU run in f32 as in the JAX forwards.
"""

import tests.torch_port_threads  # noqa: F401  (before any torch work)
import functools

import pytest
import torch

from robustart_torch.models import efficientnet as port_efficientnet
from robustart_torch.models import mobilenet as port_mobilenet
from robustart_torch.models import quantize_efficientnet as pq_eff
from robustart_torch.models import quantize_mobilenet as pq_mv2
from robustart_torch.models import quantize_mobilenet_v3 as pq_mv3
from robustart_tpu.models import efficientnet as jax_efficientnet
from robustart_tpu.models import mobilenet as jax_mobilenet
from robustart_tpu.models import quantize_efficientnet as jq_eff
from robustart_tpu.models import quantize_mobilenet as jq_mv2
from robustart_tpu.models import quantize_mobilenet_v3 as jq_mv3
from tests.quant_port_helpers import check_cnn_int8_forward, compare_params, quantize_both

# family: (its tiny JAX and port models and input size, the JAX and the
# port's quantizer, the JAX quantizer's module)
ZOO = {
    "mobilenet_v2": (lambda: (jax_mobilenet.MobileNetV2(scale=0.1, num_classes=10),
                              port_mobilenet.MobileNetV2(scale=0.1, num_classes=10), 32),
                     jq_mv2.quantize_mobilenet_v2, pq_mv2.quantize_mobilenet_v2, jq_mv2),
    "mobilenet_v3_small": (lambda: (jax_mobilenet.MobileNetV3(scale=0.1, mode="small",
                                                              num_classes=10),
                                    port_mobilenet.MobileNetV3(0.1, "small", num_classes=10), 32),
                           jq_mv3.quantize_mobilenet_v3, pq_mv3.quantize_mobilenet_v3, jq_mv3),
    "efficientnet": (lambda: (jax_efficientnet.EfficientNet(width_mult=0.1, depth_mult=0.3,
                                                            num_classes=10),
                              port_efficientnet.EfficientNet(0.1, 0.3, num_classes=10), 32),
                     jq_eff.quantize_efficientnet, pq_eff.quantize_efficientnet, jq_eff),
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
