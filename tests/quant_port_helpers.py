"""Shared pieces of the int8 parity tests of the CNN zoo, ConvNeXt, the
MLP-Mixer and DenseNet (``test_torch_port_quant_{zoo,mobile,blocks}.py``):
one tiny model quantized by both packages on the same float weights and
uint8 calibration images, the comparison of their parameters, and the two
int8 forwards with every requantized activation recorded."""

import jax
import numpy as np
import torch

from robustart_torch.models import convert
from robustart_torch.models import quantize_net
from robustart_torch.models.classifier import Classifier as PortClassifier
from robustart_tpu.models.classifier import Classifier as JaxClassifier
from robustart_tpu.models.torch_convert import unflatten
from tests.test_torch_port_resnet import numpy_variables

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def as_torch(a):
    return torch.from_numpy(np.array(a))


def quantize_both(name, jm, pm, size, jax_quantize, port_quantize, redraw=None):
    """(JAX int8 classifier, the port's own, the port's on the JAX
    ``qparams``) of the tiny JAX module ``jm`` and its port ``pm``: the
    JAX variables drawn from numpy (``redraw(flat)`` may replace some),
    both quantized on the same 16 uint8 images of ``size``², batches of 8."""
    flat = numpy_variables(jm, size, 3)
    if redraw is not None:
        redraw(flat)
    pm.load_state_dict(convert.state_dict_from_flax(flat))
    jclf = JaxClassifier(name=name, module=jm, variables=unflatten(flat), mean=MEAN, std=STD,
                         input_size=size, num_classes=10)
    pclf = PortClassifier(name, pm.eval(), MEAN, STD, input_size=size, num_classes=10)
    calib = np.random.default_rng(4).integers(0, 256, (16, size, size, 3), np.uint8)
    jax_q = jax_quantize(jclf, calib, calib_batch_size=8)
    port_q = port_quantize(pclf, calib, calib_batch_size=8)
    bridged = convert.quantized_from_flax(pclf, jax.tree.map(np.asarray, jax_q.qparams),
                                          stem_pad_vals=getattr(jax_q, "stem_pad_vals", None))
    return jax_q, port_q, bridged


def compare_params(port_q, bridged, rel: float = 1e-5):
    """The port's own int8 parameters against JAX's carried across: the
    same sites and scales within ``rel``, the same ``stem_pad_vals``,
    floats within ``rel`` of their tensor's max, int8 weights within one
    level. Returns (int8 weights that differ, int8 weights)."""
    for table in ("scale", "inv_scale"):
        assert set(port_q.qparams[table]) == set(bridged.qparams[table])
        for site, v in bridged.qparams[table].items():
            assert abs(port_q.qparams[table][site] - v) <= rel * abs(v), (table, site)
    assert set(port_q.qparams) == set(bridged.qparams)
    differ = total = 0
    for key, e in bridged.qparams.items():
        if key in ("scale", "inv_scale"):
            continue
        mine = port_q.qparams[key]
        if isinstance(e, tuple):
            assert mine == e, key
            continue
        assert set(mine) == set(e), key
        for f, b in e.items():
            a = mine[f]
            assert a.shape == b.shape and a.dtype == b.dtype, (key, f)
            if b.dtype == torch.int8:
                d = (a.int() - b.int()).abs()
                assert int(d.max()) <= 1, (key, f)
                differ += int((d > 0).sum())
                total += b.numel()
            else:
                assert float((a - b).abs().max()) <= rel * float(b.abs().max()) + 1e-12, (key, f)
    return differ, total


def recorded(monkeypatch, module):
    """Record every output of ``module.requantize``, in call order."""
    seen = []
    inner = module.requantize

    def requantize(*args):
        seen.append(inner(*args))
        return seen[-1]

    monkeypatch.setattr(module, "requantize", requantize)
    return seen


def int8_forwards(monkeypatch, jax_module, jax_q, bridged, x):
    """The JAX int8 forward (one jit) and the port's on the carried
    parameters, on int8 ``x``: (logits, requantized activations) each."""
    seen = recorded(monkeypatch, jax_module)

    def fwd(qp, xx):
        seen.clear()
        return jax_q.apply_fn(qp, xx), list(seen)

    ref, seen_jax = jax.jit(fwd)(jax_q.qparams, x)
    seen_port = recorded(monkeypatch, quantize_net)
    got = bridged(as_torch(x)).numpy()
    monkeypatch.undo()
    return (got, [a.numpy() for a in seen_port]), (np.asarray(ref),
                                                   [np.asarray(a) for a in seen_jax])


def site_flips(port_acts, jax_acts):
    """(values that differ, values, largest difference in levels) over every
    requantized activation of the two forwards."""
    assert len(port_acts) == len(jax_acts) > 0
    flips = total = most = 0
    for a, b in zip(port_acts, jax_acts):
        assert a.shape == b.shape
        d = np.abs(a.astype(np.int32) - b.astype(np.int32))
        flips, total, most = flips + int((d > 0).sum()), total + d.size, max(most, int(d.max()))
    return flips, total, most


def check_cnn_int8_forward(jax_module, jax_q, port_q, bridged, monkeypatch):
    """The CNN families' int8 forward check: on the same int8 input, every
    requantized activation of the port's forward on the carried
    parameters equal to the JAX forward's, the logits within rel 1e-5 of
    max|logit| and the same argmax; the port's own parameters' logits
    within rel 1e-4; and a uint8 image the centered grid's."""
    size = bridged.input_size
    x = np.random.default_rng(5).integers(-128, 128, (2, size, size, 3), np.int8)
    (got, acts), (ref, ref_acts) = int8_forwards(monkeypatch, jax_module, jax_q, bridged, x)
    assert site_flips(acts, ref_acts)[0] == 0
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))
    own = port_q(as_torch(x)).numpy()
    assert np.abs(own - ref).max() <= 1e-4 * np.abs(ref).max()
    u8 = (x.astype(np.int16) + 128).astype(np.uint8)
    np.testing.assert_array_equal(port_q(as_torch(u8)).numpy(), own)
