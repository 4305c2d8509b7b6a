"""The port's int8 post-training-quantization eval path against the JAX
package's, on the CPU at tiny sizes.

- ``ops/quant.py``: ``conv_i8``'s int32 accumulators bitwise against
  ``lax.conv_general_dilated(..., preferred_element_type=int32)`` (stride
  1 and 2, kernel 1, 3 and 7, groups 1 and 4, K not a multiple of 8); the
  folding, weight quantization, requantize, max-pool, dense and LN
  primitives against the JAX package's.
- ``quantize_classifier`` (a resnet18-shaped ResNet and a two-stage
  ResNeXt at 32 px), ``quantize_vit`` and ``quantize_swin`` (two blocks,
  32 px; Swin with a shifted window) on the same float weights and the
  same uint8 calibration images as the JAX quantizers, two ways: the
  port's own parameters against the JAX parameters carried across by
  ``models/convert.py::quantized_from_flax`` (the same ``stem_pad_vals``,
  scales within rel 1e-5, int8 weights equal but at rounding ties, whose
  count is stated); and the port's int8 forward on the carried parameters
  against the JAX int8 forward on the same int8 input, every requantized
  activation and the logits compared (tolerances at each test).
- The solver: ``model.quantize: int8`` on the precomputed route and both
  online routes, the fused and per-severity online runs byte-identical;
  the int8 input of the online step (K1's ``centered_u8`` for the noise
  family, else the uint8 grid − 128); the refusals of ViT without
  ``model.quantize_force`` and of the int8 families not ported yet.

The JAX variables are drawn from numpy on ``jax.eval_shape``'s shapes
(``tests/test_torch_port_resnet.py::numpy_variables``); every JAX forward
is one jit. The JAX ViT and Swin int8 forwards run their plain attention
(``pallas=False``); the port's run K8's and K9's plain versions on the
CPU. Budget: under 60 s in one process.
"""

import jax
import numpy as np
import pytest
import torch

from robustart_torch.core.config import Config as PortConfig
from robustart_torch.models import convert
from robustart_torch.models import quantize as pq
from robustart_torch.models import quantize_swin as pq_swin
from robustart_torch.models import quantize_vit as pq_vit
from robustart_torch.models import registry as port_registry
from robustart_torch.models import resnet as port_resnet
from robustart_torch.models import swin as port_swin
from robustart_torch.models import vit as port_vit
from robustart_torch.models.classifier import Classifier as PortClassifier
from robustart_torch.ops import quant as pops
from robustart_torch.solvers import MultiEvalSolver as PortSolver
from robustart_tpu.models import quantize as jq
from robustart_tpu.models import quantize_swin as jq_swin
from robustart_tpu.models import quantize_vit as jq_vit
from robustart_tpu.models import resnet as jax_resnet
from robustart_tpu.models import swin as jax_swin
from robustart_tpu.models import vit as jax_vit
from robustart_tpu.models.classifier import Classifier as JaxClassifier
from robustart_tpu.models.torch_convert import unflatten
from robustart_tpu.ops import quant as jops
from tests.test_torch_port_resnet import numpy_variables
from tests.test_torch_port_solver import _cfg, _slices

SIZE = 32
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's side: the shapes here are tiny,
    and in a parallel test run more threads only contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.array(a))


# --------------------------------------------------------------------------
# primitives
# --------------------------------------------------------------------------


@pytest.mark.parametrize("groups", [1, 4])
@pytest.mark.parametrize("k", [1, 3, 7])
@pytest.mark.parametrize("stride", [1, 2])
def test_conv_i8_matches_jax_bitwise(stride, k, groups):
    """12 input channels (K = k·k·12 is not a multiple of 8 at k = 1, 3, 7
    with groups 4), odd H and W, zero padding k // 2."""
    rng = np.random.default_rng(k * 10 + stride + groups)
    x = rng.integers(-128, 128, (2, 9, 11, 12), np.int8)
    w = rng.integers(-127, 128, (k, k, 12 // groups, 8), np.int8)
    ref = np.asarray(jax.jit(lambda a, b: jops.conv_i8(a, b, stride, k // 2, groups))(x, w))
    got = pops.conv_i8(_t(x), _t(w), stride, k // 2, groups)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


def test_quant_primitives_match_jax():
    """fold_conv_bn, quantize_weight_per_channel, requantize, maxpool_i8,
    dense_i8 (with and without bias) and ln_f32 on the same inputs: the
    int8 outputs bitwise, the float ones within 1 ulp-scale (rel 1e-6)."""
    rng = np.random.default_rng(0)
    kernel = rng.normal(0, 0.2, (3, 3, 8, 16)).astype(np.float32)
    gamma, var = (rng.uniform(0.5, 1.5, 16).astype(np.float32) for _ in range(2))
    beta, mean = (rng.normal(0, 0.1, 16).astype(np.float32) for _ in range(2))
    act = rng.normal(0, 3, (2, 7, 9, 16)).astype(np.float32)
    a_i8 = rng.integers(-127, 128, (2, 5, 24), np.int8)
    w_i8 = rng.integers(-127, 128, (24, 16), np.int8)
    sw, b = rng.uniform(1e-3, 1e-2, 16).astype(np.float32), rng.normal(0, 1, 16).astype(
        np.float32)
    ln = {"scale": rng.uniform(0.5, 1.5, 16).astype(np.float32),
          "bias": rng.normal(0, 0.1, 16).astype(np.float32)}

    def jax_all(kernel, gamma, beta, mean, var, act, a_i8, w_i8, sw, b, ln):
        fw, fb = jops.fold_conv_bn(kernel, gamma, beta, mean, var)
        wq, ws = jops.quantize_weight_per_channel(fw)
        q = jops.requantize(act, 0.37)
        return (fw, fb, wq, ws, q, jops.maxpool_i8(q),
                jops.dense_i8(a_i8, {"w": w_i8, "sw": sw, "b": b}, 0.05),
                jops.dense_i8(a_i8, {"w": w_i8, "sw": sw}, 0.05), jops.ln_f32(act, ln))

    ref = [np.asarray(r) for r in jax.jit(jax_all)(kernel, gamma, beta, mean, var, act, a_i8,
                                                   w_i8, sw, b, ln)]
    fw, fb = pops.fold_conv_bn(_t(kernel), _t(gamma), _t(beta), _t(mean), _t(var))
    wq, ws = pops.quantize_weight_per_channel(fw)
    q = pops.requantize(_t(act), 0.37)
    lnt = {k: _t(v) for k, v in ln.items()}
    got = [fw, fb, wq, ws, q, pops.maxpool_i8(q),
           pops.dense_i8(_t(a_i8), {"w": _t(w_i8.T), "sw": _t(sw), "b": _t(b)}, 0.05),
           pops.dense_i8(_t(a_i8), {"w": _t(w_i8.T), "sw": _t(sw)}, 0.05),
           pops.ln_f32(_t(act), lnt)]
    for i, (g, r) in enumerate(zip(got, ref)):
        g = g.numpy()
        assert g.shape == r.shape and g.dtype == r.dtype, i
        if g.dtype in (np.int8, np.int32):
            np.testing.assert_array_equal(g, r, err_msg=str(i))
        else:
            np.testing.assert_allclose(g, r, rtol=1e-6, atol=1e-6 * np.abs(r).max(),
                                       err_msg=str(i))


def test_centered_grid_takes_uint8_int8_and_unit_floats():
    u8 = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (2, 4, 4, 3), np.uint8))
    want = (u8.to(torch.int16) - 128).to(torch.int8)
    assert torch.equal(pq.centered_grid(u8), want)
    assert torch.equal(pq.centered_grid(want), want)
    assert torch.equal(pq.centered_grid(u8.float() / 255.0), want)


# --------------------------------------------------------------------------
# the quantizers and int8 forwards
# --------------------------------------------------------------------------


def _calib(seed, n=16):
    return np.random.default_rng(seed).integers(0, 256, (n, SIZE, SIZE, 3), np.uint8)


def _recorded(monkeypatch, module):
    """Record every requantize output of ``module``'s int8 forward, in call
    order (the JAX forwards' and the port's call it in the same order)."""
    seen = []
    inner = module.requantize

    def requantize(*args):
        out = inner(*args)
        seen.append(out)
        return out

    monkeypatch.setattr(module, "requantize", requantize)
    return seen


def _compare_params(port_q, bridged, jax_q):
    """The port's own int8 parameters against JAX's carried across: scales
    within rel 1e-5, every float within rel 1e-4 of its tensor's max (the
    stem's and patch's biases sum in another order), int8 weights equal
    but at rounding ties. Returns the int8 weights that differ and their
    total."""
    assert set(port_q.qparams["scale"]) == set(bridged.qparams["scale"])
    for table in ("scale", "inv_scale"):
        for site, v in bridged.qparams[table].items():
            assert abs(port_q.qparams[table][site] - v) <= 1e-5 * abs(v), (table, site)
    differ = total = 0
    for key, e in bridged.qparams.items():
        if key in ("scale", "inv_scale"):
            continue
        mine = port_q.qparams[key]
        pairs = [(mine, e)] if torch.is_tensor(e) else [(mine[f], e[f]) for f in e]
        for a, b in pairs:
            if b is None:
                assert a is None, key
                continue
            assert a.shape == b.shape and a.dtype == b.dtype, key
            if b.dtype == torch.int8:
                d = (a.int() - b.int()).abs()
                assert int(d.max()) <= 1, key
                differ += int((d > 0).sum())
                total += b.numel()
            else:
                assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max()) + 1e-7, key
    return differ, total


def _compare_forwards(seen_port, seen_jax, got, ref, *, exact, equal_share, max_levels,
                      rel_logits):
    """Every requantized activation and the logits of the two int8
    forwards: the first ``exact`` activations bitwise, the rest equal at
    ``equal_share`` of all values and within ``max_levels`` each. Returns
    the share of equal int8 values."""
    assert len(seen_port) == len(seen_jax) > exact
    equal = total = 0
    for i, (a, b) in enumerate(zip(seen_port, seen_jax)):
        a, b = a.numpy().astype(np.int32), np.asarray(b).astype(np.int32)
        assert a.shape == b.shape
        d = np.abs(a - b)
        assert d.max() <= (0 if i < exact else max_levels), i
        equal += int((d == 0).sum())
        total += d.size
    assert equal / total >= equal_share, equal / total
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= rel_logits, err
    return equal / total


def _jax_int8(monkeypatch, jax_module, jax_q, x_i8):
    """The JAX int8 forward in one jit, with every requantize output."""
    seen = _recorded(monkeypatch, jax_module)

    def fwd(qp, x):
        seen.clear()
        return jax_q.apply_fn(qp, x), list(seen)

    logits, acts = jax.jit(fwd)(jax_q.qparams, x_i8)
    return np.asarray(logits), acts


RESNETS = {
    # resnet18's stages (BasicBlock, 2-2-2-2): identity blocks, strided 3×3s
    # and strided 1×1 downsamples
    "resnet18": dict(block="BasicBlock", stage_sizes=(2, 2, 2, 2)),
    # a two-stage ResNeXt: grouped 3×3s (groups 4, the second strided), the
    # stride-1 downsample of stage 0 and an identity bottleneck
    "resnext": dict(block="Bottleneck", stage_sizes=(1, 2), groups=4, base_width=16),
}


def _resnet_pair(kind, seed):
    cfg = dict(RESNETS[kind])
    block = cfg.pop("block")
    jm = jax_resnet.ResNet(block=getattr(jax_resnet, block), num_classes=10, **cfg)
    flat = numpy_variables(jm, SIZE, seed)
    jclf = JaxClassifier(name=kind, module=jm, variables=unflatten(flat), mean=MEAN, std=STD,
                         input_size=SIZE, num_classes=10)
    pm = port_resnet.ResNet(getattr(port_resnet, block), cfg.pop("stage_sizes"),
                            num_classes=10, **cfg)
    pm.load_state_dict(convert.state_dict_from_flax(flat))
    pclf = PortClassifier(kind, pm.eval(), MEAN, STD, input_size=SIZE, num_classes=10)
    return jclf, pclf


@pytest.mark.parametrize("kind", ["resnet18", "resnext"])
def test_quantize_classifier_matches_jax(kind, monkeypatch):
    """Parameters: equal ``stem_pad_vals``; int8 weights may differ at no
    more than 0.1% of values, each by one level (a tie of ``round`` moved
    by the last bit of a folded weight or scale; measured: none). Forward
    on the carried parameters: requantized activations equal at ≥ 99.9% of
    values and within one level elsewhere (a one-ulp difference in an f32
    epilogue before ``round``; measured: all equal), logits within rel
    1e-3 of max|logit| (measured 7e-7), the same argmax; the port's own
    parameters within rel 1e-3 too (measured 6e-7)."""
    jclf, pclf = _resnet_pair(kind, seed=3)
    calib = _calib(4)
    jax_q = jq.quantize_classifier(jclf, calib, calib_batch_size=8)
    port_q = pq.quantize_classifier(pclf, calib, calib_batch_size=8)
    bridged = convert.quantized_from_flax(pclf, jax.tree.map(np.asarray, jax_q.qparams))
    assert port_q.stem_pad_vals == bridged.stem_pad_vals == jax_q.stem_pad_vals
    differ, total = _compare_params(port_q, bridged, jax_q)
    assert differ <= 1e-3 * total, (differ, total)

    x = np.random.default_rng(5).integers(-128, 128, (2, SIZE, SIZE, 3), np.int8)
    ref, seen_jax = _jax_int8(monkeypatch, jq, jax_q, x)
    seen_port = _recorded(monkeypatch, pq)
    got = bridged(_t(x)).numpy()
    # the stem's requantize, each block's inner ones and its output's
    assert len(seen_port) == 1 + sum(len(b.convs) for b in bridged.blocks)
    _compare_forwards(seen_port, seen_jax, got, ref, exact=0, equal_share=0.999,
                      max_levels=1, rel_logits=1e-3)
    np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))
    # the port's own parameters run the same forward, and uint8 input is
    # the centered grid's
    own = port_q(_t(x))
    assert float((own - _t(ref)).abs().max()) <= 1e-3 * np.abs(ref).max()
    assert torch.equal(port_q(_t((x.astype(np.int16) + 128).astype(np.uint8))), own)


def _transformer_vars(jm, seed):
    """numpy_variables with LN scales, biases, the class token and Swin's
    bias tables drawn wide enough to reach the logits."""
    flat = numpy_variables(jm, SIZE, seed)
    rng = np.random.default_rng(seed + 100)
    for name, v in flat.items():
        if name.endswith(("cls_token", "relative_position_bias_table")):
            flat[name] = rng.normal(0, 0.2, v.shape).astype(np.float32)
    return flat


def _vit_pair(seed):
    kw = dict(patch_size=8, embed_dim=64, depth=2, num_heads=4, num_classes=10)
    jm = jax_vit.VisionTransformer(**kw, attention_impl="xla")
    flat = _transformer_vars(jm, seed)
    jclf = JaxClassifier(name="vit_tiny", module=jm, variables=unflatten(flat), mean=MEAN,
                         std=STD, input_size=SIZE, num_classes=10)
    pm = port_vit.VisionTransformer(**kw, img_size=SIZE).eval()
    pm.load_state_dict(convert.state_dict_from_flax(flat, head_dim=16))
    return jclf, PortClassifier("vit_tiny", pm, MEAN, STD, input_size=SIZE, num_classes=10)


def _swin_pair(seed):
    # stage 0 at 8² tokens with window 4: block 1 is shifted (shift 2)
    kw = dict(embed_dim=32, depths=(2, 1), num_heads=(2, 4), window_size=4, num_classes=10,
              drop_path=0.0)
    jax_swin.shift_attn_mask(8, 8, 4, 2)  # numpy built from jnp ops: made outside the jit
    jm = jax_swin.SwinTransformer(**kw, attention_impl="xla")
    flat = _transformer_vars(jm, seed)
    jclf = JaxClassifier(name="swin_tiny", module=jm, variables=unflatten(flat), mean=MEAN,
                         std=STD, input_size=SIZE, num_classes=10)
    pm = port_swin.SwinTransformer(**kw, img_size=SIZE).eval()
    pm.load_state_dict(convert.state_dict_from_flax(flat))
    return jclf, PortClassifier("swin_tiny", pm, MEAN, STD, input_size=SIZE, num_classes=10)


@pytest.mark.parametrize("family", ["vit", "swin"])
def test_quantize_transformer_matches_jax(family, monkeypatch):
    """ViT (two blocks, C 64, 4 heads) and Swin (C 32 then 64, a shifted
    block). Parameters as the ResNet's. Forward on the carried parameters:
    the first block's LN output and attention output, requantized, are
    bitwise equal. After the first residual add they part: the port rounds
    every bf16 step as the JAX program writes it (the dense output to
    bf16, then the add), where XLA on the CPU keeps a fused bf16 chain in
    f32 and rounds once (with ``--xla_allow_excess_precision=false`` the
    first LN after the add is bitwise equal too), and the two GELUs round
    differently; each flipped level carries on through the per-tensor
    scales of a random-weight model. So: ≥ 70% of all requantized values
    equal (measured 83% ViT, 76% Swin), each within 12 levels (measured
    5, 9), logits within rel 5e-2 of max|logit| (2.9e-2, 3.9e-2) and
    cosine ≥ 0.998 per image (0.9996, 0.9992). The JAX plain attention
    gives the same logits here as its Pallas kernel in interpret mode."""
    jclf, pclf = (_vit_pair if family == "vit" else _swin_pair)(seed=7)
    quantize = {"vit": (jq_vit.quantize_vit, pq_vit.quantize_vit),
                "swin": (jq_swin.quantize_swin, pq_swin.quantize_swin)}[family]
    calib = _calib(8)
    jax_q = quantize[0](jclf, calib, calib_batch_size=8, pallas=False)
    port_q = quantize[1](pclf, calib, calib_batch_size=8)
    bridged = convert.quantized_from_flax(pclf, jax.tree.map(np.asarray, jax_q.qparams))
    differ, total = _compare_params(port_q, bridged, jax_q)
    assert differ <= 1e-3 * total, (differ, total)

    x = np.random.default_rng(9).integers(-128, 128, (2, SIZE, SIZE, 3), np.int8)
    jmod, pmod = (jq_vit, pq_vit) if family == "vit" else (jq_swin, pq_swin)
    ref, seen_jax = _jax_int8(monkeypatch, jmod, jax_q, x)
    seen_port = _recorded(monkeypatch, pmod)
    got = bridged(_t(x)).numpy()
    _compare_forwards(seen_port, seen_jax, got, ref, exact=2, equal_share=0.7, max_levels=12,
                      rel_logits=5e-2)
    cos = (got * ref).sum(-1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(ref, axis=-1))
    assert cos.min() >= 0.998, cos


# --------------------------------------------------------------------------
# the solver
# --------------------------------------------------------------------------


def _int8_cfg(results, test, model=None, **quant):
    cfg = _cfg(results, test)
    cfg["model"].update(quantize="int8", quantize_calib_batches=1, **quant)
    if model:
        cfg["model"] = {**model, **{k: v for k, v in cfg["model"].items() if "quantize" in k}}
    return PortConfig(cfg)


def test_solver_int8_resnet_precomputed_and_online(tmp_path):
    """``model.quantize: int8`` builds the int8 classifier for a resnet18
    on the precomputed route and on both online routes; the fused and
    per-severity online runs write byte-identical result files."""
    import filecmp

    test = {"meta_file": str(_slices(tmp_path)), "transforms": {"type": "ONECROP"},
            "corruptions": ["gaussian_noise"], "severities": [1, 2]}
    solver = PortSolver(_int8_cfg(tmp_path / "pre", test), device="cpu")
    summary = solver.evaluate()
    assert isinstance(solver.quantized, pq.QuantizedClassifier) and summary["mCE"] is not None

    def online(name, fuse):
        test = {"read_from": "fake", "imagenet_c_online": True, "fuse_severities": fuse,
                "transforms": {"type": "JUSTNORM"}, "corruptions": ["gaussian_noise",
                                                                    "glass_blur"],
                "severities": [1, 3], "limit_samples": 6}
        s = PortSolver(_int8_cfg(tmp_path / name, test), device="cpu")
        return s, s.evaluate()

    (fs, fused), (ss, split) = online("fused", True), online("split", False)
    assert isinstance(fs.quantized, pq.QuantizedClassifier)
    assert isinstance(ss.quantized, pq.QuantizedClassifier)
    assert fused == split
    for corr in ("gaussian_noise", "glass_blur"):
        for sev in ("1", "3"):
            a = tmp_path / "fused" / corr / sev / "results.txt.all"
            assert len(a.read_text().splitlines()) == 6
            assert filecmp.cmp(a, tmp_path / "split" / corr / sev / "results.txt.all",
                               shallow=False)


def test_online_int8_input_is_the_centered_grid():
    """An int8 classifier takes K1's ``centered_u8`` output for the noise
    family (its plain version here), and the corrupted image's uint8 grid
    − 128 for every other corruption."""
    from robustart_torch.models import create_classifier
    from robustart_torch.noise import corruptions as pc
    from robustart_torch.ops.noise import fused_noise_normalize_reference
    from robustart_torch.solvers.multi_eval_solver import online_logits

    clf = create_classifier("resnet18", device="cpu", input_size=SIZE, num_classes=10)
    q = pq.quantize_classifier(clf, _calib(1, 8), calib_batch_size=8)
    imgs = torch.from_numpy(_calib(2, 2))
    with torch.inference_mode():
        grid = fused_noise_normalize_reference(
            imgs, 7, noise="gaussian_noise", sigma=pc.NOISE_SEVERITY["gaussian_noise"][2],
            out_dtype=torch.int8, output="centered_u8")
        assert torch.equal(online_logits(q, "gaussian_noise", 3, imgs, 7), q(grid))
        x = pc.corrupt_batch(pc.to_unit(imgs), "glass_blur", 1,
                             generator=torch.Generator().manual_seed(7))
        want = q((pc.uint8_grid(x) - 128).to(torch.int8))
        assert torch.equal(online_logits(q, "glass_blur", 1, imgs, 7), want)
        assert torch.equal(q(pc.uint8_roundtrip(x)), want)


def _tiny(monkeypatch, name, factory):
    monkeypatch.setitem(port_registry.MODELS, name, factory)
    monkeypatch.setitem(port_registry._META, name, port_registry._META["vit_base"])


def test_solver_refuses_vit_int8_without_force(tmp_path, monkeypatch):
    _tiny(monkeypatch, "vit_tiny_test", lambda **kw: port_vit.VisionTransformer(
        patch_size=8, embed_dim=32, depth=1, num_heads=2, num_classes=10, img_size=32))
    model = {"type": "vit_tiny_test"}
    with pytest.raises(ValueError, match="quantize_force"):
        PortSolver(_int8_cfg(tmp_path, {}, model), device="cpu").build_model()
    solver = PortSolver(_int8_cfg(tmp_path, {}, model, quantize_force=True), device="cpu")
    solver.build_model()
    q = solver.build_quantized(_calib(2, 4))
    assert isinstance(q, pq_vit.QuantizedViT)
    assert q(torch.from_numpy(_calib(3, 2))).shape == (2, 10)


@pytest.mark.parametrize("family", ["convnext", "mixer", "densenet"])
def test_solver_int8_families_not_ported_raise(family, tmp_path, monkeypatch):
    from robustart_torch.models import convnext, densenet, mlp_mixer

    factories = {
        "convnext": lambda **kw: convnext.ConvNeXt(depths=(1, 1), dims=(32, 64), num_classes=10),
        "mixer": lambda **kw: mlp_mixer.MlpMixer(patch_size=8, embed_dim=32, depth=1,
                                                 tokens_mlp_dim=16, channels_mlp_dim=64,
                                                 num_classes=10, img_size=32),
        "densenet": lambda **kw: densenet.DenseNet(block_config=(1, 1), growth_rate=8,
                                                   num_init_features=16, num_classes=10),
    }
    _tiny(monkeypatch, f"{family}_tiny_test", factories[family])
    # the Mixer, which the JAX package refuses unforced, is forced here
    cfg = _int8_cfg(tmp_path, {}, {"type": f"{family}_tiny_test"}, quantize_force=True)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        PortSolver(cfg, device="cpu").build_model()
