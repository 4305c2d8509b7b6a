"""The port's fog, frost, brightness, contrast, saturate, pixelate and
jpeg_compression against the JAX package, on the CPU.

- jpeg_compression bitwise against ``jpeg_jax.jpeg_compression`` and
  against PIL's own codec, at 2 × 32 × 32 and at 2 × 27 × 35 (not a
  multiple of 16: every edge convention of the MCU grid).
- contrast, brightness, saturate and pixelate within ``ATOL`` and at most
  ``LEVELS`` of uint8 levels differing (none for ``EXACT_LEVELS``), on
  uint8 images as the solver feeds them; ``rgb_to_hsv``, ``hsv_to_rgb`` and
  ``pil_box_matrix`` (the JAX package's ``"pil-box"`` ``resize_matrix``) on
  their own.
- fog and frost with the JAX package's draw injected: the test rebuilds its
  key splits and uniform/randint calls and hands the arrays to the port;
  ``frost_bank`` bitwise the JAX bank.
- The port's own sampler, and the solver's default 15-corruption sweep.

Severities 1, 3 and 5. Budget: under 60 s in one process. Each JAX function
is jitted once a shape, over all three severities (``_jax_sweep``,
``_jax_draws``): a new JAX program is a compile, which costs more than
the arithmetic.
"""

import functools
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from robustart_torch.core.config import Config as PortConfig
from robustart_torch.metrics import mean_corruption_error
from robustart_torch.models import convert
from robustart_torch.noise import corruptions as pc
from robustart_torch.noise import jpeg as pj
from robustart_torch.ops import image as pimg
from robustart_torch.solvers import MultiEvalSolver as PortSolver
from robustart_torch.solvers.multi_eval_solver import STANDARD_CORRUPTIONS
from robustart_tpu.core.config import Config
from robustart_tpu.models.torch_convert import flatten
from robustart_tpu.noise.corruptions import jax_kernels as jk
from robustart_tpu.noise.corruptions import jpeg_jax as jj
from robustart_tpu.ops import image as jimg
from robustart_tpu.solvers import MultiEvalSolver as JaxSolver
from tests.test_torch_port_corruptions import _cfg, _scores
from tests.test_torch_port_resnet import numpy_init

B, H, W = 2, 32, 32
SEVERITIES = (1, 3, 5)
# atol on the [0,1] output: XLA may contract a multiply-add into an FMA
# (an ulp), and the means, box sums and fractal levels sum in another order
ATOL = 1e-6
LEVELS = 1e-3  # at most this share of uint8 levels may differ
# on uint8 images these put many outputs exactly on a level; the port
# computes their steps as the JAX program does, so no level may differ
EXACT_LEVELS = ("brightness", "saturate", "pixelate")
# the JAX solver's entry for frost (robustart_tpu/solvers/multi_eval_solver.py)
FROST_NOTE = {"frost": "procedural-texture substitute for missing assets"}


def _t(a):
    return torch.from_numpy(np.array(a))


def _images(shape):
    """uint8 levels / 255, as the solver feeds the corruptions."""
    u8 = np.random.default_rng(sum(shape)).integers(0, 256, (*shape, 3), np.uint8)
    return u8, (u8.astype(np.float32) / np.float32(255.0))


def _keys():
    return jax.random.split(jax.random.key(7), len(SEVERITIES))


@functools.lru_cache(maxsize=None)
def _jax_sweep(name, shape):
    """``jax_kernels.corrupt_batch`` of ``_images(shape)`` at severities 1, 3
    and 5, severity i with ``_keys()[i]``: one jit for the three."""
    def run(x, keys):
        return [jk.corrupt_batch(x, keys[i], name, s) for i, s in enumerate(SEVERITIES)]

    out = jax.jit(run)(jnp.asarray(_images(shape)[1]), _keys())
    return [np.asarray(o) for o in out]


@functools.lru_cache(maxsize=None)
def _jax_draws(name, shape):
    """The draw each image of ``corrupt_batch(x, _keys()[i], name, s)``
    makes, rebuilt from the JAX package's key splits and calls, in the
    port's injected form: one dict a severity. One jit for the three."""
    b, h, w = shape

    def fog_draw(key, decay, mapsize):
        levels, step, wibble = [], mapsize, 100.0
        while step >= 2:  # plasma_fractal's loop
            key, k1, k2, k3 = jax.random.split(key, 4)
            n = mapsize // step
            levels.append(tuple(jax.random.uniform(k, (n, n), jnp.float32, -wibble, wibble)
                                for k in (k1, k2, k3)))
            step //= 2
            wibble /= decay
        return levels

    def frost_draw(key):
        size = 320
        k1, k2, k3 = jax.random.split(key, 3)
        return (jax.random.randint(k1, (), 0, 6), jax.random.randint(k2, (), 0, size - h),
                jax.random.randint(k3, (), 0, size - w))

    def run(keys):
        out = []
        for i, s in enumerate(SEVERITIES):
            per_image = jax.random.split(keys[i], b)
            if name == "fog":
                decay = pc.FOG_SEVERITY[s - 1][1]
                out.append(jax.vmap(lambda k, d=decay: fog_draw(k, d, pc.fog_mapsize(h, w)))(
                    per_image))
            else:
                out.append(jax.vmap(frost_draw)(per_image))
        return out

    draws = jax.jit(run)(_keys())
    if name == "fog":
        return [{"fractal": [tuple(_t(u) for u in lvl) for lvl in d]} for d in draws]
    return [dict(zip(("idx", "ys", "xs"), (_t(a).to(torch.int64) for a in d))) for d in draws]


def _levels_differ(a, b):
    return float(np.mean(np.floor(a * 255.0) != np.floor(b * 255.0)))


# ---------------------------------------------------------------------------
# jpeg_compression
# ---------------------------------------------------------------------------


def _pil_roundtrip(arr, quality):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "JPEG", quality=quality)
    return np.asarray(Image.open(buf))


@pytest.mark.parametrize("shape", [(B, H, W), (B, 27, 35)])
def test_jpeg_bitwise_against_jax_and_pil(shape):
    u8, x = _images(shape)
    ref = _jax_sweep("jpeg_compression", shape)
    for i, s in enumerate(SEVERITIES):
        got = pj.jpeg_compression(_t(x), s).numpy()
        assert got.dtype == np.float32 and got.shape == x.shape
        np.testing.assert_array_equal(got, ref[i], err_msg=f"severity {s}")
        pil = np.stack([_pil_roundtrip(img, pj.QUALITY_BY_SEVERITY[s - 1]) for img in u8])
        np.testing.assert_array_equal(np.round(got * 255.0).astype(np.uint8), pil)
        np.testing.assert_array_equal(pc.uint8_grid(_t(got)).numpy().astype(np.uint8), pil)


def test_jpeg_roundtrip_u8_matches_pil_at_other_qualities():
    """The transcode at qualities past the severities' (50: the scale's
    branch; 90: tables near 1), on an unaligned size."""
    u8 = np.random.default_rng(1).integers(0, 256, (1, 17, 31, 3), np.uint8)
    for q in (50, 90):
        got = pj.jpeg_roundtrip_u8(_t(u8), q).numpy()
        np.testing.assert_array_equal(got[0], _pil_roundtrip(u8[0], q))
        np.testing.assert_array_equal(pj.quant_table(True, q), jj._quant_table(jj._STD_CHROMA, q))


# ---------------------------------------------------------------------------
# colour and resize helpers
# ---------------------------------------------------------------------------


def test_hsv_pair_matches_jax():
    """Uint8 levels (with gray pixels: delta 0, and ties of the maximum) and
    free floats, both ways: atol 1e-6."""
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.integers(0, 256, (64, 3)).astype(np.float32) / np.float32(255.0),
        np.repeat(rng.random((8, 1), dtype=np.float32), 3, axis=1),
        np.array([[1, 1, 0], [0, 1, 1], [1, 0, 1], [0, 0, 0], [0.5, 0.5, 0.2]], np.float32),
        rng.random((64, 3), dtype=np.float32),
    ])
    hsv = pimg.rgb_to_hsv(_t(x)).numpy()
    np.testing.assert_allclose(hsv, np.asarray(jimg.rgb_to_hsv(jnp.asarray(x))), rtol=0,
                               atol=ATOL)
    assert hsv.min() >= 0.0 and hsv.max() <= 1.0
    np.testing.assert_allclose(pimg.hsv_to_rgb(_t(hsv)).numpy(),
                               np.asarray(jimg.hsv_to_rgb(jnp.asarray(hsv))), rtol=0, atol=ATOL)
    np.testing.assert_allclose(pimg.hsv_to_rgb(_t(hsv)).numpy(), x, rtol=0, atol=1e-6)


@pytest.mark.parametrize("n,m", [(32, 19), (19, 32), (224, 134), (134, 224), (224, 89),
                                 (89, 224), (35, 8), (8, 35), (27, 27)])
def test_pil_box_resize_matrix_equals_jax(n, m):
    np.testing.assert_array_equal(pimg.pil_box_matrix(n, m),
                                  jimg.resize_matrix(n, m, "pil-box"))


def test_frost_bank_equals_jax():
    got = pc.frost_bank()
    assert got.shape == (6, 320, 320, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, jk._frost_bank())


# ---------------------------------------------------------------------------
# the six float corruptions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("severity", SEVERITIES)
@pytest.mark.parametrize("name", ["contrast", "brightness", "saturate", "pixelate", "fog",
                                  "frost"])
def test_corruption_matches_jax(name, severity):
    i = SEVERITIES.index(severity)
    _, x = _images((B, H, W))
    ref = _jax_sweep(name, (B, H, W))[i]
    draws = _jax_draws(name, (B, H, W))[i] if name in ("fog", "frost") else {}
    got = pc.CORRUPTIONS[name](_t(x), severity, **draws).numpy()
    assert got.shape == ref.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    assert _levels_differ(got, ref) <= (0.0 if name in EXACT_LEVELS else LEVELS)


def test_frost_past_the_bank_matches_jax():
    """Width 330 > the bank's 320: the JAX package draws xs = 0 (an empty
    randint range) and its one-hot crop reads 0 past the bank; the port
    does the same."""
    shape = (1, 8, 330)
    _, x = _images(shape)
    for i, s in enumerate(SEVERITIES):
        draws = _jax_draws("frost", shape)[i]
        assert int(draws["xs"][0]) == 0
        got = pc.frost(_t(x), s, **draws).numpy()
        np.testing.assert_allclose(got, _jax_sweep("frost", shape)[i], rtol=0, atol=ATOL)
        ca = pc.FROST_SEVERITY[s - 1][0]
        np.testing.assert_allclose(got[:, :, 320:], np.clip(ca * x[:, :, 320:], 0, 1), atol=1e-7)


# ---------------------------------------------------------------------------
# the port's own sampler
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["fog", "frost"])
def test_generator_draws_repeat(name):
    """The same generator seed repeats, another seed differs, outputs lie
    in [0, 1]."""
    _, x = _images((B, H, W))

    def run(seed):
        return pc.corrupt_batch(_t(x), name, 3, generator=torch.Generator().manual_seed(seed))

    a = run(1)
    assert torch.equal(a, run(1)) and not torch.equal(a, run(2))
    assert float(a.min()) >= 0.0 and float(a.max()) <= 1.0


@pytest.mark.parametrize("decay", [d for _, d in pc.FOG_SEVERITY])
def test_plasma_fractal_is_normalized_per_image(decay):
    f = pc.plasma_fractal(3, 256, decay, generator=torch.Generator().manual_seed(0))
    assert f.shape == (3, 256, 256)
    np.testing.assert_array_equal(f.amin(dim=(1, 2)).numpy(), np.zeros(3, np.float32))
    np.testing.assert_array_equal(f.amax(dim=(1, 2)).numpy(), np.ones(3, np.float32))
    assert pc.fog_mapsize(224, 224) == 256 and pc.fog_mapsize(384, 300) == 512
    assert pc.fog_mapsize(512, 27) == 512


def test_frost_draws_reach_every_texture_inside_the_bank():
    idx, ys, xs = pc.frost_draws(400, H, 300, torch.Generator().manual_seed(0))
    assert set(idx.tolist()) == set(range(6))
    assert int(ys.min()) >= 0 and int(ys.max()) < 320 - H
    assert int(xs.min()) >= 0 and int(xs.max()) < 320 - 300
    assert len(set(ys.tolist())) > 100
    assert set(pc.frost_draws(50, H, 330, torch.Generator().manual_seed(0))[2].tolist()) == {0}


# ---------------------------------------------------------------------------
# the solver
# ---------------------------------------------------------------------------


def test_solver_default_sweep_is_the_15_standard_corruptions(tmp_path):
    """No ``corruptions`` key: the 15 standard corruptions, an mCE over
    exactly them, frost named as not comparable."""
    test = {"severities": [1], "limit_samples": 2}
    summary = PortSolver(PortConfig(_cfg(tmp_path, test)), device="cpu").evaluate()
    top1 = summary["top1_per_corruption"]
    assert tuple(top1) == STANDARD_CORRUPTIONS == pc.CORRUPTION_ORDER[:15]
    assert summary["mCE"] == mean_corruption_error(top1) and np.isfinite(summary["mCE"])
    assert summary["non_comparable"] == FROST_NOTE
    assert json.loads((tmp_path / "summary.json").read_text()) == summary
    for corruption in STANDARD_CORRUPTIONS:
        assert len((tmp_path / corruption / "1" / "results.txt.all").read_text()
                   .splitlines()) == 2


def test_solver_jpeg_and_brightness_match_jax_solver(tmp_path, monkeypatch):
    """Both solvers online on the same fake images and weights: the same
    summary (top-1s, mCE, no frost note), the same labels line by line, and
    logits within 1e-4·max|ref| (the ResNet tolerance)."""
    test = {"corruptions": ["jpeg_compression", "brightness"], "severities": [1],
            "limit_samples": 2}
    jax_solver = JaxSolver(Config(_cfg(tmp_path / "jax", dict(test))))
    numpy_init(monkeypatch)
    jax_solver.build_model(seed=0)
    port = PortSolver(PortConfig(_cfg(tmp_path / "port", dict(test))), device="cpu")
    port.build_model(seed=0)
    flat = {k: np.asarray(v) for k, v in flatten(jax_solver.classifier.variables).items()}
    port.classifier.model.load_state_dict(convert.state_dict_from_flax(flat))
    port_summary = port.evaluate()
    assert port_summary == jax_solver.evaluate() and port_summary["non_comparable"] == {}
    for corruption in test["corruptions"]:
        a_path = tmp_path / "jax" / corruption / "1" / "results.txt.all"
        b_path = tmp_path / "port" / corruption / "1" / "results.txt.all"
        labels = [[json.loads(line)["label"] for line in open(p)] for p in (a_path, b_path)]
        assert labels[0] == labels[1] and len(labels[0]) == 2
        a, b = _scores(a_path), _scores(b_path)
        assert a.shape == b.shape == (2, 10)
        assert np.abs(a - b).max() <= 1e-4 * np.abs(a).max()


def test_corrupt_single_image_api():
    """``corrupt`` on the CPU: jpeg_compression equals PIL's round trip of
    the image and the batch transcode; a random corruption with a seed
    equals ``corrupt_batch`` with that seed; the named functions and the
    number route to the same call; unknown names raise."""
    u8, x = _images((1, 27, 35))
    img = Image.fromarray(u8[0])
    got = pc.corrupt(img, 3, "jpeg_compression", device="cpu")
    assert got.dtype == np.uint8 and got.shape == (27, 35, 3)
    np.testing.assert_array_equal(got, _pil_roundtrip(u8[0], pj.QUALITY_BY_SEVERITY[2]))
    np.testing.assert_array_equal(got, pc.uint8_grid(pj.jpeg_compression(_t(x), 3))[0]
                                  .numpy().astype(np.uint8))
    fog = pc.corrupt(u8[0], 2, corruption_number=pc.CORRUPTION_ORDER.index("fog"), seed=4,
                     device="cpu")
    want = pc.corrupt_batch(_t(u8.astype(np.float32) / 255.0), "fog", 2,
                            generator=torch.Generator().manual_seed(4))
    np.testing.assert_array_equal(fog, pc.uint8_grid(want)[0].numpy().astype(np.uint8))
    np.testing.assert_array_equal(pc.corruption_dict["fog"](u8[0], 2, device="cpu").shape,
                                  (27, 35, 3))
    assert [f.__name__ for f in pc.corruption_tuple] == list(pc.CORRUPTION_ORDER)
    with pytest.raises(KeyError):
        pc.corrupt(u8[0], 1, "fogg", device="cpu")
    with pytest.raises(ValueError):
        pc.corrupt(u8[0], 1, device="cpu")
