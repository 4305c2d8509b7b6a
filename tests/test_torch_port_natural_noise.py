"""The port's ImageNet-P and ImageNet-A/O solvers, their frame synthesis and
video reading against the JAX package, on the CPU.

- ``perturb_frame`` for each default perturbation and speckle_noise at
  frames 0, 15 and 30 of 31, 2 × 24 × 24: the JAX side under one
  ``jax.jit`` a perturbation with the frame traced (as its solver's fused
  video program runs it), the noise perturbations with JAX's own draws
  injected into the port. Noise and brightness frames within ``ATOL`` and
  uint8 frames equal; the warps within ``WARP_ATOL`` (below), at most
  ``LEVELS`` of uint8 values a level apart.
- The whole ImageNet-P solver on a tiny f32 ResNet-18 at n_frames 4, in the
  online mode (brightness, rotate), the fake-videos mode and the stored
  ``.npy`` mode: result lines identical to JAX's, the same mFR.
- The ImageNet-A/O solver with ``class_subset`` as a list and as a file:
  A scores within 1e-4 of max|logit|, the same confidences' ``correct``,
  AUPR within 1e-6.
- ``_read_video`` against JAX's on a 4-frame MJPG ``.avi`` that cv2 writes,
  bitwise, and the stored mode on it.
- The CLIs run on the card by default (refused here) and on the CPU with
  ``--device cpu``.

Budget: under 60 s in one process; the JAX programs are the cost (one
jit a perturbation; the solvers' forwards at B = 4 and 16).
"""

import tests.torch_port_threads  # noqa: F401  (before any torch work)
import json
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from robustart_torch.core.config import Config as PortConfig
from robustart_torch.data import dataset as pds
from robustart_torch.models import convert
from robustart_torch.solvers import ImgnetAOEvalSolver as PortAO
from robustart_torch.solvers import ImgnetPEvalSolver as PortP
from robustart_torch.solvers import imgnet_a_o_eval_solver as pao
from robustart_torch.solvers import imgnet_p_eval_solver as pp
from robustart_tpu.core.config import Config
from robustart_tpu.data import dataset as jds
from robustart_tpu.models.torch_convert import flatten
from robustart_tpu.solvers import ImgnetAOEvalSolver as JaxAO
from robustart_tpu.solvers import ImgnetPEvalSolver as JaxP
from robustart_tpu.solvers import imgnet_p_eval_solver as jp
from tests.test_torch_port_resnet import numpy_init

B, H, W, F = 2, 24, 24, 31
FRAMES = (0, 15, 30)
ATOL = 1e-6
# The warps' coordinates are float32 below 32 here, whose ulp is 2^-19. XLA
# contracts some of the JAX program's products and sums into FMAs, a
# choice of each fused program (translate's row and column maps differ in
# it), while the port rounds every step, as K2 does on the card: a
# coordinate an ulp apart moves a bilinear value by at most 2^-19 times
# the step between neighbours (at most 1), and the blend by a few ulps.
WARP_ATOL = 2.0**-19 + 2.0**-22
LEVELS = 1e-3  # share of uint8 values that may sit a level apart (warps)
WARPS = ("motion_blur", "zoom_blur", "translate", "rotate", "tilt", "scale")


def _jax_draws(pert, keys):
    """JAX's draws of each image's key in ``perturb_frame``, in the form
    the port's corruptions take injected."""
    if pert in ("gaussian_noise", "speckle_noise"):
        return {"normal": np.stack([jax.random.normal(k, (H, W, 3), jnp.float32)
                                    for k in keys])}
    if pert == "shot_noise":
        return {"uniform": np.stack([jax.random.uniform(k, (H, W, 3), jnp.float32)
                                     for k in keys])}
    if pert == "snow":
        pairs = [jax.random.split(k) for k in keys]
        return {"normal": np.stack([jax.random.normal(k1, (H, W), jnp.float32)
                                    for k1, _ in pairs]),
                "angles": np.stack([jax.random.uniform(k2, (), jnp.float32, -135.0, -45.0)
                                    for _, k2 in pairs])}
    return {}


@pytest.mark.parametrize("pert", jp.DEFAULT_PERTURBATIONS + ("speckle_noise",))
def test_perturb_frame_matches_jax(pert):
    x = np.random.default_rng(0).uniform(0, 1, (B, H, W, 3)).astype(np.float32)
    keys = jax.random.split(jax.random.key(5), B)
    fn = jax.jit(lambda xx, f, ks: jax.vmap(
        lambda img, k: jp.perturb_frame(pert, img, f, k, F))(xx, ks))
    draws = {k: torch.from_numpy(np.asarray(v)) for k, v in _jax_draws(pert, keys).items()}
    for frame in FRAMES:
        want = np.asarray(fn(x, jnp.int32(frame), keys))
        got = pp.perturb_frame(pert, torch.from_numpy(x), frame, F, **draws).numpy()
        err = np.abs(got - want).max()
        levels = np.floor(np.clip(got, 0, 1) * 255) - np.floor(np.clip(want, 0, 1) * 255)
        if pert in WARPS:
            assert err <= WARP_ATOL, (pert, frame, err)
            assert np.abs(levels).max() <= 1 and (levels != 0).mean() <= LEVELS
        else:
            assert err <= ATOL, (pert, frame, err)
            assert not levels.any(), (pert, frame)


def test_perturb_frame_passes_other_names_through_an_identity_warp():
    x = np.random.default_rng(1).uniform(0, 1, (B, H, W, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jax.vmap(lambda img: jp.perturb_frame(
        "gaussian_blur", img, 7, jax.random.key(0), F)))(x))
    for name in ("gaussian_blur", "spatter", "no_such_perturbation"):
        got = pp.perturb_frame(name, torch.from_numpy(x), 7, F).numpy()
        np.testing.assert_array_equal(got, x)
    np.testing.assert_array_equal(want, x)


def test_frame_severity_starts_at_one():
    """Frame 0 of a noise video is severity 1, not the clean image."""
    sev = [pp.frame_severity(f, F) for f in range(F)]
    assert sev[0] == 1 and sev[-1] == 5 and sev == sorted(sev)
    assert sev == [int(min(1 + (f * 5) // F, 5)) for f in range(F)]


def test_video_seed_is_stable_and_distinct():
    seeds = {pp.video_seed(0, p, b) for p in jp.DEFAULT_PERTURBATIONS for b in range(50)}
    assert len(seeds) == 500 and all(0 <= s < 2**32 for s in seeds)
    # a stable hash, not Python's per-process string hash
    assert pp.video_seed(3, "snow", 2) == zlib.crc32(b"3/snow/2") == 336692396


# ---------------------------------------------------------------------------
# the solvers
# ---------------------------------------------------------------------------


def _cfg(results, data=None, **test):
    return {
        "model": {"type": "resnet18", "kwargs": {"num_classes": 10}},
        "seed": 0,
        "data": {
            "batch_size": 4, "num_workers": 2, "input_size": 32, "read_from": "fake",
            "fake_size": 6, "fake_num_classes": 10, **(data or {}),
            "test": {"sampler": {"type": "distributed"}, "transforms": {"type": "JUSTNORM"},
                     **test},
        },
        "saver": {"results_dir": str(results)},
    }


def _run_both(tmp_path, monkeypatch, jax_cls, port_cls, cfg_of):
    """Each package's solver on its own config from ``cfg_of(root)``, the
    port holding the JAX classifier's weights."""
    numpy_init(monkeypatch)
    jax_solver = jax_cls(Config(cfg_of(tmp_path / "jax")))
    jax_solver.build_model(seed=0)
    port = port_cls(PortConfig(cfg_of(tmp_path / "port")), device="cpu")
    port.build_model(seed=0)
    flat = {k: np.asarray(v) for k, v in flatten(jax_solver.classifier.variables).items()}
    port.classifier.model.load_state_dict(convert.state_dict_from_flax(flat))
    return jax_solver.evaluate(), port.evaluate()


def _stored_videos(root, n=5, frames=4):
    rng = np.random.default_rng(4)
    pert_dir = root / "gaussian_noise"
    pert_dir.mkdir(parents=True)
    with (pert_dir / "meta.txt").open("w") as f:
        for i in range(n):
            np.save(pert_dir / f"v{i}.npy", rng.integers(0, 256, (frames, 32, 32, 3), np.uint8))
            f.write(f"v{i}.npy {i}\n")
    return {"read_from": "fs"}, {"root_dir": str(root), "meta_file": str(pert_dir / "meta.txt")}


@pytest.mark.parametrize("mode", ["online", "fake", "stored"])
def test_p_solver_matches_jax(mode, tmp_path, monkeypatch):
    data, test = {}, {"n_frames": 4}
    if mode == "online":
        test.update(imagenet_p_online=True, perturbations=["brightness", "rotate"])
    elif mode == "fake":
        test.update(perturbations=["gaussian_noise"])
    else:
        data, extra = _stored_videos(tmp_path / "videos")
        test.update(perturbations=["gaussian_noise"], **extra)
    want, got = _run_both(tmp_path, monkeypatch, JaxP, PortP,
                          lambda root: _cfg(root, data, **test))
    assert got == want
    for pert in test["perturbations"]:
        a = (tmp_path / "jax" / pert / "results.txt.all").read_text()
        b = (tmp_path / "port" / pert / "results.txt.all").read_text()
        assert a == b
        lines = [json.loads(line)["predictions"] for line in b.splitlines()]
        assert len(lines) == (5 if mode == "stored" else 6)
        assert all(len(p) == 4 for p in lines)
    assert 0.0 <= got["Mean"] <= 1.0


def test_p_solver_online_noise_is_reproducible(tmp_path):
    """Two online runs of the noise perturbations draw the same frames
    (``video_seed``), and each line holds n_frames classes."""
    texts = []
    for run in ("a", "b"):
        cfg = _cfg(tmp_path / run, imagenet_p_online=True, n_frames=3, limit_samples=5,
                   perturbations=["gaussian_noise", "snow"])
        out = PortP(PortConfig(cfg), device="cpu").evaluate()
        assert set(out["per_perturbation"]) == {"gaussian_noise", "snow"}
        texts.append([(tmp_path / run / p / "results.txt.all").read_text()
                      for p in ("gaussian_noise", "snow")])
    assert texts[0] == texts[1]
    assert [len(t.splitlines()) for t in texts[0]] == [5, 5]


@pytest.fixture(scope="module")
def ao_runs(tmp_path_factory):
    """The JAX A/O solver (class_subset a list) and the port's with the
    subset as a list and as a file."""
    root = tmp_path_factory.mktemp("ao")
    subset = [7, 2, 9, 0, 4]
    (root / "subset.txt").write_text("\n".join(map(str, subset)) + "\n")

    def cfg(name, spec):
        return _cfg(root / name, {"fake_size": 16, "batch_size": 8},
                    **{"imagenet_a&o": True, "class_subset": spec})

    with pytest.MonkeyPatch.context() as mp:
        numpy_init(mp)
        jax_solver = JaxAO(Config(cfg("jax", subset)))
        jax_solver.build_model(seed=0)
    flat = {k: np.asarray(v) for k, v in flatten(jax_solver.classifier.variables).items()}
    out = {"jax": jax_solver.evaluate()}
    for name, spec in (("list", subset), ("file", str(root / "subset.txt"))):
        port = PortAO(PortConfig(cfg(name, spec)), device="cpu")
        port.build_model(seed=0)
        port.classifier.model.load_state_dict(convert.state_dict_from_flax(flat))
        out[name] = port.evaluate()
    return root, out


def _lines(path):
    return [json.loads(line) for line in open(path)]


@pytest.mark.parametrize("spec", ["list", "file"])
def test_ao_solver_matches_jax(spec, ao_runs):
    root, out = ao_runs
    want, got = out["jax"], out[spec]
    assert got["imagenet-a"] == want["imagenet-a"]
    assert abs(got["imagenet-o"]["AUPR"] - want["imagenet-o"]["AUPR"]) <= 1e-6
    a = _lines(root / "jax" / "imagenet-a" / "results.txt.all")
    b = _lines(root / spec / "imagenet-a" / "results.txt.all")
    sa, sb = np.array([r["score"] for r in a]), np.array([r["score"] for r in b])
    assert sa.shape == sb.shape == (16, 5)
    assert np.abs(sa - sb).max() <= 1e-4 * np.abs(sa).max()
    assert [r["label"] for r in a] == [r["label"] for r in b]
    for split in ("results_in", "results_out"):
        ja = _lines(root / "jax" / "imagenet-o" / f"{split}.txt.all")
        pa = _lines(root / spec / "imagenet-o" / f"{split}.txt.all")
        assert [r["correct"] for r in pa] == [r["correct"] for r in ja]
        assert [r["num_correct"] for r in pa] == [r["num_correct"] for r in ja]
        np.testing.assert_allclose([c for r in pa for c in r["confidence"]],
                                   [c for r in ja for c in r["confidence"]], rtol=1e-5)


def test_load_subset_forms(tmp_path):
    (tmp_path / "s.txt").write_text("3 1\n2\n")
    np.testing.assert_array_equal(pao._load_subset(str(tmp_path / "s.txt")), [3, 1, 2])
    np.testing.assert_array_equal(pao._load_subset((5, 6)), [5, 6])
    assert pao._load_subset(None) is None


# ---------------------------------------------------------------------------
# videos on disk and the command lines
# ---------------------------------------------------------------------------


def _write_avi(path, frames):
    import cv2

    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), 5,
                             (frames.shape[2], frames.shape[1]))
    assert writer.isOpened()
    for frame in frames:
        writer.write(frame)
    writer.release()


def test_read_video_matches_jax(tmp_path):
    frames = np.random.default_rng(5).integers(0, 256, (4, 32, 40, 3), np.uint8)
    _write_avi(tmp_path / "v.avi", frames)
    got = pds._read_video(str(tmp_path / "v.avi"))
    want = jds._read_video(str(tmp_path / "v.avi"))
    assert got.shape == (4, 32, 40, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    with pytest.raises(IOError, match="cannot open"):
        pds._read_video(str(tmp_path / "missing.avi"))


def test_stored_avi_videos_equal_their_npy(tmp_path):
    """The stored mode reads .avi videos through ``_read_video``: the same
    lines as the same frames stored as .npy."""
    rng = np.random.default_rng(6)
    texts = {}
    for ext in ("avi", "npy"):
        d = tmp_path / ext / "rotate"
        d.mkdir(parents=True)
        with (d / "meta.txt").open("w") as f:
            for i in range(3):
                if ext == "avi":
                    frames = rng.integers(0, 256, (4, 32, 32, 3), np.uint8)
                    _write_avi(d / f"v{i}.avi", frames)
                else:
                    np.save(d / f"v{i}.npy", pds._read_video(
                        str(tmp_path / "avi" / "rotate" / f"v{i}.avi")))
                f.write(f"v{i}.{ext} {i}\n")
        cfg = _cfg(tmp_path / f"out_{ext}", {"read_from": "fs"}, n_frames=4,
                   perturbations=["rotate"], root_dir=str(tmp_path / ext),
                   meta_file=str(d / "meta.txt"))
        PortP(PortConfig(cfg), device="cpu").evaluate()
        texts[ext] = (tmp_path / f"out_{ext}" / "rotate" / "results.txt.all").read_text()
    assert texts["avi"] == texts["npy"] and len(texts["avi"].splitlines()) == 3


@pytest.mark.parametrize("module", [pp, pao])
def test_cli_runs_on_the_card_unless_told(module, tmp_path):
    cfg = tmp_path / "cfg.yaml"
    extra = ({"perturbations": ["brightness"], "n_frames": 2, "imagenet_p_online": True}
             if module is pp else {"class_subset": [1, 2, 3]})
    cfg.write_text(yaml.safe_dump(_cfg(tmp_path / "out", **extra)))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            module.main(["--config", str(cfg)])
    out = module.main(["--config", str(cfg), "--device", "cpu"])
    assert out and (tmp_path / "out").exists()
