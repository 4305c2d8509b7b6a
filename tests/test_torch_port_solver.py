"""The port's ImageNet-C solver against the JAX package's.

- Precomputed mode on stored slices (the fixture of
  test_multi_eval_precomputed.py) through both solvers with the same weights:
  the same top-1 per file and logits within the ResNet tolerance.
- Online mode on the fake backend: every file written, the fused run
  byte-equal to the per-severity run, an mCE.
- The online chain with all-zero random words: the port's plain K1 → its
  classifier against the Pallas interpreter's K1 → the JAX module.
- Guards: the package imports neither jax nor robustart_tpu, and the default
  device is CUDA with no CPU fallback.
"""

import filecmp
import json
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from robustart_torch.core.config import Config as PortConfig
from robustart_torch.models import convert
from robustart_torch.ops.noise import fused_noise_normalize_reference
from robustart_torch.solvers import MultiEvalSolver as PortSolver
from robustart_torch.solvers.multi_eval_solver import batch_seed
from robustart_tpu.core.config import Config
from robustart_tpu.models import create_classifier as jax_create_classifier
from robustart_tpu.models.torch_convert import flatten
from robustart_tpu.ops.pallas_noise import fused_noise_normalize as jax_k1
from robustart_tpu.solvers import MultiEvalSolver as JaxSolver
from tests.test_torch_port_resnet import numpy_init


def _slices(root):
    rng = np.random.default_rng(0)
    all_meta = {}
    for corr in ("gaussian_noise", "fog"):
        all_meta[corr] = {}
        for sev in ("1", "2"):
            d = root / "data" / corr / sev
            d.mkdir(parents=True)
            meta = d / "meta.txt"
            with meta.open("w") as f:
                for i in range(6):
                    arr = rng.integers(0, 255, (40, 40, 3), np.uint8)
                    Image.fromarray(arr).save(d / f"{i}.png")
                    f.write(f"{i}.png {i % 10}\n")
            all_meta[corr][sev] = {"root_dir": str(d), "meta_file": str(meta)}
    all_json = root / "all.json"
    all_json.write_text(json.dumps(all_meta))
    return all_json


def _cfg(results, test):
    return {
        "model": {"type": "resnet18", "kwargs": {"num_classes": 10}},
        "seed": 0,
        "data": {
            "batch_size": 4, "num_workers": 2, "input_size": 32,
            "test_resize": 36, "read_from": test.pop("read_from", "fs"),
            "fake_size": 10, "fake_num_classes": 10,
            "test": {
                "sampler": {"type": "distributed"},
                "evaluator": {"type": "imagenetc", "kwargs": {"topk": [1, 5]}},
                **test,
            },
        },
        "saver": {"results_dir": str(results)},
    }


def _scores(path):
    return np.array([json.loads(line)["score"] for line in open(path)])


def test_precomputed_matches_jax_solver(tmp_path, monkeypatch):
    test = {"meta_file": str(_slices(tmp_path)), "transforms": {"type": "ONECROP"},
            "corruptions": ["gaussian_noise", "fog"], "severities": [1, 2]}
    numpy_init(monkeypatch)
    jax_solver = JaxSolver(Config(_cfg(tmp_path / "jax", dict(test))))
    jax_solver.build_model(seed=0)
    jax_summary = jax_solver.evaluate()

    port = PortSolver(PortConfig(_cfg(tmp_path / "port", dict(test))), device="cpu")
    port.build_model(seed=0)
    flat = {k: np.asarray(v) for k, v in flatten(jax_solver.classifier.variables).items()}
    port.classifier.model.load_state_dict(convert.state_dict_from_flax(flat))
    port_summary = port.evaluate()

    assert port_summary == jax_summary
    for corr in ("gaussian_noise", "fog"):
        for sev in ("1", "2"):
            a = _scores(tmp_path / "jax" / corr / sev / "results.txt.all")
            b = _scores(tmp_path / "port" / corr / sev / "results.txt.all")
            assert a.shape == b.shape == (6, 10)
            assert np.abs(a - b).max() <= 1e-4 * np.abs(a).max()


def test_online_fused_equals_per_severity(tmp_path):
    def run(name, fuse):
        test = {"read_from": "fake", "imagenet_c_online": True,
                "fuse_severities": fuse, "transforms": {"type": "JUSTNORM"},
                "corruptions": ["gaussian_noise", "shot_noise", "speckle_noise"],
                "severities": [1, 3], "limit_samples": 9}
        return PortSolver(PortConfig(_cfg(tmp_path / name, test)), device="cpu").evaluate()

    fused, split = run("fused", True), run("split", False)
    assert fused == split and fused["mCE"] is not None
    for corr in ("gaussian_noise", "shot_noise", "speckle_noise"):
        for sev in ("1", "3"):
            a = tmp_path / "fused" / corr / sev / "results.txt.all"
            assert len(a.read_text().splitlines()) == 9
            assert (tmp_path / "fused" / corr / sev / "metric").exists()
            assert filecmp.cmp(a, tmp_path / "split" / corr / sev / "results.txt.all",
                               shallow=False)
    assert (tmp_path / "fused" / "summary.json").exists()


def test_online_refuses_unported_corruption(tmp_path):
    """Every corruption is ported; a name outside CORRUPTION_ORDER is
    refused up front, before the first corruption's batches."""
    test = {"read_from": "fake", "imagenet_c_online": True,
            "corruptions": ["gaussian_noise", "fogg"], "severities": [1]}
    solver = PortSolver(PortConfig(_cfg(tmp_path, test)), device="cpu")
    with pytest.raises(ValueError, match="unknown corruptions"):
        solver.evaluate()
    assert not (tmp_path / "gaussian_noise").exists()


def test_online_chain_matches_jax_with_zero_draws(monkeypatch):
    numpy_init(monkeypatch)
    clf = jax_create_classifier("resnet18", rng=0, input_size=32, num_classes=10)
    port = PortSolver(PortConfig(_cfg("unused", {})), device="cpu").build_model()
    flat = {k: np.asarray(v) for k, v in flatten(clf.variables).items()}
    port.model.load_state_dict(convert.state_dict_from_flax(flat))
    imgs = np.random.default_rng(3).integers(0, 256, (2, 32, 32, 3), np.uint8)
    for noise, sigma in (("gaussian_noise", 0.08), ("impulse_noise", 0.03)):
        x = jax_k1(imgs, 0, noise=noise, sigma=sigma, mean=clf.mean, std=clf.std,
                   out_dtype=jnp.float32, interpret=True)
        ref = np.asarray(clf.module.apply(clf.variables, x, train=False))
        xp = fused_noise_normalize_reference(
            torch.from_numpy(imgs), 0, noise=noise, sigma=sigma, mean=port.mean,
            std=port.std, out_dtype=torch.float32, bits=0,
        )
        with torch.no_grad():
            got = port.forward_normalized(xp).numpy()
        assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()


def test_batch_seeds_are_distinct_32_bit_keys():
    seeds = {batch_seed(0, s, b) for s in range(1, 6) for b in range(200)}
    assert len(seeds) == 1000
    assert all(0 <= s <= 0xFFFFFFFF for s in seeds)
    assert batch_seed(0, 1, 0) == batch_seed(0, 1, 0) != batch_seed(1, 1, 0)


def test_port_imports_no_jax():
    code = (
        "import sys, importlib, pkgutil, robustart_torch\n"
        "for m in pkgutil.walk_packages(robustart_torch.__path__, 'robustart_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'robustart_tpu', 'flax')]\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('robustart_torch.')]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout) >= 20


def test_default_device_is_cuda_without_fallback(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without CUDA")
    cfg = PortConfig(_cfg(tmp_path, {"read_from": "fake"}))
    with pytest.raises(RuntimeError, match="cuda"):
        PortSolver(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        PortSolver(cfg, device="cuda:0")
