"""The port's ``cls_solver --evaluate`` over an ``eval_list`` against the JAX
package's ``ClsSolver``.

Three zoo names at their native 224² on the fake backend: the JAX solver
draws each model's variables from numpy (``numpy_init``); the port's
``eval_list`` names the same variables, carried across by
``robustart_torch.models.convert`` into a torch checkpoint, as each entry's
``saver.pretrain.path`` (the only difference between the two configs). The
per-entry top-1 and top-5 are equal and the logits within 1e-4·max|logit|;
RepVGG evaluates its deploy form in both. The port's ``iter_eval_list`` gives the JAX package's model and input
sizes for the shipped eval lists (efficientnet_b3 at 300, swin_base_384 at
384), and training a family whose train mode is not ported is refused.
"""

import tests.torch_port_threads  # noqa: F401  (before any torch work)
import json
import os
import time

import numpy as np
import pytest
import torch
import yaml

from robustart_torch.core.config import iter_eval_list as port_iter_eval_list
from robustart_torch.core.config import load_config as port_load_config
from robustart_torch.models import convert
from robustart_torch.solvers import cls_solver as port_cls
from robustart_tpu.core.config import Config
from robustart_tpu.core.config import iter_eval_list as jax_iter_eval_list
from robustart_tpu.core.config import load_config as jax_load_config
from robustart_tpu.models.torch_convert import flatten
from robustart_tpu.solvers.cls_solver import ClsSolver as JaxClsSolver
from tests.test_torch_port_resnet import numpy_init

NAMES = ["mobilenet_v3_small_x0_35", "shufflenet_v2_x0_5", "repvgg_A0"]


def _cfg(root, eval_list):
    return {
        "model": {"type": "resnet18", "kwargs": {"num_classes": 10}},
        "seed": 0,
        "data": {"batch_size": 4, "num_workers": 2, "input_size": 224, "test_resize": 256,
                 "read_from": "fake", "fake_size": 6, "fake_num_classes": 10,
                 "test": {"transforms": {"type": "ONECROP"}, "limit_samples": 5}},
        "saver": {"results_path": str(root / "results.txt.all")},
        "eval_list": eval_list,
    }


def test_eval_list_matches_jax(tmp_path, monkeypatch):
    numpy_init(monkeypatch)
    jax_cfg = Config(_cfg(tmp_path / "jax", NAMES))
    want, ckpts = [], []
    for i, sub in enumerate(jax_iter_eval_list(jax_cfg)):
        sub.saver.results_path = str(tmp_path / "jax" / f"{i}.txt")
        solver = JaxClsSolver(sub, evaluate_only=True)
        solver.build_model(seed=0)
        flat = {k: np.asarray(v) for k, v in flatten(solver.classifier.variables).items()}
        ckpts.append(tmp_path / f"{NAMES[i]}.pth")
        torch.save({"state_dict": convert.state_dict_from_flax(flat)}, ckpts[-1])
        want.append(solver.evaluate())
        assert type(solver.classifier.module).__name__ != "RepVGG" or solver.classifier.module.deploy

    entries = [{"model": {"type": n}, "saver": {"pretrain": {"path": str(c)},
                                                "results_path": str(tmp_path / "port" / f"{n}.txt")}}
               for n, c in zip(NAMES, ckpts)]
    path = tmp_path / "port.yaml"
    path.write_text(yaml.safe_dump(_cfg(tmp_path / "port", entries)))
    got = port_cls.main(["--config", str(path), "--evaluate", "--device", "cpu"])
    assert got == want
    assert all(set(m) == {"top1", "top5"} for m in got)
    for i, name in enumerate(NAMES):
        a = _scores(tmp_path / "jax" / f"{i}.txt")
        b = _scores(tmp_path / "port" / f"{name}.txt")
        assert a.shape == b.shape == (5, 10)
        assert np.abs(a - b).max() <= 1e-4 * np.abs(a).max()


def _scores(path):
    return np.array([json.loads(line)["score"] for line in open(path)])


def test_eval_list_solvers_write_their_own_results(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg = port_load_config(_write(tmp_path, _cfg(tmp_path, ["googlenet", "repvgg_A0"]),
                                  drop=("saver",)))
    solvers = list(port_cls.eval_list_solvers(cfg, "cpu"))
    assert [s.cfg.saver.results_path for s in solvers] == [
        "results/eval_0/results.txt.all", "results/eval_1/results.txt.all"]
    out = solvers[1].evaluate()
    assert solvers[1].classifier.model.deploy and set(out) == {"top1", "top5"}
    assert os.path.exists("results/eval_1/results.txt.all")
    assert solvers[1].loop_stats["images"] == 5


def _write(tmp_path, cfg, drop=()):
    path = tmp_path / "c.yaml"
    path.write_text(yaml.safe_dump({k: v for k, v in cfg.items() if k not in drop}))
    return str(path)


@pytest.mark.parametrize("config", ["exprs/exp/swin_2/config.yaml", "exprs/exp/swin/config.yaml"])
def test_iter_eval_list_matches_jax(config):
    want = [(s.model.type, s.data.input_size, s.data.test_resize)
            for s in jax_iter_eval_list(jax_load_config(config))]
    got = [(s.model.type, s.data.input_size, s.data.test_resize)
           for s in port_iter_eval_list(port_load_config(config))]
    assert got == want
    sizes = dict((t, (i, r)) for t, i, r in got)
    assert sizes.get("efficientnet_b3", (300, 343)) == (300, 343)
    assert sizes.get("swin_base_384", (384, 439)) == (384, 439)


def test_training_is_refused(tmp_path):
    """Training is ported for the ResNet family and ViT/DeiT; another
    family's train mode is refused with the ROADMAP item."""
    cfg = _cfg(tmp_path, [])
    cfg.pop("eval_list")
    cfg["model"] = {"type": "googlenet", "kwargs": {"num_classes": 10}}
    path = tmp_path / "c.yaml"
    path.write_text(yaml.safe_dump(cfg))
    with pytest.raises(NotImplementedError, match="ROADMAP.md, modules to port: Training"):
        port_cls.main(["--config", str(path), "--device", "cpu"])
    solver = port_cls.ClsSolver(str(path), device="cpu")
    with pytest.raises(NotImplementedError, match="Training"):
        solver.train()


def test_newest_checkpoint(tmp_path):
    for i, name in enumerate(("a.pth", "b.pt")):
        (tmp_path / name).write_bytes(b"")
        os.utime(tmp_path / name, (time.time() + i, time.time() + i))
    assert port_cls.newest_checkpoint(str(tmp_path)).endswith("b.pt")
    # the JAX package's own msgpack saves come first, as in its newest_checkpoint
    (tmp_path / "c.msgpack").write_bytes(b"")
    os.utime(tmp_path / "c.msgpack", (time.time() - 10, time.time() - 10))
    assert port_cls.newest_checkpoint(str(tmp_path)).endswith("c.msgpack")
