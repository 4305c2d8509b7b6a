"""The port's training solver against the JAX package's ``ClsSolver.train``.

Two tiny models registered under one name in both packages
(``tests/train_port_helpers.py``): a ResNet of one basic block a stage and a
ViT of two blocks at width 128 in 2 heads (K6's and K7's plain versions in
train mode). Each recipe trains 3 steps, one an epoch, on 8 fake images
with a ``Step`` schedule stopped by ``max_iter``, from the same numpy
variables (``numpy_init`` on the JAX side, a torch checkpoint of them as
the port's ``saver.pretrain.path``); one JAX run a recipe is shared by the
module and leaves its msgpack state after every step:

- SGD (nesterov, weight decay) + label smoothing + mixup 0.2 / cutmix 1.0 +
  EMA on the ResNet. The port is fed the draws the jitted JAX step made
  (``jax_draws``: ``fold_in(key, step)`` → ``split(3)`` → ``split(5)``,
  recorded in the step by a ``jax.debug.callback``: a separately jitted
  Beta draw can differ by an ulp);
- AdamW + ``no_wd`` + in-step PGD + EMA on the ViT. The port is fed the JAX
  step's adversarial image, recorded the same way (the attack alone is held
  in ``test_torch_port_train_parts.py``).

Each step is held from JAX's own state before it: step 1 from the common
start, steps 2 and 3 recovered from JAX's msgpack of the step before
(``--recover``, the port's JAX-checkpoint path): the loss within 1e-5 rel;
parameters, BatchNorm statistics, EMA and the optimizer's moments after it
within 1e-5·max|ref| a leaf. A ReLU network's gradient is not continuous:
one max-pool window whose two largest values differ by an ulp routes a
position's gradient elsewhere (at this size 0.7% of the stem's weight
gradient), so two programs whose sums differ by an ulp part at such a
window, and from there each run is its own; the steps are therefore held
one at a time. The ViT (GELU, no kink) is also held over 3 uninterrupted
steps (the losses). Under AdamW an element whose exact gradient is zero
(the key third of a packed q/k/v bias: softmax ignores a shift shared by all
keys) or roundoff moves by Adam's normalized roundoff, up to a few lr a
step with the roundoff's sign, in either package: the elements whose
reference first moment is roundoff (≤ 1e-6 of the leaf's largest) are held
to that bound. The same ViT recipe without the attack runs in bf16, each
step from JAX's state, within 3e-2 (loss). ``evaluate`` on
the JAX run's last msgpack with ``model.use_ema`` auto, true and false is
held against the JAX evaluation, and the CLIs run end to end. The ViT
recipe's tests are in ``test_torch_port_train_vit.py`` (its JAX runs' own
minute), on this file's helpers.
"""

import tests.torch_port_threads  # noqa: F401  (before any torch work)
import json

import jax
import numpy as np
import pytest
import torch
import yaml

from robustart_torch.attacks import gradient as port_gradient
from robustart_torch.solvers import adv_cls_solver_train_pgd as port_adv
from robustart_torch.solvers import adv_cls_solver_train_pgd_new as port_adv_new
from robustart_torch.solvers import cls_solver as port_cls
from robustart_torch.core.config import Config as PortConfig
from robustart_tpu import attacks as jax_attacks
from robustart_tpu.core.config import Config
from robustart_tpu.models import registry as jax_registry
from robustart_tpu.models.torch_convert import unflatten
from robustart_tpu.solvers.cls_solver import ClsSolver as JaxClsSolver
from tests.test_torch_port_resnet import numpy_init, numpy_variables
from robustart_tpu.solvers import cls_solver as jax_cls
from tests.train_port_helpers import (CLASSES, SIZE, as_mix_draws, jax_draws, recipe,
                                      register_tiny, save_torch, torch_state)

RECIPES = ["sgd_mix"]  # test_torch_port_train_vit.py: "adamw_pgd" and bf16


@pytest.fixture(scope="module")
def patched():
    with pytest.MonkeyPatch.context() as mp:
        register_tiny(mp)
        numpy_init(mp)
        yield mp


def _history(root):
    return [json.loads(line) for line in open(root / "ckpt" / "train_history.jsonl")]


def run_jax_recipes(tmp_path_factory, recipes) -> dict:
    """One JAX training run a (recipe, dtype): its per-step history, the
    draws and adversarial images its steps made, and its checkpoint
    directory."""
    runs = {}
    for kind, dtype in recipes:
        root = tmp_path_factory.mktemp(f"jax_{kind}")
        adv, mix = [], []
        with pytest.MonkeyPatch.context() as mp:
            real = jax_attacks.ATTACKS["pgd_linf"]
            real_mix = jax_cls.mixup_cutmix

            def recording(*args, **kwargs):
                out = real(*args, **kwargs)
                jax.debug.callback(lambda v: adv.append(np.array(v)), out)
                return out

            def recording_mix(key, images, soft, mixup_alpha, cutmix_alpha):
                draws = jax_draws(key, images.shape[0], images.shape[1], images.shape[2],
                                  mixup_alpha, cutmix_alpha)
                jax.debug.callback(lambda *v: mix.append([np.array(a) for a in v]), *draws)
                return real_mix(key, images, soft, mixup_alpha, cutmix_alpha)

            mp.setitem(jax_attacks.ATTACKS, "pgd_linf", recording)
            mp.setattr(jax_cls, "mixup_cutmix", recording_mix)
            solver = JaxClsSolver(Config(recipe(kind, root, dtype)))
            solver.train()
        runs[(kind, dtype)] = {"root": root, "history": _history(root), "adv": adv, "mix": mix,
                               "model": recipe(kind, root)["model"]["type"]}
    return runs


@pytest.fixture(scope="module")
def jax_runs(patched, tmp_path_factory):
    return run_jax_recipes(tmp_path_factory, [(kind, None) for kind in RECIPES])


def _port_config(kind, root, dtype=None):
    root.mkdir(parents=True, exist_ok=True)
    cfg = recipe(kind, root, dtype)
    module = jax_registry.get_model(cfg["model"]["type"], num_classes=CLASSES)
    init = unflatten(numpy_variables(module, SIZE, 0))
    cfg["saver"]["pretrain"] = {"path": save_torch(init, cfg["model"]["type"],
                                                   root / "init.pth")}
    return cfg


def _inject(mp, run, kind):
    """Feed the port the JAX run's draws (mixup/cutmix) and adversarial
    images, keyed by the step the port's solver is taking."""
    at = {}
    real_gen = port_cls.step_generator

    def step_generator(device, seed, step):
        at["step"] = step
        return real_gen(device, seed, step)

    def draw_mix(gen, batch, h, w, mixup, cutmix):
        if mixup <= 0 and cutmix <= 0:
            return None
        return as_mix_draws(run["mix"][at["step"]])

    def replayed_attack(model, x, labels, generator=None, **kw):
        return torch.from_numpy(run["adv"][at["step"]]).to(x.device)

    mp.setattr(port_cls, "step_generator", step_generator)
    mp.setattr(port_cls, "draw_mix", draw_mix)
    mp.setitem(port_gradient.ATTACKS, "pgd_linf", replayed_attack)


def _port_train(kind, root, run, dtype=None, recover=None, max_iter=3):
    cfg = _port_config(kind, root, dtype)
    cfg["lr_scheduler"]["kwargs"]["max_iter"] = max_iter
    with pytest.MonkeyPatch.context() as mp:
        _inject(mp, run, kind)
        solver = port_cls.ClsSolver(PortConfig(cfg), device="cpu")
        solver.train(recover=recover)
    return solver


def _jax_state(run, step):
    """JAX's training state after ``step`` steps, from its msgpack."""
    from flax import serialization

    with open(run["root"] / "ckpt" / f"ckpt_e{step}.msgpack", "rb") as f:
        return serialization.msgpack_restore(f.read())["extra"]["state"]


def _check_leaf(got, want, name, noise=None, bound=0.0):
    """A parameter-shaped leaf within 1e-5·max|ref|, except the elements in
    ``noise``: where the reference's Adam first moment is roundoff (at most
    1e-6 of the leaf's largest), Adam's update is roundoff normalized to
    about ±lr in either package, and those are held to ``bound``."""
    got = got.detach().float().numpy()
    want = want.numpy().reshape(got.shape)
    diff = np.abs(got - want)
    if noise is not None:
        assert diff[noise].max(initial=0.0) <= bound, name
        diff = np.where(noise, 0.0, diff)
    assert diff.max() <= 1e-5 * max(np.abs(want).max(), 1e-30), name


def _check_state(solver, state, model_name, steps, lrs):
    moments = port_cls._opt_moments(state["opt_state"], {})
    assert moments.pop("count") == solver.opt_state["count"] == steps
    assert set(moments) == set(solver.opt_state) - {"count"}
    moments = {key: torch_state({"params": tree}, model_name) for key, tree in moments.items()}
    noise = {}
    if "mu" in moments:
        for k, mu in moments["mu"].items():
            mu = np.abs(mu.numpy())
            noise[k] = mu <= 1e-6 * mu.max()
    # two Adam updates of at most (1−β1)/√(1−β2) ≈ 3.2 lr a step apart
    bound = 2 * 3.2 * sum(lrs)
    sd = solver.classifier.model.state_dict()
    want = torch_state({"params": state["params"], "batch_stats": state["batch_stats"]},
                       model_name)
    for k, v in want.items():
        if not k.endswith("num_batches_tracked"):
            _check_leaf(sd[k], v, k, noise.get(k), bound)
    for k, v in torch_state({"params": state["ema_params"]}, model_name).items():
        _check_leaf(solver.ema[k], v, f"ema {k}", noise.get(k), bound)
    for key, tree in moments.items():
        for k, v in tree.items():
            _check_leaf(solver.opt_state[key][k], v, f"{key} {k}")


@pytest.mark.parametrize("kind", RECIPES)
def test_train_steps_match_jax(kind, jax_runs, tmp_path):
    check_train_steps(kind, jax_runs, tmp_path)


def check_train_steps(kind, jax_runs, tmp_path):
    """Each step from JAX's state before it (step 1 from the common start,
    steps 2 and 3 through ``--recover`` of JAX's msgpack)."""
    run = jax_runs[(kind, None)]
    for step in (1, 2, 3):
        root = tmp_path / f"step{step}"
        recover = None if step == 1 else str(run["root"] / "ckpt" / f"ckpt_e{step - 1}.msgpack")
        solver = _port_train(kind, root, run, recover=recover, max_iter=step)
        (got,) = _history(root)
        want = run["history"][step - 1]
        assert (got["step"], got["epoch"]) == (want["step"], want["epoch"]) == (step, step - 1)
        assert got["lr"] == pytest.approx(want["lr"], rel=1e-7)
        assert got["loss"] == pytest.approx(want["loss"], rel=1e-5), (step, got, want)
        assert got["acc"] == want["acc"]
        _check_state(solver, _jax_state(run, step), run["model"], step,
                     [h["lr"] for h in run["history"][:step]])
    assert len(run["adv"]) == (3 if kind == "adamw_pgd" else 0)
    assert len(run["mix"]) == 3


def _scores(path):
    return np.array([json.loads(line)["score"] for line in open(path)])


@pytest.mark.parametrize("use_ema", [None, True, False])
def test_evaluate_jax_msgpack(use_ema, jax_runs, tmp_path):
    run = jax_runs[("sgd_mix", None)]
    ckpt = str(run["root"] / "ckpt" / "ckpt_e3.msgpack")
    jcfg = recipe("sgd_mix", tmp_path / "jax")
    jcfg["model"]["use_ema"] = use_ema
    want = JaxClsSolver(Config(jcfg), evaluate_only=True).evaluate(ckpt_path=ckpt)
    pcfg = recipe("sgd_mix", tmp_path / "port")
    pcfg["model"]["use_ema"] = use_ema
    got = port_cls.ClsSolver(PortConfig(pcfg), evaluate_only=True, device="cpu").evaluate(
        ckpt_path=str(run["root"] / "ckpt"))  # the newest: ckpt_e3.msgpack
    a = _scores(tmp_path / "jax" / "results.txt.all")
    b = _scores(tmp_path / "port" / "results.txt.all")
    assert a.shape == b.shape == (8, CLASSES)
    assert np.abs(a - b).max() <= 1e-4 * np.abs(a).max()
    assert got == want


def test_cli_trains_then_evaluates(patched, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    paths = []
    for kind in ("sgd_mix", "adamw_pgd"):
        cfg = recipe(kind, tmp_path / kind)
        cfg["lr_scheduler"]["kwargs"]["max_iter"] = 2
        cfg["saver"]["save_many"] = False
        paths.append(tmp_path / f"{kind}.yaml")
        paths[-1].write_text(yaml.safe_dump(cfg))
    out = port_cls.main(["--config", str(paths[0]), "--device", "cpu"])
    assert set(out) == {"top1", "top5"}
    assert (tmp_path / "sgd_mix" / "ckpt" / "ckpt.pth.tar").exists()
    for entry in (port_adv.main, port_adv_new.main):
        out = entry(["--config", str(paths[1]), "--device", "cpu"])
        assert set(out) == {"top1", "top5"}
    # the port's own checkpoint: evaluate it, then recover from it
    ckpt = str(tmp_path / "adamw_pgd" / "ckpt" / "ckpt.pth.tar")
    out = port_adv.main(["--config", str(paths[1]), "--evaluate", "--ckpt-filePath", ckpt,
                         "--device", "cpu"])
    assert set(out) == {"top1", "top5"}
