"""The port's training solver against the JAX package's on the ViT recipe
(``test_torch_port_train.py`` says how, and does the ResNet's): AdamW +
``no_wd`` + in-step PGD + EMA on a ViT of two blocks at width 128 in 2
heads (K6's and K7's plain versions in train mode), fed the JAX step's
adversarial image; each step from JAX's state before it, the 3 steps
uninterrupted (the losses), and the recipe without the attack in bf16 on
float32 masters (loss within 3e-2). A file of its own: the JAX runs of
both recipes' compiles take most of a minute together."""

import tests.torch_port_threads  # noqa: F401  (before any torch work)
import pytest
import torch

from tests.test_torch_port_train import (_history, _port_train, check_train_steps,  # noqa: F401
                                         patched, run_jax_recipes)

RECIPES = ["adamw_pgd"]


@pytest.fixture(scope="module")
def jax_runs(patched, tmp_path_factory):
    return run_jax_recipes(tmp_path_factory, [("adamw_pgd", None), ("adamw", "bf16")])


@pytest.mark.parametrize("kind", RECIPES)
def test_train_steps_match_jax(kind, jax_runs, tmp_path):
    check_train_steps(kind, jax_runs, tmp_path)


def test_vit_three_steps_match_jax(jax_runs, tmp_path):
    """The ViT recipe over 3 uninterrupted steps: the loss of each within
    1e-5 rel. (The state is held step by step above: over several Adam
    steps the two runs' small differences are normalized up, element by
    element, wherever a gradient is small.)"""
    run = jax_runs[("adamw_pgd", None)]
    _port_train("adamw_pgd", tmp_path, run)
    got = _history(tmp_path)
    assert [h["step"] for h in got] == [h["step"] for h in run["history"]] == [1, 2, 3]
    for g, w in zip(got, run["history"]):
        assert g["loss"] == pytest.approx(w["loss"], rel=1e-5), (g, w)
        assert g["acc"] == w["acc"]


def test_bf16_train_steps_match_jax(jax_runs, tmp_path):
    """The ViT recipe in bf16 on float32 master weights, each step from
    JAX's state before it: the loss within 3e-2."""
    run = jax_runs[("adamw", "bf16")]
    for step in (1, 2, 3):
        root = tmp_path / f"step{step}"
        recover = None if step == 1 else str(run["root"] / "ckpt" / f"ckpt_e{step - 1}.msgpack")
        solver = _port_train("adamw", root, run, dtype="bf16", recover=recover, max_iter=step)
        assert solver.classifier.model.dtype == torch.bfloat16
        assert all(p.dtype == torch.float32 for p in solver.params.values())
        (got,) = _history(root)
        want = run["history"][step - 1]
        assert got["loss"] == pytest.approx(want["loss"], rel=3e-2), (step, got, want)
