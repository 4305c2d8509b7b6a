"""White-box gradient attacks: FGSM, PGD-{Linf,L2,L1}, MIM.

Counterpart of ``robustart_tpu/attacks/gradient.py`` (the reference's
foolbox PGD/FGSM, ART PGD-L1 and local MIM wrappers). Every attack is a
function

    attack(model, x01, labels, generator=None, *, start=None, **hyper) -> x_adv

on NHWC images in [0, 1] (float32) and integer labels, where ``model`` maps
such images to float32 logits (a ``Classifier``, which normalizes inside).
The step loop is a Python loop of one forward and one backward a step,
through the hand kernels' forwards and their plain backwards
(``ops/plain_grad.py``) on the card. Defaults are the reference registry's.

- ``fgsm``: one signed-gradient step of size eps, clip to [0, 1].
- ``pgd_linf``: uniform random start in the eps box, ``steps`` signed steps
  of ``rel_stepsize·eps``, projection on the box, then [0, 1].
- ``pgd_l2``: random start uniform in the L2 ball, normalized-gradient
  steps, L2-ball projection, [0, 1].
- ``pgd_l1``: ART's ``ProjectedGradientDescentPyTorch(norm=1)``: random start
  in the L1 ball, L1-normalized gradient steps, the rescale projection onto
  the L1 ball, [0, 1].
- ``mim_linf``: mean-|g|-normalized gradient, momentum, signed steps, the
  box; the random start is not clipped to [0, 1] before the first step, as
  the reference (and the JAX package) does.

Random starts come from ``generator``, a ``torch.Generator`` on x's device
(:func:`uniform_box`, :func:`uniform_l2_ball`, :func:`uniform_l1_ball`,
the JAX package's samplers); ``start`` injects the start's perturbation
instead (the tests feed the JAX package's draw). The loss is the mean
cross-entropy in float32 and the gradient reaching the image is float32;
TF32 is off for the forward and the backward.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from robustart_torch.models.layers import full_f32

Model = Callable[[torch.Tensor], torch.Tensor]


def _ce_grad(model: Model, x: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """d/dx of the mean cross-entropy of ``model(x)`` at ``labels``: one
    forward and one backward. The model's parameters are frozen
    (``requires_grad_(False)``): the attack needs the image's gradient
    alone."""
    if isinstance(model, nn.Module):
        model.requires_grad_(False)
    x = x.detach().requires_grad_(True)
    with torch.enable_grad(), full_f32():
        loss = F.cross_entropy(model(x).float(), labels)
        (grad,) = torch.autograd.grad(loss, x)
    return grad


def _loss_grad(model: Model, x: torch.Tensor, loss_fn: Callable[[torch.Tensor], torch.Tensor],
               eot_iter: int = 1) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(per-sample loss, d/dx of its sum, float32 logits) of ``loss_fn``
    applied to ``model(x).float()``: one forward and one backward, with the
    parameters frozen and TF32 off, as :func:`_ce_grad`. With ``eot_iter`` >
    1 the gradient is the mean of ``eot_iter`` such backwards (expectation
    over transformation, for a model that draws at random in its forward);
    the loss and logits are the first pass's."""
    if isinstance(model, nn.Module):
        model.requires_grad_(False)
    with torch.enable_grad(), full_f32():
        for i in range(eot_iter):
            xi = x.detach().requires_grad_(True)
            logits = model(xi).float()
            per = loss_fn(logits)
            (grad,) = torch.autograd.grad(per.sum(), xi)
            if i == 0:
                loss, total, first_logits = per.detach(), grad, logits.detach()
            else:
                total = total + grad
    return loss, (total / eot_iter if eot_iter > 1 else total), first_logits


def _flat_sum(v: torch.Tensor, reduce=torch.sum) -> torch.Tensor:
    """Per-sample reduction over all non-batch axes, kept for broadcast."""
    return reduce(v, dim=tuple(range(1, v.ndim)), keepdim=True)


def _l2_norm(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return torch.sqrt(_flat_sum(torch.square(v)) + eps)


def _l1_norm(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return _flat_sum(torch.abs(v)) + eps


def _radius(shape, generator: torch.Generator) -> torch.Tensor:
    """U^(1/d) per sample, d the size of one sample."""
    d = 1
    for s in shape[1:]:
        d *= s
    u = torch.rand((shape[0],) + (1,) * (len(shape) - 1), generator=generator,
                   device=generator.device)
    return u ** (1.0 / d)


def uniform_box(shape, eps: float, generator: torch.Generator) -> torch.Tensor:
    """Uniform sample from the box [-eps, eps]^shape."""
    return (torch.rand(shape, generator=generator, device=generator.device) * 2.0 - 1.0) * eps


def uniform_l2_ball(shape, generator: torch.Generator) -> torch.Tensor:
    """Uniform sample from the unit L2 ball per sample (normal direction,
    radius U^(1/d))."""
    direction = torch.randn(shape, generator=generator, device=generator.device)
    return direction / _l2_norm(direction) * _radius(shape, generator)


def uniform_l1_ball(shape, generator: torch.Generator) -> torch.Tensor:
    """Approximately uniform sample from the unit L1 ball per sample (ART's
    ``random_sphere(norm=1)``): Exp(1) magnitudes with random signs,
    normalized by their L1 norm, scaled by U^(1/d)."""
    dev = generator.device
    mag = torch.empty(shape, device=dev).exponential_(generator=generator)
    sign = torch.sign(torch.rand(shape, generator=generator, device=dev) - 0.5)
    v = mag * sign
    return v / _l1_norm(v) * _radius(shape, generator)


def _start(start, draw: Callable[[], torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """The injected start's perturbation, or a fresh draw."""
    if start is None:
        return draw()
    if start.shape != x.shape:
        raise ValueError(f"start must have x's shape {tuple(x.shape)}, got {tuple(start.shape)}")
    return start.to(device=x.device, dtype=x.dtype)


def _generator(generator) -> torch.Generator:
    if generator is None:
        raise ValueError("a random draw needs a torch.Generator on x's device (or the draw "
                         "injected)")
    return generator


def fgsm(model: Model, x: torch.Tensor, labels: torch.Tensor, generator=None, *,
         eps: float = 8 / 255) -> torch.Tensor:
    grad = _ce_grad(model, x, labels)
    return torch.clamp(x + eps * torch.sign(grad), 0.0, 1.0)


def pgd_linf(model: Model, x: torch.Tensor, labels: torch.Tensor, generator=None, *,
             eps: float = 8 / 255, rel_stepsize: float = 3 / 40, steps: int = 20,
             random_start: bool = True, start=None) -> torch.Tensor:
    stepsize = rel_stepsize * eps
    x_adv = x
    if random_start:
        delta = _start(start, lambda: uniform_box(x.shape, eps, _generator(generator)), x)
        x_adv = torch.clamp(x + delta, 0.0, 1.0)
    for _ in range(steps):
        grad = _ce_grad(model, x_adv, labels)
        x_adv = x_adv + stepsize * torch.sign(grad)
        x_adv = torch.clamp(torch.clamp(x_adv, x - eps, x + eps), 0.0, 1.0)
    return x_adv


def pgd_l2(model: Model, x: torch.Tensor, labels: torch.Tensor, generator=None, *,
           eps: float = 8.0, rel_stepsize: float = 3 / 40, steps: int = 20,
           random_start: bool = True, start=None) -> torch.Tensor:
    stepsize = rel_stepsize * eps
    x_adv = x
    if random_start:
        delta = _start(start, lambda: eps * uniform_l2_ball(x.shape, _generator(generator)), x)
        x_adv = torch.clamp(x + delta, 0.0, 1.0)
    for _ in range(steps):
        grad = _ce_grad(model, x_adv, labels)
        x_adv = x_adv + stepsize * (grad / _l2_norm(grad))
        delta = x_adv - x
        x_adv = torch.clamp(x + delta * torch.clamp(eps / _l2_norm(delta), max=1.0), 0.0, 1.0)
    return x_adv


def pgd_l1(model: Model, x: torch.Tensor, labels: torch.Tensor, generator=None, *,
           eps: float = 1600.0, eps_step: float = 120.0, max_iter: int = 20,
           num_random_init: int = 1, input_size: int | None = None,
           batch_size: int | None = None, start=None) -> torch.Tensor:
    """ART-style PGD with L1 gradient normalization and the rescale
    projection (``input_size`` and ``batch_size`` are accepted for the
    reference configs)."""
    del input_size, batch_size
    x_adv = x
    if num_random_init > 0:
        delta = _start(start, lambda: eps * uniform_l1_ball(x.shape, _generator(generator)), x)
        x_adv = torch.clamp(x + delta, 0.0, 1.0)
    for _ in range(max_iter):
        grad = _ce_grad(model, x_adv, labels)
        x_adv = torch.clamp(x_adv + eps_step * (grad / _l1_norm(grad)), 0.0, 1.0)
        delta = x_adv - x
        x_adv = torch.clamp(x + delta * torch.clamp(eps / _l1_norm(delta), max=1.0), 0.0, 1.0)
    return x_adv


def mim_linf(model: Model, x: torch.Tensor, labels: torch.Tensor, generator=None, *,
             eps: float = 8 / 255, num_steps: int = 20, step_size: float = 0.002,
             decay_factor: float = 1.0, start=None) -> torch.Tensor:
    """Momentum iterative FGSM (reference ``Attacks/imfgsm_attack.py:62-93``)."""
    # the reference adds the uniform start WITHOUT clipping to [0, 1]
    x_adv = x + _start(start, lambda: uniform_box(x.shape, eps, _generator(generator)), x)
    momentum = torch.zeros_like(x)
    for _ in range(num_steps):
        grad = _ce_grad(model, x_adv, labels)
        grad = grad / _flat_sum(torch.abs(grad), torch.mean)
        momentum = decay_factor * momentum + grad
        x_adv = x_adv + step_size * torch.sign(momentum)
        x_adv = torch.clamp(x + torch.clamp(x_adv - x, -eps, eps), 0.0, 1.0)
    return x_adv


def clip_l2_norm(cln_img: torch.Tensor, adv_img: torch.Tensor, eps: float) -> torch.Tensor:
    """Clip a perturbation to a global L2 budget (reference attack.py:10-17:
    the norm of the WHOLE tensor, not per sample)."""
    noise = adv_img - cln_img
    norm = torch.sqrt(torch.sum(noise ** 2))
    return torch.where(norm > eps, cln_img + noise * eps / norm, adv_img)


# the reference's attack_list (attack.py:52)
ATTACKS: dict[str, Callable[..., torch.Tensor]] = {
    "fgsm": fgsm,
    "pgd_linf": pgd_linf,
    "pgd_l2": pgd_l2,
    "pgd_l1": pgd_l1,
    "mim_linf": mim_linf,
}
attack_list = ATTACKS


def make_attack_fn(name: str, model: Model, **config) -> Callable[..., torch.Tensor]:
    """Bind attack ``name`` to ``model`` and its hyperparameters: returns
    ``fn(x01, labels, generator=None, start=None) -> x_adv``."""
    attack = ATTACKS[name]

    def fn(x, labels, generator=None, start=None):
        kw = {} if start is None else {"start": start}
        return attack(model, x, labels, generator, **config, **kw)

    return fn
