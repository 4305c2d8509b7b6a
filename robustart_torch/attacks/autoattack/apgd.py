"""Auto-PGD (APGD): step-size-adaptive PGD with the CE and DLR losses,
targeted or not, in Linf, L2 and L1.

Counterpart of ``robustart_tpu/attacks/autoattack/apgd.py`` (Croce & Hein,
ICML 2020; L1: "Mind the box", ICML 2021). The iteration loop is a Python
loop over device tensors: the per-sample state (step size, best point,
halving counters) is updated by masked tensor arithmetic, the checkpoint
schedule is a host constant, and nothing inside the loop reads a device
value on the host.

An iteration of Linf/L2 is one forward and backward at the current point
and one forward at the next; an L1 iteration is one forward and backward.
The losses are computed in float32 from the model's logits (``.float()``),
so a bf16 model's ties among its top logits do not reach DLR's
denominator in bf16.

Random starts come from ``generator`` (a ``torch.Generator`` on x's
device); ``x_init`` injects the start instead (projected into the ball),
which is also the warm start of :func:`apgd_attack_largereps`.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from robustart_torch.attacks.gradient import Model, _generator, _loss_grad
from robustart_torch.models.layers import full_f32


def checkpoint_mask(n_iter: int) -> np.ndarray:
    """Boolean mask, True at the checkpoint iterations w_j (p_0 = 0, p_1 =
    0.22, p_{j+1} = p_j + max(p_j - p_{j-1} - 0.03, 0.06))."""
    p = [0.0, 0.22]
    while p[-1] < 1.0:
        p.append(p[-1] + max(p[-1] - p[-2] - 0.03, 0.06))
    ws = sorted({int(np.ceil(pi * n_iter)) for pi in p if pi <= 1.0})
    mask = np.zeros(n_iter + 1, bool)
    for w in ws:
        if 0 < w <= n_iter:
            mask[w] = True
    return mask


def _tail(v: torch.Tensor, ndim: int) -> torch.Tensor:
    """A per-sample vector shaped to broadcast over an image batch."""
    return v.reshape((-1,) + (1,) * (ndim - 1))


def _l2n(v: torch.Tensor) -> torch.Tensor:
    return _tail(torch.sqrt(torch.sum(v.flatten(1) ** 2, 1) + 1e-12), v.ndim)


def _gather(v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(v, 1, idx[:, None])[:, 0]


def ce_loss_per_sample(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return -_gather(F.log_softmax(logits.float(), dim=1), labels)


def dlr_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Untargeted DLR: -(z_y - max_{i≠y} z_i) / (z_p1 - z_p3)."""
    logits = logits.float()
    z_sorted = torch.sort(logits, dim=1, descending=True).values
    z_y = _gather(logits, labels)
    z_other = torch.where(z_sorted[:, 0] == z_y, z_sorted[:, 1], z_sorted[:, 0])
    return -(z_y - z_other) / (z_sorted[:, 0] - z_sorted[:, 2] + 1e-12)


def dlr_loss_targeted(logits: torch.Tensor, labels: torch.Tensor,
                      targets: torch.Tensor) -> torch.Tensor:
    """Targeted DLR: -(z_y - z_t) / (z_p1 - (z_p3 + z_p4) / 2)."""
    logits = logits.float()
    z_sorted = torch.sort(logits, dim=1, descending=True).values
    z_y, z_t = _gather(logits, labels), _gather(logits, targets)
    return -(z_y - z_t) / (z_sorted[:, 0] - (z_sorted[:, 2] + z_sorted[:, 3]) / 2 + 1e-12)


def l1_ball_box_projection(x_orig: torch.Tensor, x_adv: torch.Tensor, eps: float,
                           iters: int = 30) -> torch.Tensor:
    """Project ``x_adv`` onto {z : ||z - x_orig||_1 <= eps} ∩ [0, 1]^d: the
    soft threshold z(λ) = clip(x_orig + sign(δ)·max(|δ| - λ, 0)) of the
    box-feasible direction has an L1 distance decreasing in λ, so λ is
    found by ``iters`` bisection steps on [0, max|δ|]."""
    d_box = torch.clamp(x_adv, 0.0, 1.0) - x_orig
    mag = torch.abs(d_box)
    flat_mag = mag.flatten(1)
    lo = torch.zeros(x_adv.shape[0], device=x_adv.device)
    hi = flat_mag.amax(1) + 1e-6
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        ok = torch.clamp(flat_mag - mid[:, None], min=0.0).sum(1) <= eps
        lo, hi = torch.where(ok, lo, mid), torch.where(ok, mid, hi)
    lam = _tail(hi, x_adv.ndim)
    need = _tail(flat_mag.sum(1) > eps, x_adv.ndim)
    delta = torch.where(need, torch.sign(d_box) * torch.clamp(mag - lam, min=0.0), d_box)
    return torch.clamp(x_orig + delta, 0.0, 1.0)


def _l0_norm(v: torch.Tensor) -> torch.Tensor:
    """Per-sample count of nonzero coordinates."""
    return (v.flatten(1) != 0).sum(1).float()


def _project(x_adv: torch.Tensor, x_orig: torch.Tensor, eps: float, norm: str) -> torch.Tensor:
    x_adv = torch.clamp(x_adv, 0.0, 1.0)
    if norm == "Linf":
        return torch.minimum(torch.maximum(x_adv, x_orig - eps), x_orig + eps)
    if norm == "L1":
        return l1_ball_box_projection(x_orig, x_adv, eps)
    delta = x_adv - x_orig
    return torch.clamp(x_orig + delta * torch.clamp(eps / _l2n(delta), max=1.0), 0.0, 1.0)


def loss_function(loss: str, labels: torch.Tensor, targets: torch.Tensor | None = None):
    """The per-sample loss of logits that the attack maximizes: ``'ce'``,
    ``'dlr'`` or ``'dlr-targeted'`` (which needs ``targets``)."""
    if loss == "ce":
        return lambda lg: ce_loss_per_sample(lg, labels)
    if loss == "dlr":
        return lambda lg: dlr_loss(lg, labels)
    if loss == "dlr-targeted":
        if targets is None:
            raise ValueError("loss 'dlr-targeted' needs targets")
        return lambda lg: dlr_loss_targeted(lg, labels, targets)
    raise ValueError(f"unknown loss {loss!r}")


@torch.no_grad()
def forward_loss(model: Model, x: torch.Tensor, loss_fn) -> torch.Tensor:
    """The per-sample loss at ``x``: a forward alone (no graph), TF32 off."""
    with full_f32():
        return loss_fn(model(x).float())


def apgd_attack(model: Model, x: torch.Tensor, labels: torch.Tensor,
                generator: torch.Generator | None = None, *, eps: float, norm: str = "Linf",
                loss: str = "ce", n_iter: int = 100, targets: torch.Tensor | None = None,
                eot_iter: int = 1, rho: float = 0.75,
                x_init: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """One APGD run maximizing ``loss`` in the eps ball of ``norm``.
    Returns (x_adv_best, best loss per sample). L1 runs
    :func:`apgd_attack_l1` and returns, per sample, its latest
    misclassified point where it found one, else its max-loss point."""
    if norm == "L1":
        x_best, f_best, x_fooled, fooled = apgd_attack_l1(
            model, x, labels, generator, eps=eps, loss=loss, n_iter=n_iter, targets=targets,
            eot_iter=eot_iter, x_init=x_init)
        return torch.where(_tail(fooled, x.ndim), x_fooled, x_best), f_best
    if norm not in ("Linf", "L2"):
        raise ValueError(f"unknown norm {norm!r}")
    loss_fn = loss_function(loss, labels, targets)
    b = x.shape[0]

    if x_init is not None:
        x_adv = _project(x_init.to(x), x, eps, norm)
    elif norm == "Linf":
        gen = _generator(generator)
        u = torch.rand(x.shape, generator=gen, device=gen.device) * 2.0 - 1.0
        x_adv = torch.clamp(x + eps * u, 0.0, 1.0)
    else:
        gen = _generator(generator)
        u = torch.randn(x.shape, generator=gen, device=gen.device)
        x_adv = _project(x + eps * u / _l2n(u), x, eps, norm)

    def ascent(x_k, g, step):
        if norm == "Linf":
            return _project(x_k + step * torch.sign(g), x, eps, norm)
        return _project(x_k + step * g / _l2n(g), x, eps, norm)

    f0, g0, _ = _loss_grad(model, x_adv, loss_fn, eot_iter)
    step = torch.full((b,) + (1,) * (x.ndim - 1), 2.0 * eps, dtype=x.dtype, device=x.device)
    x1 = ascent(x_adv, g0, step)
    f1 = forward_loss(model, x1, loss_fn)

    better = f1 > f0
    f_best = torch.maximum(f0, f1)
    x_best = torch.where(_tail(better, x.ndim), x1, x_adv)
    ckpt = checkpoint_mask(n_iter)
    alpha = 0.75

    x_k, x_km1, f_k = x1, x_adv, f1
    improved_count = better.to(torch.int32)
    f_best_last_ckpt, step_last_ckpt = f_best, step
    window = torch.ones(b, dtype=torch.int32, device=x.device)
    for i in range(n_iter - 1):
        _, g_k, _ = _loss_grad(model, x_k, loss_fn, eot_iter)
        z = ascent(x_k, g_k, step)
        x_next = _project(x_k + alpha * (z - x_k) + (1 - alpha) * (x_k - x_km1), x, eps, norm)
        f_next = forward_loss(model, x_next, loss_fn)

        improved_count = improved_count + (f_next > f_k).to(torch.int32)
        new_best = f_next > f_best
        f_best = torch.where(new_best, f_next, f_best)
        x_best = torch.where(_tail(new_best, x.ndim), x_next, x_best)

        # the checkpoint of iteration i + 2, per sample by masks: halve the
        # step where progress since the last checkpoint is below rho, or
        # where neither the step nor the best loss moved, and restart there
        # from the best point
        is_ckpt = bool(ckpt[min(i + 2, n_iter)])
        window = window + 1
        if is_ckpt:
            cond1 = improved_count < torch.ceil(rho * window).to(torch.int32)
            cond2 = ((step_last_ckpt.flatten(1)[:, 0] == step.flatten(1)[:, 0])
                     & (f_best_last_ckpt >= f_best))
            halve = cond1 | cond2
            halve_t = _tail(halve, x.ndim)
            step = torch.where(halve_t, step / 2, step)
            x_next = torch.where(halve_t, x_best, x_next)
            f_next = torch.where(halve, f_best, f_next)
            improved_count = torch.zeros_like(improved_count)
            f_best_last_ckpt, step_last_ckpt = f_best, step
            window = torch.zeros_like(window)
        x_km1, x_k, f_k = x_k, x_next, f_next
    return x_best, f_best


def apgd_attack_l1(model: Model, x: torch.Tensor, labels: torch.Tensor,
                   generator: torch.Generator | None = None, *, eps: float, loss: str = "ce",
                   n_iter: int = 100, targets: torch.Tensor | None = None, eot_iter: int = 1,
                   x_init: torch.Tensor | None = None):
    """L1-APGD: sparse steps on the top ``topk`` share of |grad| spread
    over their signs, no momentum, the L1-ball ∩ box projection, and every
    max(0.04·n_iter, 1) iterations the sparsity and step adapted (a sample
    whose support shrank by more than 5% resets its step to eps and
    restarts from its best point; the others divide it by 1.5, within
    [eps/10, eps]).

    Returns (x_best, f_best, x_fooled, ever_fooled): the max-loss point and
    its loss, the latest misclassified point per sample, and whether one
    was found."""
    loss_fn = loss_function(loss, labels, targets)
    d = int(np.prod(x.shape[1:]))
    b = x.shape[0]
    if x_init is None:
        gen = _generator(generator)
        t = torch.randn(x.shape, generator=gen, device=gen.device)
        x_adv = l1_ball_box_projection(x, x + t, eps)
        topk = torch.full((b,), 0.2, device=x.device)
        sp_old = torch.full((b,), float(d), device=x.device)
    else:
        x_adv = l1_ball_box_projection(x, x_init.to(x), eps)
        sp_old = _l0_norm(x_adv - x)
        topk = sp_old / d / 1.5

    f0, g0, lg0 = _loss_grad(model, x_adv, loss_fn, eot_iter)
    alpha = 1.0
    k_adapt = max(int(0.04 * n_iter), 1)

    grad, x_best, grad_best, f_best = g0, x_adv, g0, f0
    step = torch.full((b,), alpha * eps, dtype=x.dtype, device=x.device)
    x_fooled, ever_fooled = x_adv, lg0.argmax(1) != labels
    for i in range(n_iter):
        gflat = torch.abs(grad.flatten(1))
        order = torch.sort(gflat, dim=1).values
        idx = torch.clamp(((1.0 - topk) * d).to(torch.int32), 0, d - 1).long()
        thr = torch.gather(order, 1, idx[:, None])
        sgn = torch.sign(grad * (gflat >= thr).reshape(x.shape).to(x.dtype))
        denom = torch.abs(sgn).flatten(1).sum(1) + 1e-10
        x_adv = l1_ball_box_projection(x, x_adv + _tail(step / denom, x.ndim) * sgn, eps)

        f, g, lg = _loss_grad(model, x_adv, loss_fn, eot_iter)
        wrong = lg.argmax(1) != labels
        x_fooled = torch.where(_tail(wrong, x.ndim), x_adv, x_fooled)
        improved = _tail(f > f_best, x.ndim)
        x_best = torch.where(improved, x_adv, x_best)
        grad_best = torch.where(improved, g, grad_best)
        f_best = torch.maximum(f, f_best)
        ever_fooled = ever_fooled | wrong
        grad = g

        if (i + 1) % k_adapt == 0:
            sp_curr = _l0_norm(x_best - x)
            fl_red = (sp_curr / sp_old) < 0.95
            step = torch.clamp(torch.where(fl_red, alpha * eps, step / 1.5),
                               alpha * eps / 10.0, alpha * eps)
            restart = _tail(fl_red, x.ndim)
            x_adv = torch.where(restart, x_best, x_adv)
            grad = torch.where(restart, grad_best, grad)
            topk = sp_curr / d / 1.5
            sp_old = sp_curr
    return x_best, f_best, x_fooled, ever_fooled


def apgd_attack_largereps(model: Model, x: torch.Tensor, labels: torch.Tensor,
                          generator: torch.Generator | None = None, *, eps: float,
                          loss: str = "ce", n_iter: int = 100,
                          targets: torch.Tensor | None = None, eot_iter: int = 1,
                          x_init: torch.Tensor | None = None):
    """L1-APGD in three warm-started phases at radii 3ε → 2ε → ε, the
    iterations split 0.3/0.3/0.4. The first phase starts from ``x_init``
    (default x + N(0, 1), drawn from ``generator``) projected into its
    ball, each later one from the previous best point. Returns (x_adv,
    f_best) at ε, fooled samples carrying their misclassified point."""
    epss = [3.0 * eps, 2.0 * eps, 1.0 * eps]
    iters = [math.ceil(0.3 * n_iter), math.ceil(0.3 * n_iter)]
    iters.append(max(n_iter - sum(iters), 1))
    if x_init is None:
        gen = _generator(generator)
        x_init = x + torch.randn(x.shape, generator=gen, device=gen.device)
    x_warm = x_init.to(x)
    for eps_i, niter in zip(epss, iters):
        x_warm, f_best, x_fooled, fooled = apgd_attack_l1(
            model, x, labels, eps=eps_i, loss=loss, n_iter=niter, targets=targets,
            eot_iter=eot_iter, x_init=x_warm)
    return torch.where(_tail(fooled, x.ndim), x_fooled, x_warm), f_best
