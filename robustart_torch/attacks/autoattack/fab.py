"""FAB: the Fast Adaptive Boundary attack (minimum norm), targeted, or
untargeted by a per-iteration surrogate.

Counterpart of ``robustart_tpu/attacks/autoattack/fab.py`` (Croce & Hein,
ICML 2020). Each iteration linearizes the boundary toward the target class
(f = z_t - z_y, g = ∇f) and projects the current and the original point
onto {x : f + <g, x - x_i> = 0} ∩ [0, 1]^d at the least norm: Linf and L2
by bisection on the radius or multiplier (26 steps, branch-free), L1
greedily by |g|. An iteration is one forward and backward at the current
point and one forward at the next. FAB draws nothing at random.
"""

from __future__ import annotations

import torch

from robustart_torch.attacks.autoattack.apgd import _tail
from robustart_torch.attacks.gradient import Model, _loss_grad
from robustart_torch.models.layers import full_f32

_BISECT_ITERS = 26


def _norms(v: torch.Tensor, p: str) -> torch.Tensor:
    f = v.flatten(1)
    if p == "Linf":
        return torch.abs(f).amax(1)
    if p == "L2":
        return torch.sqrt(torch.sum(f * f, 1) + 1e-18)
    return torch.sum(torch.abs(f), 1)


def _bisect(lo: torch.Tensor, hi: torch.Tensor, reaches) -> torch.Tensor:
    """The upper end of [lo, hi] after ``_BISECT_ITERS`` halvings toward the
    least value where ``reaches`` (monotone, per sample) holds."""
    for _ in range(_BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        ok = reaches(mid)
        lo, hi = torch.where(ok, lo, mid), torch.where(ok, mid, hi)
    return hi


def proj_plane_box_linf(x0: torch.Tensor, g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """argmin ||x - x0||_inf s.t. <g, x> = b, 0 <= x <= 1, per sample, as
    the step x - x0: the largest <g, x> within the r-ball ∩ box grows with
    r, so r is bisected, then the step scaled onto the plane."""
    gf, x0f = g.flatten(1), x0.flatten(1)

    def attain(r):
        xr = torch.clamp(x0f + r[:, None] * torch.sign(gf), 0.0, 1.0)
        return torch.sum(gf * xr, 1), xr

    n = x0f.shape[0]
    r = _bisect(torch.zeros(n, device=x0.device), torch.ones(n, device=x0.device),
                lambda mid: attain(mid)[0] >= b)
    val, xr = attain(r)
    base = torch.sum(gf * x0f, 1)
    theta = torch.where(torch.abs(val - base) > 1e-12, (b - base) / (val - base), 0.0)
    theta = torch.clamp(theta, 0.0, 1.0)[:, None]
    return (x0f + theta * (xr - x0f) - x0f).reshape(x0.shape)


def proj_plane_box_l2(x0: torch.Tensor, g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """argmin ||x - x0||_2 s.t. <g, x> = b, box: bisection on λ in
    x(λ) = clip(x0 + λg), after doubling λ's upper end up to 12 times."""
    gf, x0f = g.flatten(1), x0.flatten(1)

    def val(lam):
        x = torch.clamp(x0f + lam[:, None] * gf, 0.0, 1.0)
        return torch.sum(gf * x, 1), x

    n = x0f.shape[0]
    hi = torch.ones(n, device=x0.device)
    for _ in range(12):
        hi = torch.where(val(hi)[0] < b, hi * 2.0, hi)
    hi = _bisect(torch.zeros(n, device=x0.device), hi, lambda mid: val(mid)[0] >= b)
    return (val(hi)[1] - x0f).reshape(x0.shape)


def proj_plane_box_l1(x0: torch.Tensor, g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """argmin ||x - x0||_1 s.t. <g, x> = b, box: move the coordinates in
    decreasing |g| to their useful bound until the plane is reached, the
    last one part of the way."""
    gf, x0f = g.flatten(1), x0.flatten(1)
    room = torch.where(gf >= 0, 1.0 - x0f, x0f)
    gain = torch.abs(gf) * room
    order = torch.argsort(-torch.abs(gf), dim=1, stable=True)
    gain_sorted = torch.gather(gain, 1, order)
    cum = torch.cumsum(gain_sorted, 1)
    need = (b - torch.sum(gf * x0f, 1))[:, None]
    prev_cum = torch.cat([torch.zeros_like(cum[:, :1]), cum[:, :-1]], 1)
    frac_needed = torch.clamp((need - prev_cum) / torch.clamp(gain_sorted, min=1e-18), 0.0, 1.0)
    move_frac_sorted = torch.where(cum < need, 1.0, frac_needed)
    move_frac = torch.zeros_like(gf).scatter(1, order, move_frac_sorted)
    return (x0f + move_frac * room * torch.sign(gf) - x0f).reshape(x0.shape)


_PROJ = {"Linf": proj_plane_box_linf, "L2": proj_plane_box_l2, "L1": proj_plane_box_l1}


def fab_attack_targeted(model: Model, x: torch.Tensor, labels: torch.Tensor,
                        targets: torch.Tensor | None, *, eps: float, norm: str = "Linf",
                        n_iter: int = 100, alpha_max: float = 0.1, eta: float = 1.05,
                        beta: float = 0.9,
                        untargeted: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """One FAB run. Returns (x_adv, best_norm): per sample the least-norm
    misclassified point found where its norm is within ``eps``, else x.

    ``untargeted=True`` takes as the target, at every iteration, the most
    likely class other than the label (``targets`` is then unused)."""
    proj = _PROJ[norm]
    rows = torch.arange(x.shape[0], device=x.device)

    def boundary(z):
        if untargeted:
            tgt = z.detach().clone()
            tgt[rows, labels] = -torch.inf
            tgt = tgt.argmax(1)
        else:
            tgt = targets
        return torch.gather(z, 1, tgt[:, None])[:, 0] - torch.gather(z, 1, labels[:, None])[:, 0]

    x_i, x_best = x, x
    best_norm = torch.full((x.shape[0],), torch.inf, device=x.device)
    for _ in range(n_iter):
        f, g, _ = _loss_grad(model, x_i, boundary)
        b_i = torch.sum(g.flatten(1) * x_i.flatten(1), 1) - f
        d_i = proj(x_i, g, b_i)
        d_o = proj(x, g, b_i)
        n_i, n_o = _norms(d_i, norm), _norms(d_o, norm)
        alpha = _tail(torch.clamp(n_i / torch.clamp(n_i + n_o, min=1e-12), 0.0, alpha_max),
                      x.ndim)
        x_next = torch.clamp((1 - alpha) * (x_i + eta * d_i) + alpha * (x + eta * d_o), 0.0, 1.0)
        with torch.no_grad(), full_f32():
            is_adv = model(x_next).float().argmax(1) != labels
        # record the misclassified point before the step back toward x
        cur_norm = _norms(x_next - x, norm)
        improved = is_adv & (cur_norm < best_norm)
        best_norm = torch.where(improved, cur_norm, best_norm)
        x_best = torch.where(_tail(improved, x.ndim), x_next, x_best)
        x_i = torch.where(_tail(is_adv, x.ndim),
                          torch.clamp((1 - beta) * x + beta * x_next, 0.0, 1.0), x_next)
    return torch.where(_tail(best_norm <= eps, x.ndim), x_best, x), best_norm
