"""Square Attack: black-box random search with square perturbations, in
Linf, L2 and L1.

Counterpart of ``robustart_tpu/attacks/autoattack/square.py``
(Andriushchenko et al., ECCV 2020). Each query proposes one random window
per sample, evaluates the candidates in one forward and accepts, per
sample, where the margin z_y - max_{k≠y} z_k fell, unless the sample is
already misclassified (margin <= 0).

A misclassified sample never accepts a candidate again, so its state is
final: the loop forwards only the samples still correctly classified, and
stops once none is left. Which samples those are is read on the host every
``CHECK_EVERY`` queries, so the loop does not wait for the device on every
query; between two reads the forwarded set may hold samples already
fooled, whose candidates are then refused as before. Every query draws its
windows and signs for the whole batch, so a sample's draws do not depend
on which others are still forwarded.

The draws come from ``generator`` (a ``torch.Generator`` on x's device) or
are injected through ``draws``: a dict of the tensors the attack would
draw, each query's stacked on a leading axis (see :func:`draw_linf`,
:func:`draw_l2`, :func:`draw_l1` for the names and shapes).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from robustart_torch.attacks.autoattack.apgd import l1_ball_box_projection
from robustart_torch.attacks.gradient import Model, _generator
from robustart_torch.models.layers import full_f32

CHECK_EVERY = 200


def p_selection(p_init: float, it: int, n_iters: int) -> float:
    """The share of the image a window covers at query ``it``: p_init,
    halved at each of the schedule's breakpoints."""
    t = int(it / n_iters * 10000)
    if 10 < t <= 50:
        return p_init / 2
    if 50 < t <= 200:
        return p_init / 4
    if 200 < t <= 500:
        return p_init / 8
    if 500 < t <= 1000:
        return p_init / 16
    if 1000 < t <= 2000:
        return p_init / 32
    if 2000 < t <= 4000:
        return p_init / 64
    if 4000 < t <= 6000:
        return p_init / 128
    if 6000 < t <= 8000:
        return p_init / 256
    if t > 8000:
        return p_init / 512
    return p_init


def margin_and_ce(logits: torch.Tensor, labels: torch.Tensor):
    """(margin, cross-entropy) per sample, float32; margin = z_y -
    max_{k≠y} z_k, negative where the sample is misclassified."""
    logits = logits.float()
    z_y = torch.gather(logits, 1, labels[:, None])[:, 0]
    masked = logits.clone()
    masked[torch.arange(len(labels), device=logits.device), labels] = -torch.inf
    ce = -torch.gather(F.log_softmax(logits, dim=1), 1, labels[:, None])[:, 0]
    return z_y - masked.amax(1), ce


def _eta_pyramid(s: int) -> np.ndarray:
    """The L2 bump η^(s): 1 / (Chebyshev distance to the centre + 1),
    L2-normalized."""
    center = (s - 1) / 2.0
    yy, xx = np.mgrid[0:s, 0:s]
    dist = np.maximum(np.abs(yy - center), np.abs(xx - center))
    eta = 1.0 / (dist + 1.0)
    return (eta / np.sqrt((eta**2).sum())).astype(np.float32)


def _eta_rectangles_l1(xd: int, yd: int) -> np.ndarray:
    """Nested rectangles, increments 1/(counter+1)^4, unit L1 mass."""
    delta = np.zeros((xd, yd), np.float64)
    x_c, y_c = xd // 2 + 1, yd // 2 + 1
    c2 = [x_c - 1, y_c - 1]
    for counter in range(max(x_c, y_c)):
        delta[
            max(c2[0], 0) : min(c2[0] + 2 * counter + 1, xd),
            max(0, c2[1]) : min(c2[1] + 2 * counter + 1, yd),
        ] += 1.0 / (counter + 1) ** 4
        c2[0] -= 1
        c2[1] -= 1
    return delta / np.abs(delta).sum()


def _eta_l1(s: int) -> np.ndarray:
    """η^(s) for L1: + the rectangles on the top half, - on the bottom,
    unit L1 mass."""
    delta = np.zeros((s, s), np.float64)
    delta[: s // 2] = _eta_rectangles_l1(s // 2, s)
    delta[s // 2 :] = -_eta_rectangles_l1(s - s // 2, s)
    return (delta / np.abs(delta).sum()).astype(np.float32)


def window_sizes(norm: str, n_queries: int, h: int, w: int, c: int,
                 p_init: float = 0.8) -> np.ndarray:
    """The side of each query's window (Linf at least 1, L2 at least 3, L1
    odd and at least 3; each below h)."""
    sizes = np.zeros(n_queries, np.int32)
    for it in range(n_queries):
        p = p_selection(p_init, it, n_queries)
        if norm == "L1":
            n_features = h * w * c
            s = max(int(round(np.sqrt(p * n_features / c))), 3)
            sizes[it] = min(s + 1 if s % 2 == 0 else s, h - 1)
        else:
            s = int(round(np.sqrt(p * h * w / c)))
            sizes[it] = max(min(s, h - 1), 1 if norm == "Linf" else 3)
    return sizes


def _signs(shape, gen: torch.Generator) -> torch.Tensor:
    return (torch.randint(0, 2, shape, generator=gen, device=gen.device) * 2 - 1).float()


def _origins(n: int, high: int, gen: torch.Generator) -> torch.Tensor:
    return torch.randint(0, int(high), (n,), generator=gen, device=gen.device)


def draw_linf(x: torch.Tensor, sizes: np.ndarray, gen: torch.Generator) -> dict:
    """Linf's draws: ``init`` the ± stripes (b, 1, w, c), per query ``vh``,
    ``vw`` the window origins (Q, b), ``sign`` the window's ± per channel
    (Q, b, c)."""
    b, h, w, c = x.shape
    return {"init": _signs((b, 1, w, c), gen),
            "vh": torch.stack([_origins(b, h - s + 1, gen) for s in sizes]),
            "vw": torch.stack([_origins(b, w - s + 1, gen) for s in sizes]),
            "sign": _signs((len(sizes), b, c), gen)}


def draw_l2(x: torch.Tensor, sizes: np.ndarray, gen: torch.Generator) -> dict:
    """L2's draws: ``init`` N(0, 1) of x's shape, per query ``vh``, ``vw``
    (Q, b) and ``sign`` (Q, b, c)."""
    b, h, w, c = x.shape
    return {"init": torch.randn(x.shape, generator=gen, device=gen.device),
            "vh": torch.stack([_origins(b, h - s + 1, gen) for s in sizes]),
            "vw": torch.stack([_origins(b, w - s + 1, gen) for s in sizes]),
            "sign": _signs((len(sizes), b, c), gen)}


def draw_l1(x: torch.Tensor, sizes: np.ndarray, gen: torch.Generator, n_cells: int) -> dict:
    """L1's draws: ``init`` the ± of each init cell and channel (b, K, c),
    per query ``vh``, ``vw`` (the window) and ``vh2``, ``vw2`` (the window
    its mass comes from) (Q, b), ``sign`` (Q, b, c) and ``flip`` (Q, b),
    whether η is transposed."""
    b, h, w, c = x.shape
    q = len(sizes)
    return {"init": _signs((b, n_cells, c), gen),
            "vh": torch.stack([_origins(b, h - s, gen) for s in sizes]),
            "vw": torch.stack([_origins(b, w - s, gen) for s in sizes]),
            "vh2": torch.stack([_origins(b, h - s, gen) for s in sizes]),
            "vw2": torch.stack([_origins(b, w - s, gen) for s in sizes]),
            "sign": _signs((q, b, c), gen),
            "flip": torch.rand((q, b), generator=gen, device=gen.device) < 0.5}


def _window(h: int, w: int, vh: torch.Tensor, vw: torch.Tensor, s: int) -> torch.Tensor:
    """(n, h, w, 1) mask of each sample's s × s window at (vh, vw)."""
    rows = torch.arange(h, device=vh.device).reshape(1, h, 1, 1)
    cols = torch.arange(w, device=vh.device).reshape(1, 1, w, 1)
    vh, vw = vh.reshape(-1, 1, 1, 1), vw.reshape(-1, 1, 1, 1)
    return (rows >= vh) & (rows < vh + s) & (cols >= vw) & (cols < vw + s)


def _place(eta: torch.Tensor, vh: torch.Tensor, vw: torch.Tensor) -> torch.Tensor:
    """Each sample's bump (n, h, w), held at the top-left corner, rolled
    to its window's origin: out[r, c] = eta[(r - vh) mod h, (c - vw) mod w]."""
    n, h, w = eta.shape
    ri = (torch.arange(h, device=eta.device)[None] - vh[:, None]) % h
    ci = (torch.arange(w, device=eta.device)[None] - vw[:, None]) % w
    return eta[torch.arange(n, device=eta.device)[:, None, None], ri[:, :, None], ci[:, None, :]]


def _search(model: Model, x: torch.Tensor, labels: torch.Tensor, x_adv: torch.Tensor,
            n_queries: int, candidate) -> torch.Tensor:
    """The random search: ``candidate(it, idx, x_adv_idx)`` proposes the
    query's points for the samples ``idx``; each is accepted where the
    margin fell and the sample was not yet misclassified."""
    def evaluate(xs, ys):
        with torch.no_grad(), full_f32():
            return margin_and_ce(model(xs), ys)[0]

    margin = evaluate(x_adv, labels)
    idx = torch.arange(x.shape[0], device=x.device)
    for it in range(n_queries):
        if it % CHECK_EVERY == 0:
            idx = torch.nonzero(margin > 0)[:, 0]
            if len(idx) == 0:
                break
        x_cand = candidate(it, idx, x_adv[idx])
        margin_c = evaluate(x_cand, labels[idx])
        accept = (margin_c < margin[idx]) & (margin[idx] > 0)
        x_adv[idx] = torch.where(accept.reshape(-1, 1, 1, 1), x_cand, x_adv[idx])
        margin[idx] = torch.where(accept, margin_c, margin[idx])
    return x_adv


def _draws(draws, make, device):
    return make() if draws is None else {k: v.to(device) for k, v in draws.items()}


def square_attack_linf(model: Model, x: torch.Tensor, labels: torch.Tensor,
                       generator: torch.Generator | None = None, *, eps: float,
                       n_queries: int = 5000, p_init: float = 0.8, draws: dict | None = None) -> torch.Tensor:
    """Square attack in Linf: vertical ±eps stripes, then per query one
    window set to ±eps per channel. Returns x_adv (a perturbed x even
    where it did not succeed)."""
    b, h, w, c = x.shape
    sizes = window_sizes("Linf", n_queries, h, w, c, p_init)
    d = _draws(draws, lambda: draw_linf(x, sizes, _generator(generator)), x.device)
    x_adv = torch.clamp(x + d["init"].to(x) * eps, 0.0, 1.0)

    def candidate(it, idx, xa):
        s = int(sizes[it])
        in_square = _window(h, w, d["vh"][it, idx], d["vw"][it, idx], s)
        new_vals = d["sign"][it, idx].to(x).reshape(-1, 1, 1, c) * eps
        cand_delta = torch.where(in_square, new_vals, xa - x[idx])
        return torch.clamp(x[idx] + torch.clamp(cand_delta, -eps, eps), 0.0, 1.0)

    return _search(model, x, labels, x_adv, n_queries, candidate)


def square_attack_l2(model: Model, x: torch.Tensor, labels: torch.Tensor,
                     generator: torch.Generator | None = None, *, eps: float,
                     n_queries: int = 5000, p_init: float = 0.8, draws: dict | None = None) -> torch.Tensor:
    """Square attack in L2, one window a query: the pyramidal bump with a
    random sign per channel, scaled to the budget left outside the window,
    the whole perturbation then renormalized to the eps sphere."""
    b, h, w, c = x.shape
    sizes = window_sizes("L2", n_queries, h, w, c, p_init)
    d = _draws(draws, lambda: draw_l2(x, sizes, _generator(generator)), x.device)

    def renorm(delta):
        n = torch.sqrt(torch.sum(delta.flatten(1) ** 2, 1) + 1e-12)
        return delta * (eps / n).reshape(-1, 1, 1, 1)

    x_adv = torch.clamp(x + renorm(d["init"].to(x)), 0.0, 1.0)
    bank = {int(s): torch.from_numpy(np.pad(_eta_pyramid(int(s)), ((0, h - s), (0, w - s))))
            .to(x.device) for s in sorted(set(sizes.tolist()))}

    def candidate(it, idx, xa):
        s = int(sizes[it])
        vh, vw = d["vh"][it, idx], d["vw"][it, idx]
        eta = _place(bank[s].expand(len(idx), h, w), vh, vw)[..., None]
        in_square = _window(h, w, vh, vw, s)
        sign = d["sign"][it, idx].to(x).reshape(-1, 1, 1, c)
        delta = xa - x[idx]
        win_mass = torch.sum((delta * in_square) ** 2, dim=(1, 2, 3))
        total = torch.sum(delta.flatten(1) ** 2, 1)
        avail = torch.sqrt(torch.clamp(eps**2 - total + win_mass, min=1e-12))
        new_win = sign * eta * avail.reshape(-1, 1, 1, 1)
        return torch.clamp(x[idx] + renorm(torch.where(in_square, new_win, delta)), 0.0, 1.0)

    return _search(model, x, labels, x_adv, n_queries, candidate)


def l1_init_cells(h: int, w: int) -> np.ndarray:
    """(K, h, w): the L1 init's grid of η^(s0) tiles, s0 = max(h // 5, 2),
    centred; one tile a cell (an empty cell where a tile does not fit)."""
    s0 = max(h // 5, 2)
    sp_init = (h - s0 * 5) // 2
    cells = []
    for gy in range(h // s0):
        for gx in range(w // s0):
            tile = np.zeros((h, w), np.float32)
            vh0, vw0 = sp_init + gy * s0, sp_init + gx * s0
            if vh0 + s0 <= h and vw0 + s0 <= w and vh0 >= 0 and vw0 >= 0:
                tile[vh0 : vh0 + s0, vw0 : vw0 + s0] = _eta_l1(s0)
            cells.append(tile)
    return np.stack(cells)


def square_attack_l1(model: Model, x: torch.Tensor, labels: torch.Tensor,
                     generator: torch.Generator | None = None, *, eps: float,
                     n_queries: int = 5000, p_init: float = 0.8, draws: dict | None = None) -> torch.Tensor:
    """Square attack in L1: a grid of η tiles with random signs projected
    into the ball; per query, the mass of a second random window moves
    into the first, where a fresh η bump (transposed at random) joins the
    direction of the window's old content; the budget is the ε left over
    plus the two windows' mass; the candidate is projected onto the L1 ball
    ∩ box. Windows and the transpose are drawn per sample."""
    b, h, w, c = x.shape
    eps_eff = eps * (1.0 - 1e-6)
    cells = torch.from_numpy(l1_init_cells(h, w)).to(x.device)
    sizes = window_sizes("L1", n_queries, h, w, c, p_init)
    d = _draws(draws, lambda: draw_l1(x, sizes, _generator(generator), cells.shape[0]),
               x.device)
    delta_init = torch.einsum("khw,bkc->bhwc", cells, d["init"].to(x))
    x_adv = l1_ball_box_projection(x, x + delta_init, eps_eff)
    bank = {int(s): torch.from_numpy(np.pad(_eta_l1(int(s)), ((0, h - s), (0, w - s))))
            .to(x.device) for s in sorted(set(sizes.tolist()))}

    def candidate(it, idx, xa):
        s = int(sizes[it])
        n = len(idx)
        vh, vw = d["vh"][it, idx], d["vw"][it, idx]
        eta = bank[s]
        eta = torch.where(d["flip"][it, idx].reshape(-1, 1, 1), eta.T[None], eta[None])
        eta_pos = _place(eta.expand(n, h, w), vh, vw)[..., None]
        in1 = _window(h, w, vh, vw, s)
        in2 = _window(h, w, d["vh2"][it, idx], d["vw2"][it, idx], s)
        sign = d["sign"][it, idx].to(x).reshape(-1, 1, 1, c)
        delta = xa - x[idx]
        norms_window_1 = torch.sum(torch.abs(delta) * in1, dim=(1, 2), keepdim=True)
        norms_windows = torch.sum(torch.abs(delta) * (in1 | in2), dim=(1, 2), keepdim=True)
        norms_image = torch.sum(torch.abs(delta), dim=(1, 2, 3), keepdim=True)
        new_win = eta_pos * sign + delta * in1 / (1e-12 + norms_window_1)
        new_win_l1 = torch.sum(torch.abs(new_win) * in1, dim=(1, 2), keepdim=True)
        budget = (torch.clamp(eps * torch.ones_like(norms_image) - norms_image, min=0.0) / c
                  + norms_windows) * c
        new_win = new_win / (1e-12 + new_win_l1) * budget
        cand_delta = torch.where(in1, new_win, torch.where(in2, 0.0, delta))
        return l1_ball_box_projection(x[idx], x[idx] + cand_delta, eps_eff)

    return _search(model, x, labels, x_adv, n_queries, candidate)
