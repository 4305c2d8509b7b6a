"""The port's AutoAttack components against the JAX package, on the CPU.

The model is a two-layer MLP (16 × 16 × 3 → 64 → 10, ReLU) defined in both
frameworks from one set of numpy weights, batch 4, labels its own argmax
(every sample starts correctly classified). f32 throughout.

- Host helpers (``checkpoint_mask``, ``p_selection``, the square sizes,
  ``_eta_pyramid``, ``_eta_rectangles_l1``, ``_eta_l1``): exact.
- ``ce_loss_per_sample``, ``dlr_loss``, ``dlr_loss_targeted``,
  ``margin_and_ce`` (with tied top logits): within 1e-6.
  ``l1_ball_box_projection`` and FAB's three plane-and-box projections:
  within 1e-5.
- APGD, 8 iterations, from the JAX package's own start (its
  ``jax.random`` draw, injected as ``x_init`` in both): ce/Linf,
  dlr/L2, dlr-targeted/Linf, ce/L1, largereps/L1, and ce/Linf with
  ``eot_iter=2``. FAB-T in Linf, L2, L1 and untargeted FAB in Linf, 8
  iterations (FAB draws nothing). Square in Linf, L2, L1, 30 queries, on
  the draws the JAX body makes, derived here from the same key in its
  split order (``k0`` first, then ``key, k1..kn`` each query) and injected
  as ``draws``: the port's result equal to JAX's is itself the proof that
  the order is right.
  Tolerance: best losses within rel 1e-4; the images within 1e-6 on all
  but 0.5% of values (a signed step of a gradient component near 0, which
  the two libraries sum in different orders, may go the other way, as in
  ``tests/test_torch_port_attacks.py``); the same argmax. Square-L1's
  images are held within 1e-5 on every value instead: its budget adds the
  mass left in the ball, eps - ||δ||₁, and the projection puts ||δ||₁ at
  eps·(1 - 1e-6), so that term (8e-6 at eps 8) is the difference of two
  f32 sums whose last bits depend on the order the libraries add 768
  terms in (the sum's own rounding is about 1e-6); each accepted window
  carries that into its values (measured: 0.8% of values beyond 1e-6 after
  30 queries, the largest 3.7e-6).
- The port's own samplers: each window origin's range and the balance of
  the signs and transposes, statistically.

Time budget: 30 s in one process with no JAX compilation cache (each
(attack, norm) is jitted once, at one shape).
"""

import tests.torch_port_threads  # noqa: F401  (before any torch work)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustart_torch.attacks.autoattack import apgd as p_apgd
from robustart_torch.attacks.autoattack import fab as p_fab
from robustart_torch.attacks.autoattack import square as p_square
from robustart_tpu.attacks.autoattack import apgd as j_apgd
from robustart_tpu.attacks.autoattack import fab as j_fab
from robustart_tpu.attacks.autoattack import square as j_square

SIZE, HIDDEN, CLASSES, BATCH = 16, 64, 10, 4
EPS = {"Linf": 8 / 255, "L2": 0.5, "L1": 8.0}


def jax_mlp(v, x):
    h = jnp.maximum(x.reshape(x.shape[0], -1) @ v["w1"] + v["b1"], 0.0)
    return h @ v["w2"] + v["b2"]


class TorchMLP(torch.nn.Module):
    def __init__(self, v):
        super().__init__()
        for k, a in v.items():
            self.register_parameter(k, torch.nn.Parameter(torch.from_numpy(np.array(a))))

    def forward(self, x):
        h = torch.relu(x.flatten(1) @ self.w1 + self.b1)
        return h @ self.w2 + self.b2


def mlp_weights(seed=0):
    rng = np.random.default_rng(seed)
    d = SIZE * SIZE * 3
    return {"w1": rng.normal(0, np.sqrt(2 / d), (d, HIDDEN)).astype(np.float32),
            "b1": rng.normal(0, 0.1, HIDDEN).astype(np.float32),
            "w2": rng.normal(0, np.sqrt(2 / HIDDEN), (HIDDEN, CLASSES)).astype(np.float32),
            "b2": rng.normal(0, 0.1, CLASSES).astype(np.float32)}


@pytest.fixture(scope="module")
def pair():
    """(JAX variables, port model, x, labels): labels the model's argmax."""
    v = mlp_weights()
    x = np.random.default_rng(1).uniform(0, 1, (BATCH, SIZE, SIZE, 3)).astype(np.float32)
    jv = {k: jnp.asarray(a) for k, a in v.items()}
    y = np.asarray(jax_mlp(jv, x)).argmax(1).astype(np.int32)
    return jv, TorchMLP(v), x, y


def _t(a):
    return torch.from_numpy(np.array(a))


def _close_images(got, ref, every: float | None = None):
    """Within 1e-6 on all but 0.5% of values; or within ``every`` on all."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and np.isfinite(got).all()
    if every is not None:
        assert np.abs(got - ref).max() <= every, np.abs(got - ref).max()
    else:
        assert np.mean(np.abs(got - ref) > 1e-6) <= 0.005, np.mean(np.abs(got - ref) > 1e-6)


def _same_argmax(model, jv, got, ref):
    with torch.no_grad():
        a = model(_t(got)).argmax(1).numpy()
    np.testing.assert_array_equal(a, np.asarray(jax_mlp(jv, jnp.asarray(ref))).argmax(1))


# -- host helpers --------------------------------------------------------------

def test_host_helpers_exact():
    for n in (1, 2, 5, 8, 10, 33, 100, 250):
        np.testing.assert_array_equal(p_apgd.checkpoint_mask(n), j_apgd.checkpoint_mask(n))
    for n in (1, 20, 500, 5000):
        for it in range(n):
            assert p_square.p_selection(0.8, it, n) == j_square.p_selection(0.8, it, n)
    for s in range(1, 24):
        np.testing.assert_array_equal(p_square._eta_pyramid(s), j_square._eta_pyramid(s))
        np.testing.assert_array_equal(p_square._eta_rectangles_l1(s, s + 1),
                                      j_square._eta_rectangles_l1(s, s + 1))
        if s >= 2:
            np.testing.assert_array_equal(p_square._eta_l1(s), j_square._eta_l1(s))
    # the square sides as each JAX body computes them
    for n_q, (h, w, c) in ((30, (16, 16, 3)), (5000, (224, 224, 3))):
        want = {"Linf": [], "L2": [], "L1": []}
        for it in range(n_q):
            p = j_square.p_selection(0.8, it, n_q)
            s = int(round(np.sqrt(p * h * w / c)))
            want["Linf"].append(max(min(s, h - 1), 1))
            want["L2"].append(max(min(s, h - 1), 3))
            s = max(int(round(np.sqrt(p * (h * w * c) / c))), 3)
            want["L1"].append(min(s + 1 if s % 2 == 0 else s, h - 1))
        for norm, sizes in want.items():
            np.testing.assert_array_equal(p_square.window_sizes(norm, n_q, h, w, c), sizes)


def test_losses_match_jax():
    rng = np.random.default_rng(2)
    logits = rng.normal(0, 3, (6, CLASSES)).astype(np.float32)
    logits[1, 4] = logits[1].max()  # the top two tied
    logits[2, :] = logits[2, 0]  # every class tied
    labels = np.array([0, 4, 2, 9, 5, 1], np.int32)
    labels[3] = logits[3].argmax()  # the label on top
    targets = (labels + 3) % CLASSES
    lj, yj, tj = jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(targets)
    lt, yt, tt = _t(logits), _t(labels).long(), _t(targets).long()
    pairs = [(p_apgd.ce_loss_per_sample(lt, yt), j_apgd.ce_loss_per_sample(lj, yj)),
             (p_apgd.dlr_loss(lt, yt), j_apgd.dlr_loss(lj, yj)),
             (p_apgd.dlr_loss_targeted(lt, yt, tt), j_apgd.dlr_loss_targeted(lj, yj, tj)),
             *zip(p_square.margin_and_ce(lt, yt), j_square.margin_and_ce(lj, yj))]
    for got, ref in pairs:
        ref = np.asarray(ref)
        assert got.dtype == torch.float32
        finite = np.isfinite(ref)
        np.testing.assert_array_equal(np.isfinite(got.numpy()), finite)
        np.testing.assert_allclose(got.numpy()[finite], ref[finite], rtol=1e-6, atol=1e-6)


def _plane_inputs(seed=3):
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(0, 1, (BATCH, 5, 5, 3)).astype(np.float32)
    g = rng.normal(0, 1, x0.shape).astype(np.float32)
    gx = (g * x0).reshape(BATCH, -1).sum(1)
    b = (gx + rng.uniform(-2, 2, BATCH)).astype(np.float32)
    return x0, g, b


@pytest.mark.parametrize("name", ["l1_ball", "linf", "l2", "l1"])
def test_projections_match_jax(name):
    x0, g, b = _plane_inputs()
    if name == "l1_ball":
        x_adv = (x0 + g * 0.3).astype(np.float32)
        for eps in (0.5, 4.0, 1e3):
            ref = np.asarray(jax.jit(j_apgd.l1_ball_box_projection, static_argnums=2)(
                x0, x_adv, eps))
            got = p_apgd.l1_ball_box_projection(_t(x0), _t(x_adv), eps).numpy()
            np.testing.assert_allclose(got, ref, atol=1e-5)
            dist = np.abs(got - x0).reshape(BATCH, -1).sum(1)
            assert (dist <= eps + 1e-3).all() and got.min() >= 0 and got.max() <= 1
        return
    ref = np.asarray(jax.jit(getattr(j_fab, f"proj_plane_box_{name}"))(x0, g, b))
    got = getattr(p_fab, f"proj_plane_box_{name}")(_t(x0), _t(g), _t(b)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)


# -- APGD ------------------------------------------------------------------

APGD_CASES = {  # name: (norm, loss, targeted, eot_iter, largereps)
    "ce-Linf": ("Linf", "ce", False, 1, False),
    "dlr-L2": ("L2", "dlr", False, 1, False),
    "dlr_targeted-Linf": ("Linf", "dlr-targeted", True, 1, False),
    "ce-L1": ("L1", "ce", False, 1, False),
    "largereps-L1": ("L1", "ce", False, 1, True),
    "ce-Linf-eot2": ("Linf", "ce", False, 2, False),
}


def _jax_start(norm, key, x, eps):
    """The point JAX's random start makes, drawn as it draws it."""
    if norm == "Linf":
        return x + eps * jax.random.uniform(key, x.shape, jnp.float32, -1.0, 1.0)
    u = jax.random.normal(key, x.shape, jnp.float32)
    if norm == "L2":
        return x + eps * u / j_apgd._l2n(u).reshape(-1, 1, 1, 1)
    return x + u


@pytest.mark.parametrize("case", list(APGD_CASES))
def test_apgd_matches_jax(case, pair):
    jv, model, x, y = pair
    norm, loss, targeted, eot, largereps = APGD_CASES[case]
    eps, n_iter = EPS[norm], 8
    targets = ((y + 1 + np.arange(BATCH)) % CLASSES).astype(np.int32) if targeted else None
    x_init = np.asarray(_jax_start(norm, jax.random.key(7), jnp.asarray(x), eps))
    key = jax.random.key(8)
    kw = dict(eps=eps, loss=loss, n_iter=n_iter, eot_iter=eot)
    tj = None if targets is None else jnp.asarray(targets)
    tt = None if targets is None else _t(targets).long()
    if largereps:
        # the JAX function draws its warm start x + N(0, 1) from its key
        ref, f_ref = j_apgd.apgd_attack_largereps(jax_mlp, jv, x, y, key, targets=tj, **kw)
        x_init = np.asarray(x + jax.random.normal(key, x.shape, jnp.float32))
        got, f_got = p_apgd.apgd_attack_largereps(model, _t(x), _t(y).long(), targets=tt,
                                                  x_init=_t(x_init), **kw)
    else:
        ref, f_ref = j_apgd.apgd_attack(jax_mlp, jv, x, y, key, norm=norm, targets=tj,
                                        x_init=x_init, **kw)
        got, f_got = p_apgd.apgd_attack(model, _t(x), _t(y).long(), norm=norm, targets=tt,
                                        x_init=_t(x_init), **kw)
    assert all(not p.requires_grad for p in model.parameters())
    np.testing.assert_allclose(f_got.numpy(), np.asarray(f_ref), rtol=1e-4, atol=1e-6)
    _close_images(got.numpy(), ref)
    _same_argmax(model, jv, got.numpy(), ref)
    d = (got.numpy() - x).reshape(BATCH, -1).astype(np.float64)
    norms = {"Linf": np.abs(d).max(1), "L2": np.sqrt((d**2).sum(1)), "L1": np.abs(d).sum(1)}
    assert (norms[norm] <= eps * (1 + 1e-5)).all()
    assert got.min() >= 0 and got.max() <= 1


# -- FAB -------------------------------------------------------------------

@pytest.mark.parametrize("norm,untargeted", [("Linf", False), ("L2", False), ("L1", False),
                                             ("Linf", True)])
def test_fab_matches_jax(norm, untargeted, pair):
    jv, model, x, y = pair
    eps = EPS[norm]
    targets = ((y + 2) % CLASSES).astype(np.int32)
    ref, n_ref = j_fab.fab_attack_targeted(jax_mlp, jv, x, y, targets, jax.random.key(0),
                                           eps=eps, norm=norm, n_iter=8, untargeted=untargeted)
    got, n_got = p_fab.fab_attack_targeted(model, _t(x), _t(y).long(), _t(targets).long(),
                                           eps=eps, norm=norm, n_iter=8, untargeted=untargeted)
    n_ref = np.asarray(n_ref)
    np.testing.assert_array_equal(np.isfinite(n_got.numpy()), np.isfinite(n_ref))
    assert np.isfinite(n_ref).any()  # some sample crossed its boundary
    fin = np.isfinite(n_ref)
    np.testing.assert_allclose(n_got.numpy()[fin], n_ref[fin], rtol=1e-4)
    _close_images(got.numpy(), ref)
    _same_argmax(model, jv, got.numpy(), ref)


# -- Square ----------------------------------------------------------------

def jax_square_draws(norm, key, x, n_queries, n_cells=None):
    """The draws of the JAX body of ``square_attack_<norm>``, made from
    ``key`` in its split order, as the port's ``draws``."""
    b, h, w, c = x.shape
    sizes = p_square.window_sizes(norm, n_queries, h, w, c)
    k0, key = jax.random.split(key)
    if norm == "Linf":
        init = jax.random.rademacher(k0, (b, 1, w, c), dtype=jnp.int32)
    elif norm == "L2":
        init = jax.random.normal(k0, x.shape, x.dtype)
    else:
        init = jax.random.rademacher(k0, (b, n_cells, c), dtype=jnp.int32)
    out = {k: [] for k in ("vh", "vw", "vh2", "vw2", "sign", "flip")}
    split = {"Linf": 4, "L2": 5, "L1": 7}[norm]
    for it in range(n_queries):
        key, *ks = jax.random.split(key, split)
        s = int(sizes[it])
        if norm == "L1":
            out["flip"].append(jax.random.bernoulli(ks[5], 0.5, (b,)))
            for name, k in zip(("vh", "vw", "vh2", "vw2"), ks[:4]):
                out[name].append(jax.random.randint(k, (b,), 0, h - s))
            out["sign"].append(jax.random.rademacher(ks[4], (b, 1, 1, c), dtype=jnp.int32))
        else:
            shape = (b, 1, 1, 1) if norm == "Linf" else (b,)
            out["vh"].append(jax.random.randint(ks[0], shape, 0, h - s + 1))
            out["vw"].append(jax.random.randint(ks[1], shape, 0, w - s + 1))
            out["sign"].append(jax.random.rademacher(ks[2], (b, 1, 1, c), dtype=jnp.int32))
    draws = {"init": _t(np.asarray(init, np.float32))}
    for name, v in out.items():
        if v:
            a = np.stack([np.asarray(t) for t in v])
            draws[name] = _t(a.reshape(n_queries, b, -1)[..., 0] if name in ("vh", "vw", "vh2",
                                                                              "vw2", "flip")
                             else a.reshape(n_queries, b, c).astype(np.float32))
    for name in ("vh", "vw", "vh2", "vw2"):
        if name in draws:
            draws[name] = draws[name].long()
    return draws


@pytest.mark.parametrize("norm", ["Linf", "L2", "L1"])
def test_square_matches_jax(norm, pair, monkeypatch):
    jv, model, x, y = pair
    eps, n_q = EPS[norm], 30
    fn = {"Linf": j_square.square_attack_linf, "L2": j_square.square_attack_l2,
          "L1": j_square.square_attack_l1}[norm]
    key = jax.random.key(11)
    ref = np.asarray(fn(jax_mlp, jv, x, y, key, eps=eps, n_queries=n_q))
    n_cells = p_square.l1_init_cells(SIZE, SIZE).shape[0]
    draws = jax_square_draws(norm, key, jnp.asarray(x), n_q, n_cells)
    port = {"Linf": p_square.square_attack_linf, "L2": p_square.square_attack_l2,
            "L1": p_square.square_attack_l1}[norm]
    # a check every 7 queries: the compaction of the forwarded set changes nothing
    for check_every in (p_square.CHECK_EVERY, 7):
        monkeypatch.setattr(p_square, "CHECK_EVERY", check_every)
        got = port(model, _t(x), _t(y).long(), eps=eps, n_queries=n_q, draws=draws).numpy()
        _close_images(got, ref, 1e-5 if norm == "L1" else None)
        _same_argmax(model, jv, got, ref)
    assert np.abs(ref - x).max() > 0


def test_square_samplers_statistics():
    gen = torch.Generator().manual_seed(0)
    x = torch.zeros(400, 24, 24, 3)
    sizes = p_square.window_sizes("Linf", 50, 24, 24, 3)
    for draw, high_off in ((p_square.draw_linf, 1), (p_square.draw_l2, 1)):
        d = draw(x, sizes, gen)
        for name in ("vh", "vw"):
            for it, s in enumerate(sizes):
                v = d[name][it]
                assert int(v.min()) == 0 and int(v.max()) == 24 - s + high_off - 1
                assert abs(float(v.float().mean()) - (24 - s + high_off - 1) / 2) < 2.0
        assert set(d["sign"].unique().tolist()) == {-1.0, 1.0}
        assert abs(float(d["sign"].mean())) < 0.02
    assert abs(float(p_square.draw_l2(x, sizes, gen)["init"].std()) - 1) < 0.01
    sizes = p_square.window_sizes("L1", 50, 24, 24, 3)
    d = p_square.draw_l1(x, sizes, gen, 64)
    for name in ("vh", "vw", "vh2", "vw2"):
        for it, s in enumerate(sizes):
            v = d[name][it]
            assert int(v.min()) == 0 and int(v.max()) == max(24 - s - 1, 0)
    assert abs(float(d["flip"].float().mean()) - 0.5) < 0.02
    assert abs(float(d["init"].mean())) < 0.02 and d["init"].shape == (400, 64, 3)
    a = p_square.draw_l1(x, sizes, torch.Generator().manual_seed(5), 64)
    b = p_square.draw_l1(x, sizes, torch.Generator().manual_seed(5), 64)
    assert all(torch.equal(a[k], b[k]) for k in a)
