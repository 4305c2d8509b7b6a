"""The port's white-box gradient attacks against the JAX package.

- ``_ce_grad``, the image gradient of the mean cross-entropy, on a tiny
  ResNet (BasicBlock, one block a stage), a tiny ViT (C 128, 4 heads: K6 and
  K7's plain versions) and a tiny Mixer (K10 and K7's), 32², 10 classes,
  each with the JAX model's numpy variables moved by the port's weight
  bridge; the JAX models run their XLA paths. f32: max|Δ| ≤ 1e-4·max|g|.
- The attacks on the tiny ResNet, 3 steps, from the JAX package's own
  random start, injected (``jax.random.uniform`` for the box, its
  ``_uniform_l2_ball`` and ``_uniform_l1_ball``). ``fgsm`` equals JAX's
  wherever |g| > 1e-3·max|g| (elsewhere the sign of a gradient that the two
  libraries sum in different orders may differ); every other attack
  differs by more than 1e-6 on at most 0.5% of values (each such value a
  step taken the other way for the same reason), lies in its eps ball and
  in [0, 1], and gives the model's argmax of JAX's.
- The port's own samplers, statistically: the box's mean and variance, the
  L2 and L1 balls' radii (‖u‖^d uniform on [0, 1]) and directions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustart_torch.attacks import gradient as pg
from robustart_torch.models import convert
from robustart_torch.models import mlp_mixer as port_mixer
from robustart_torch.models import resnet as port_resnet
from robustart_torch.models import vit as port_vit
from robustart_torch.models.classifier import Classifier as PortClassifier
from robustart_tpu.attacks import gradient as jg
from robustart_tpu.models import mlp_mixer as jax_mixer
from robustart_tpu.models import resnet as jax_resnet
from robustart_tpu.models import vit as jax_vit
from robustart_tpu.models.classifier import Classifier as JaxClassifier
from robustart_tpu.models.torch_convert import unflatten
from tests.test_torch_port_resnet import numpy_variables

SIZE = 32
MIXER = dict(patch_size=8, embed_dim=64, depth=2, tokens_mlp_dim=32, channels_mlp_dim=128,
             num_classes=10)
MODELS = {
    "resnet": (lambda: jax_resnet._resnet(jax_resnet.BasicBlock, (1, 1, 1, 1), num_classes=10),
               lambda: port_resnet._resnet(port_resnet.BasicBlock, (1, 1, 1, 1),
                                           num_classes=10), None),
    "vit": (lambda: jax_vit.VisionTransformer(patch_size=8, embed_dim=128, depth=2, num_heads=4,
                                              num_classes=10, attention_impl="xla"),
            lambda: port_vit.VisionTransformer(patch_size=8, embed_dim=128, depth=2,
                                               num_heads=4, num_classes=10, img_size=SIZE), 32),
    "mixer": (lambda: jax_mixer.MlpMixer(**MIXER),
              lambda: port_mixer.MlpMixer(**MIXER, img_size=SIZE), None),
}


def _pair(kind, seed=0):
    """The JAX classifier and the port's on the same numpy variables."""
    jax_module, port_module, head_dim = MODELS[kind]
    jm = jax_module()
    flat = numpy_variables(jm, SIZE, seed)
    jclf = JaxClassifier(kind, jm, unflatten(flat), input_size=SIZE, num_classes=10)
    pm = port_module()
    pm.load_state_dict(convert.state_dict_from_flax(flat, head_dim=head_dim))
    return jclf, PortClassifier(kind, pm.eval(), input_size=SIZE, num_classes=10)


def _batch(seed=1, n=2):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (n, SIZE, SIZE, 3)).astype(np.float32)
    return x, rng.integers(0, 10, n).astype(np.int32)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("kind", list(MODELS))
def test_ce_grad_matches_jax(kind):
    jclf, pclf = _pair(kind)
    x, y = _batch()
    ref = np.asarray(jax.jit(lambda v, xx, yy: jg._ce_grad(jclf.logits_fn(), v, xx, yy))(
        jclf.variables, x, y))
    got = pg._ce_grad(pclf, _t(x), _t(y).long())
    assert got.dtype == torch.float32
    assert all(not p.requires_grad for p in pclf.parameters())
    got = got.numpy()
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()


EPS = {"fgsm": 8 / 255, "pgd_linf": 8 / 255, "mim_linf": 8 / 255, "pgd_l2": 0.5, "pgd_l1": 100.0}
STEPS = {"pgd_linf": {"steps": 3}, "pgd_l2": {"steps": 3}, "pgd_l1": {"max_iter": 3},
         "mim_linf": {"num_steps": 3}}


def _jax_start(name, key, shape, eps):
    """The perturbation the JAX attack adds at its random start, drawn as
    it draws it."""
    if name in ("pgd_linf", "mim_linf"):
        return jax.random.uniform(key, shape, jnp.float32, -eps, eps)
    if name == "pgd_l2":
        return eps * jg._uniform_l2_ball(key, shape, jnp.float32)
    return eps * jg._uniform_l1_ball(key, shape, jnp.float32)


def _in_ball(name, adv, x, eps):
    d = (adv - x).reshape(len(x), -1)
    if name in ("pgd_l2", "pgd_l1"):
        norm = np.sqrt((d.astype(np.float64) ** 2).sum(1)) if name == "pgd_l2" else (
            np.abs(d.astype(np.float64)).sum(1))
        return bool((norm <= eps * (1 + 1e-5)).all())
    return bool((np.abs(d) <= eps + 1e-6).all())


@pytest.fixture(scope="module")
def resnet_pair():
    return _pair("resnet", seed=3)


@pytest.mark.parametrize("name", ["fgsm", "pgd_linf", "pgd_l2", "pgd_l1", "mim_linf"])
def test_attack_matches_jax(name, resnet_pair):
    jclf, pclf = resnet_pair
    x, _ = _batch(seed=4, n=4)
    y = np.asarray(jclf(jnp.asarray(x))).argmax(-1).astype(np.int32)  # correct at the start
    eps = EPS[name]
    config = {"eps": eps, **STEPS.get(name, {})}
    key = jax.random.key(5)
    ref = np.asarray(jg.make_attack_fn(name, jclf.logits_fn(), **config)(
        jclf.variables, jnp.asarray(x), jnp.asarray(y), key))
    start = None if name == "fgsm" else _t(_jax_start(name, key, x.shape, eps))
    got = pg.make_attack_fn(name, pclf, **config)(_t(x), _t(y).long(), start=start).numpy()
    assert got.shape == ref.shape and got.dtype == np.float32
    assert 0.0 <= got.min() and got.max() <= 1.0 and _in_ball(name, got, x, eps)
    if name == "fgsm":
        g = np.abs(np.asarray(jax.jit(lambda v, xx, yy: jg._ce_grad(jclf.logits_fn(), v, xx, yy))(
            jclf.variables, x, y)))
        clear = g > 1e-3 * g.max()
        assert clear.mean() > 0.5
        np.testing.assert_array_equal(got[clear], ref[clear])
    else:
        assert np.mean(np.abs(got - ref) > 1e-6) <= 0.005
    assert np.abs(got - x).max() > 0.5 * min(eps, 8 / 255)  # the attack moved
    with torch.no_grad():
        port_pred = pclf(_t(got)).argmax(-1).numpy()
    np.testing.assert_array_equal(port_pred, np.asarray(jclf(jnp.asarray(ref))).argmax(-1))


def test_samplers_statistics():
    gen = torch.Generator().manual_seed(0)
    box = pg.uniform_box((200, 16, 16, 3), 0.5, gen)
    assert float(box.abs().max()) <= 0.5
    assert abs(float(box.mean())) < 0.005 and abs(float(box.var()) - 0.25 / 3) < 0.002
    n, shape = 4000, (4000, 2, 3)  # d = 6: the radius U^(1/6) is not all near 1
    for sample, p in ((pg.uniform_l2_ball, 2), (pg.uniform_l1_ball, 1)):
        u = sample(shape, gen).reshape(n, -1).double()
        norm = u.abs().pow(p).sum(1).pow(1 / p)
        assert float(norm.max()) <= 1 + 1e-6
        r = norm ** 6  # uniform on [0, 1] for a uniform sample of the ball
        assert abs(float(r.mean()) - 0.5) < 0.02 and abs(float(r.var()) - 1 / 12) < 0.01
        assert float(u.mean(0).abs().max()) < 0.03  # no direction preferred
        assert abs(float((u > 0).double().mean()) - 0.5) < 0.02
    a = pg.uniform_l1_ball(shape, torch.Generator().manual_seed(7))
    assert torch.equal(a, pg.uniform_l1_ball(shape, torch.Generator().manual_seed(7)))
    with pytest.raises(ValueError, match="Generator"):
        pg.pgd_linf(lambda v: v, torch.zeros(1, 2, 2, 3), torch.zeros(1, dtype=torch.long))


def test_clip_l2_norm_is_global():
    x = torch.zeros(2, 4)
    adv = torch.tensor([[3.0, 0, 0, 0], [0, 4.0, 0, 0]])  # global norm 5, each row's below
    out = pg.clip_l2_norm(x, adv, 2.5)
    torch.testing.assert_close(out, adv / 2)
    ref = np.asarray(jg.clip_l2_norm(jnp.asarray(x.numpy()), jnp.asarray(adv.numpy()), 2.5))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-7)
    assert torch.equal(pg.clip_l2_norm(x, adv, 6.0), adv)


def test_attack_utils_match_jax(tmp_path):
    from robustart_torch.attacks import utils as pu
    from robustart_tpu.attacks import utils as ju

    rng = np.random.default_rng(6)
    x = rng.uniform(0, 1, (3, 4, 4, 3)).astype(np.float32)
    adv = np.clip(x + rng.choice([0.0, 0.03, -0.03], x.shape), 0, 1).astype(np.float32)
    for norm in ("L0", "L1", "L2", "Linf"):
        want = ju.check_imgs(adv, x, norm)
        assert pu.check_imgs(_t(adv), _t(x), norm) == want == pu.check_imgs(adv, x, norm)
        np.testing.assert_array_equal(pu._NORM_FNS[norm](_t(adv - x)), ju._NORM_FNS[norm](adv - x))
    log = tmp_path / "log.txt"
    pu.Logger(str(log)).log("line")
    assert log.read_text() == "line\n"
