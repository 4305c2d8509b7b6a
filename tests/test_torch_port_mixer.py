"""The port's token-mixing MLP (K10), MLP-Mixer, its weight bridge and its
solver path against the JAX package.

K10's plain version is held to the JAX package's ``token_mlp_reference``
and, at one tiny shape, to its Pallas kernel in interpret mode
(``token_mlp_pallas(..., interpret=True)``, the way the JAX package's own
tests run it on the CPU; its GELU is the A&S erf polynomial, |error| ≤
1.5e-7). Tolerances: f32 max|Δ| ≤ 1e-5·max|ref| (the order of the sums);
bf16 one bf16 ulp of max|ref| (each output rounds once, and an order of sums
may round a hidden unit the other way).

K10's bf16 kernel reads W1 and W2 padded by ``pack_token_weights`` at the
widths ``token_plan`` gives; the CPU tests hold that arithmetic, the
padding (the plain version on the padded weights cut back equals it on
the originals, exactly) and the Mixer's pack made once and anew after a
weight changes in place, also for a model made under ``inference_mode``.

Above 256 tokens K10 takes its route over the product on the card
(``token_plan``'s ``"product"``): the CPU tests hold its plan, and the
composition of its steps (the LN pass, the padded transposes, fc1 and fc2
as ``linear_fused``'s plain versions) to K10's plain version.

The tiny Mixer (patch 8, 32², C 64, depth 2) takes the JAX model's variables
(LayerNorm parameters and biases drawn from numpy: at their init a wrong b2
index or LN would not show) through ``robustart_torch.models.convert``; at
24² and 48² (9 and 36 tokens, sizes other than the one it is registered
at) it takes numpy variables on the JAX model's ``eval_shape`` shapes. The
JAX model runs its XLA path on the CPU; the port runs K10's and K7's plain
versions. f32: max|Δlogit| ≤ 2e-4·max|logit| and equal argmax; bf16 3e-2
(the XLA path rounds each product and bias add to bf16, the kernels add in
f32 and cast once). The registered Mixers are sized from ``input_size``,
as the JAX package sizes them: their token weights take JAX's shapes.
"""

import tests.torch_port_threads  # noqa: F401  (before any torch work)
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustart_torch.core.config import Config as PortConfig
from robustart_torch.core.config import load_config
from robustart_torch.models import convert, create_classifier
from robustart_torch.models import mlp_mixer as port_mixer
from robustart_torch.models import registry as port_registry
from robustart_torch.ops import mlp as port_mlp
from robustart_torch.solvers import MultiEvalSolver as PortSolver
from robustart_tpu.core.config import Config
from robustart_tpu.models import mlp_mixer as jax_mixer
from robustart_tpu.models import registry as jax_registry
from robustart_tpu.models.torch_convert import convert_state_dict, flatten, unflatten
from robustart_tpu.ops import pallas_mlp
from robustart_tpu.solvers import MultiEvalSolver as JaxSolver
from tests.test_torch_port_resnet import numpy_init, numpy_variables

TINY = dict(patch_size=8, embed_dim=64, depth=2, tokens_mlp_dim=32, channels_mlp_dim=128,
            num_classes=10)
SIZE = 32
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _token_inputs(b, t, c, h, kind, seed=0):
    """x, W1 (T, H) and W2 (H, T) in the JAX layout, biases, LN and a
    shortcut, as numpy f32 values exact in ``kind``'s type."""
    rng = np.random.default_rng(seed)
    jdt = DTYPES[kind][0]

    def arr(*shape, s=1.0, loc=0.0):
        return np.array(jnp.asarray(rng.normal(loc, s, shape), jdt).astype(jnp.float32))

    return dict(x=arr(b, t, c), w1=arr(t, h, s=t ** -0.5), b1=arr(h, s=0.1),
                w2=arr(h, t, s=h ** -0.5), b2=arr(t, s=0.1), lns=arr(c, s=0.2, loc=1.0),
                lnb=arr(c, s=0.1), shortcut=arr(b, t, c))


def _port_token_mlp(inp, kind, ln, res, act="gelu"):
    """The port's plain K10 on ``inp`` (W1, W2 transposed to nn.Linear's
    layout); ``res``: None, "input" (the raw x) or "shortcut"."""
    dt = DTYPES[kind][1]
    x = torch.from_numpy(inp["x"]).to(dt)
    return port_mlp.token_mlp(
        x, torch.from_numpy(inp["w1"].T.copy()).to(dt), torch.from_numpy(inp["b1"]),
        torch.from_numpy(inp["w2"].T.copy()).to(dt), torch.from_numpy(inp["b2"]),
        shortcut=torch.from_numpy(inp["shortcut"]).to(dt) if res == "shortcut" else None,
        ln=(torch.from_numpy(inp["lns"]), torch.from_numpy(inp["lnb"])) if ln else None,
        residual_input=res == "input", act=act)


def _within(got, ref, kind):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    top = np.abs(ref).max()
    tol = 1e-5 * top if kind == "f32" else 2.0 ** (np.floor(np.log2(top)) - 7)
    assert np.abs(got - ref).max() <= tol, (np.abs(got - ref).max(), tol)


@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("ln,res", [(False, None), (True, "input"), (True, "shortcut"),
                                    (False, "shortcut")])
def test_token_mlp_plain_matches_jax_reference(kind, ln, res):
    """Against ``token_mlp_reference`` (which takes the raw-x residual as
    ``shortcut=x``) at B 2, T 20, C 24, H 16."""
    jdt = DTYPES[kind][0]
    inp = _token_inputs(2, 20, 24, 16, kind)
    x = jnp.asarray(inp["x"], jdt)
    shortcut = {"input": x, "shortcut": jnp.asarray(inp["shortcut"], jdt), None: None}[res]
    ref = pallas_mlp.token_mlp_reference(
        x, jnp.asarray(inp["w1"], jdt), jnp.asarray(inp["b1"]), jnp.asarray(inp["w2"], jdt),
        jnp.asarray(inp["b2"]), shortcut=shortcut,
        ln=(jnp.asarray(inp["lns"]), jnp.asarray(inp["lnb"])) if ln else None)
    got = _port_token_mlp(inp, kind, ln, res)
    assert got.dtype == DTYPES[kind][1]
    _within(got.float().numpy(), ref, kind)


@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_token_mlp_plain_matches_pallas_interpret(kind):
    """Against the Pallas kernel in interpret mode, in the Mixer's form (LN
    prologue, raw-x residual), at B 2, T 16, C 128, H 32."""
    jdt = DTYPES[kind][0]
    inp = _token_inputs(2, 16, 128, 32, kind, seed=1)
    ref = pallas_mlp.token_mlp_pallas(
        jnp.asarray(inp["x"], jdt), jnp.asarray(inp["w1"], jdt), jnp.asarray(inp["b1"]),
        jnp.asarray(inp["w2"], jdt), jnp.asarray(inp["b2"]), interpret=True,
        ln=(jnp.asarray(inp["lns"]), jnp.asarray(inp["lnb"])), residual_input=True)
    _within(_port_token_mlp(inp, kind, True, "input").float().numpy(), ref, kind)


@pytest.mark.parametrize("act", ["gelu", "gelu_tanh", "quick_gelu", "relu"])
def test_token_mlp_activations_match_jax(act):
    """Each of the JAX package's four activations, f32, in the Mixer's form
    (LN prologue, raw-x residual): the plain K10 against
    ``token_mlp_reference`` at B 2, T 20, C 24, H 16 and against the Pallas
    kernel in interpret mode at B 2, T 16, C 128, H 32."""
    inp = _token_inputs(2, 20, 24, 16, "f32", seed=2)
    j = jnp.asarray
    x = j(inp["x"])
    ln = (j(inp["lns"]), j(inp["lnb"]))
    ref = pallas_mlp.token_mlp_reference(x, j(inp["w1"]), j(inp["b1"]), j(inp["w2"]),
                                         j(inp["b2"]), shortcut=x, act=act, ln=ln)
    _within(_port_token_mlp(inp, "f32", True, "input", act).numpy(), ref, "f32")
    inp = _token_inputs(2, 16, 128, 32, "f32", seed=3)
    kernel = pallas_mlp.token_mlp_pallas(
        j(inp["x"]), j(inp["w1"]), j(inp["b1"]), j(inp["w2"]), j(inp["b2"]), act=act,
        interpret=True, ln=(j(inp["lns"]), j(inp["lnb"])), residual_input=True)
    _within(_port_token_mlp(inp, "f32", True, "input", act).numpy(), kernel, "f32")


def test_token_mlp_refuses_what_it_does_not_compute():
    inp = _token_inputs(1, 8, 16, 4, "f32")
    x = torch.from_numpy(inp["x"])
    w1, w2 = torch.from_numpy(inp["w1"].T.copy()), torch.from_numpy(inp["w2"].T.copy())
    b1, b2 = torch.from_numpy(inp["b1"]), torch.from_numpy(inp["b2"])
    with pytest.raises(ValueError, match="w1 must be"):
        port_mlp.token_mlp(x, w2, b1, w1, b2)  # the layouts swapped
    with pytest.raises(ValueError, match="excludes residual_input"):
        port_mlp.token_mlp(x, w1, b1, w2, b2, shortcut=x, residual_input=True)
    with pytest.raises(ValueError, match="unknown act 'swish'"):
        port_mlp.token_mlp(x, w1, b1, w2, b2, act="swish")


@pytest.mark.parametrize("b,t,c,h,want", [
    (128, 196, 768, 384, (208, 384, 6, 6)),
    (128, 196, 1024, 512, (208, 512, 8, 8)),
    (3, 50, 96, 40, (64, 64, 1, 1)),
    (2, 49, 20, 40, (64, 64, 1, 1)),
    (1, 65, 8, 65, (128, 128, 2, 1)),
    (2, 256, 768, 384, (256, 384, 6, 6)),
    (128, 257, 768, 384, (272, 384, (3, 768), (3, 768))),
    (128, 324, 768, 384, (336, 384, (3, 768), (3, 768))),
    (128, 576, 768, 384, (576, 384, (3, 768), (5, 768))),
    (2, 576, 1024, 512, (576, 512, (4, 16), (5, 16))),
])
def test_token_plan(b, t, c, h, want):
    """K10's route by T: up to 256 tokens the fused kernel's bf16 tile
    arithmetic (Tp the smallest compiled width that holds T, Hp H in chunks
    of 64, blocks of 128 channels, a grid of (channel tiles, B)); above,
    the route over the product on the B·C rows of the transposed x, T
    padded to a multiple of 16 and H to one of 64, each product's 128 × 128
    output tiles (N, M)."""
    plan = port_mlp.token_plan(b, t, c, h)
    if t <= port_mlp.MAX_TOKENS:
        tp, hp, chunks, tiles = want
        assert plan == {"route": "fused", "tp": tp, "hp": hp, "chunks": chunks,
                        "channel_tiles": tiles, "grid": (tiles, b)}
    else:
        tp, hp, fc1, fc2 = want
        assert plan == {"route": "product", "tp": tp, "hp": hp, "rows": b * c,
                        "tiles": (fc1, fc2)}


def test_token_plan_refusals_and_packed_layouts():
    """Any token count has a route (above 256, wgmma's largest N, the one
    over the product); empty axes and packed weights in the wrong layout
    are refused, on the CPU as on the card."""
    assert port_mlp.token_plan(1, 257, 8, 16)["route"] == "product"
    for shape in ((1, 0, 8, 16), (1, 16, 8, 0)):
        with pytest.raises(ValueError, match="must be positive"):
            port_mlp.token_plan(*shape)
    with pytest.raises(ValueError, match="at most 65535 images"):
        port_mlp.token_plan(65536, 16, 8, 16)
    inp = _token_inputs(1, 20, 24, 70, "bf16")
    x = torch.from_numpy(inp["x"])
    w1, w2 = torch.from_numpy(inp["w1"].T.copy()), torch.from_numpy(inp["w2"].T.copy())
    b1, b2 = torch.from_numpy(inp["b1"]), torch.from_numpy(inp["b2"])
    w1p, w2p = port_mlp.pack_token_weights(w1, w2)
    assert (w1p.shape, w2p.shape) == ((128, 64), (64, 128))
    port_mlp.token_mlp(x, w1, b1, w2, b2, packed=(w1p, w2p))
    for wrong in ((w2p, w1p[:, :32]), (w1p.float(), w2p), port_mlp.pack_token_weights(w2, w1)):
        with pytest.raises(ValueError, match="packed weights must be"):
            port_mlp.token_mlp(x, w1, b1, w2, b2, packed=wrong)
    with pytest.raises(ValueError, match="w1 .H, T. and w2 .T, H. expected"):
        port_mlp.pack_token_weights(w1, w2[:, :8])


@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("t,c,h", [(257, 24, 70), (324, 16, 384), (576, 8, 40)])
def test_token_product_steps_compose_to_the_plain_version(kind, t, c, h):
    """The route over the product (``token_product``) composed of its
    steps' plain versions on the CPU (the LN pass cast to x's type, the
    transposes with the tokens zero-padded to Tp, fc1 + b1 + the
    activation, fc2 + b2 + the transposed residual) against K10's plain
    version, in the Mixer's form, with a shortcut and no LN, and with
    neither residual; B 2, within the module's tolerance. On the CPU no
    step launches, so no launch is counted."""
    inp = _token_inputs(2, t, c, h, kind, seed=7)
    dt = DTYPES[kind][1]
    x, sc = torch.from_numpy(inp["x"]).to(dt), torch.from_numpy(inp["shortcut"]).to(dt)
    w1 = torch.from_numpy(inp["w1"].T.copy()).to(dt)
    w2 = torch.from_numpy(inp["w2"].T.copy()).to(dt)
    b1, b2 = torch.from_numpy(inp["b1"]), torch.from_numpy(inp["b2"])
    ln = (torch.from_numpy(inp["lns"]), torch.from_numpy(inp["lnb"]))
    plan = port_mlp.token_plan(2, t, c, h)
    assert plan["route"] == "product"
    packed = port_mlp.pack_token_weights(w1, w2, dt)
    for kw, res, ln_ in (({"ln": ln, "residual_input": True}, x, ln), ({"shortcut": sc}, sc, None),
                         ({}, None, None)):
        before = port_mlp.token_mlp.product_launches
        got = port_mlp.token_product(x, packed, b1, b2, plan, res, ln_)
        assert port_mlp.token_mlp.product_launches == before and got.dtype == dt
        _within(got.float().numpy(),
                port_mlp.token_mlp_reference(x, w1, b1, w2, b2, **kw).float().numpy(), kind)


@pytest.mark.parametrize("t,h", [(50, 40), (196, 384)])
def test_token_mlp_reference_on_packed_weights(t, h):
    """``pack_token_weights`` pads with exact zeros and moves no value: the
    plain K10 on its bf16 W1 (Hp, Tp) and W2 (Tp, Hp) cut back to T and H
    equals it on the original weights, exactly in f32 (values exact in
    bf16), B 2, C 8, the Mixer's form."""
    inp = _token_inputs(2, t, 8, h, "bf16", seed=5)
    x = torch.from_numpy(inp["x"])
    w1, w2 = torch.from_numpy(inp["w1"].T.copy()), torch.from_numpy(inp["w2"].T.copy())
    w1p, w2p = port_mlp.pack_token_weights(w1, w2)
    plan = port_mlp.token_plan(2, t, 8, h)
    assert w1p.dtype == w2p.dtype == torch.bfloat16
    assert tuple(w1p.shape) == (plan["hp"], plan["tp"]) and tuple(w2p.shape) == (plan["tp"],
                                                                                  plan["hp"])
    assert not w1p[h:].any() and not w1p[:, t:].any()
    assert not w2p[t:].any() and not w2p[:, h:].any()
    kw = dict(ln=(torch.from_numpy(inp["lns"]), torch.from_numpy(inp["lnb"])),
              residual_input=True)
    b1, b2 = torch.from_numpy(inp["b1"]), torch.from_numpy(inp["b2"])
    ref = port_mlp.token_mlp_reference(x, w1, b1, w2, b2, **kw)
    got = port_mlp.token_mlp_reference(x, w1p[:h, :t].float(), b1, w2p[:t, :h].float(), b2, **kw)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("inference", [False, True])
def test_mixer_packs_token_weights_once(inference):
    """A bf16 Mixer packs each block's K10 weights once, reuses the pack
    while the weights are unchanged, and packs anew after an in-place
    change. Made under ``torch.inference_mode`` (whose tensors carry no
    version counter) it does the same: the token weights become normal
    tensors of the same values at the first pack."""
    gen = torch.Generator().manual_seed(6)
    x = torch.randn((1, SIZE, SIZE, 3), generator=gen)
    with torch.inference_mode(inference):
        pm = port_mixer.MlpMixer(**TINY, img_size=SIZE, dtype=torch.bfloat16).eval()
        port_registry.init_weights(pm, gen)
        tok = pm.blocks[1].mlp_tokens
        before = tok.fc1.weight.detach().clone()
        with torch.no_grad():
            first = pm(x)
        assert not tok.fc1.weight.is_inference() and torch.equal(tok.fc1.weight, before)
        packs = [blk._token_pack[1] for blk in pm.blocks]
        with torch.no_grad():
            assert torch.equal(pm(x), first)
            assert all(blk._token_pack[1] is p for blk, p in zip(pm.blocks, packs))
            tok.fc2.weight.mul_(1.5)
            after = pm(x)
    assert pm.blocks[0]._token_pack[1] is packs[0]
    assert pm.blocks[1]._token_pack[1] is not packs[1] and not torch.equal(after, first)
    for got, want in zip(pm.blocks[1]._token_pack[1],
                         port_mlp.pack_token_weights(tok.fc1.weight, tok.fc2.weight)):
        assert torch.equal(got, want)


# the tiny Mixer's initial variables, the key an argument: every dtype has
# the same f32 parameters, and every seed takes the one compile
_INIT = jax.jit(lambda k: jax_mixer.MlpMixer(**TINY).init(
    k, jnp.zeros((1, SIZE, SIZE, 3)), train=False))


def _flax_vars(seed):
    """Flat numpy variables with every LayerNorm parameter and bias drawn
    from numpy."""
    v = _INIT(jax.random.key(seed))
    rng = np.random.default_rng(seed)
    flat = {}
    for name, a in flatten(v).items():
        a = np.asarray(a, np.float32)
        leaf = name.rsplit("/", 1)[-1]
        if leaf == "scale":
            a = rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        elif leaf == "bias":
            a = rng.normal(0.0, 0.1, a.shape).astype(np.float32)
        flat[name] = a
    return flat


@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("size", [SIZE, 24, 48])
def test_mixer_matches_jax(kind, size):
    """The tiny Mixer at 32² (16 tokens; the JAX init's variables) and at
    24² and 48² (9 and 36 tokens; numpy variables on the JAX model's
    shapes at that size), the port built for the size as the registry
    builds it."""
    jdt, tdt = DTYPES[kind]
    jm = jax_mixer.MlpMixer(**TINY, dtype=jdt)
    flat = _flax_vars(0) if size == SIZE else numpy_variables(jm, size, 0)
    pm = port_mixer.MlpMixer(**TINY, img_size=size, dtype=tdt).eval()
    pm.load_state_dict(convert.state_dict_from_flax(flat))
    x = np.random.default_rng(1).normal(0, 0.5, (2, size, size, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda v, xx: jm.apply(v, xx, train=False))(unflatten(flat), x),
                     np.float32)
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    if kind == "f32":
        assert np.abs(got - ref).max() <= 2e-4 * np.abs(ref).max()
        np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))
    else:
        assert np.abs(got - ref).max() <= 3e-2 * np.abs(ref).max()


def test_bridge_is_inverse_of_jax_converter():
    """Flax → the port's timm-named state dict → the JAX package's
    torch→Flax converter gives back every tensor unchanged."""
    flat = _flax_vars(3)
    sd = convert.state_dict_from_flax(flat)
    assert tuple(sd["blocks.1.mlp_tokens.fc1.weight"].shape) == (32, 16)  # (H, T)
    assert tuple(sd["stem.proj.weight"].shape) == (64, 3, 8, 8)
    variables = unflatten({k: np.zeros_like(v) for k, v in flat.items()})
    back, missing = convert_state_dict({k: v.numpy() for k, v in sd.items()}, variables,
                                       "MlpMixer")
    assert missing == []
    for name, value in flatten(back).items():
        np.testing.assert_array_equal(np.asarray(value), flat[name])
    assert set(sd) == set(port_mixer.MlpMixer(**TINY, img_size=SIZE).state_dict())


def test_registry_builds_mixers_from_the_reference_config():
    """``mixer_b16_224``'s config block (type and kwargs) builds Mixer-B/16
    at its published widths; in bf16 the block and stem weights follow the
    dtype, the norms and head stay f32. Both Mixers are names of both
    registries."""
    cfg = load_config("exprs/robust_baseline_exp/mlp_mixer/mixer_b16_224/config.yaml")
    model = port_registry.get_model(cfg.model.type, dtype=torch.bfloat16,
                                    **dict(cfg.model.kwargs))
    blk = model.blocks[11]
    assert len(model.blocks) == 12
    assert tuple(blk.mlp_tokens.fc1.weight.shape) == (384, 196)
    assert tuple(blk.mlp_channels.fc1.weight.shape) == (3072, 768)
    assert blk.mlp_tokens.fc2.weight.dtype == torch.bfloat16
    assert model.stem.proj.weight.dtype == torch.bfloat16
    assert blk.norm1.weight.dtype == model.head.weight.dtype == torch.float32
    names = {"mixer_b16_224", "mixer_L16_224"}
    assert names <= set(port_registry.model_names()) & set(jax_registry.model_names())


@pytest.mark.parametrize("size", [256, 384])
def test_registry_sizes_mixers_from_input_size(size):
    """``create_classifier("mixer_b16_224", input_size=...)`` builds the
    Mixer for that size, as the JAX package's does: every block's token
    weights take the shapes of the JAX module's under ``jax.eval_shape``
    (transposed: (H, T) and (T, H), T = (size / 16)²), and the classifier
    states its size."""
    clf = create_classifier("mixer_b16_224", device="cpu", input_size=size)
    jm = jax_registry.get_model("mixer_b16_224")
    shapes = flatten(jax.eval_shape(lambda: jm.init(
        {"params": jax.random.key(0)}, jnp.zeros((1, size, size, 3)), train=False)))
    sd = clf.model.state_dict()
    tokens = (size // 16) ** 2
    assert clf.input_size == size and len(clf.model.blocks) == 12
    for name, s in shapes.items():
        if "mlp_tokens" in name and name.endswith("kernel"):
            key = convert.mixer_torch_key(name)
            assert tuple(sd[key].shape) == tuple(s.shape)[::-1]
    assert tuple(sd["blocks.11.mlp_tokens.fc1.weight"].shape) == (384, tokens)
    assert tuple(sd["blocks.0.mlp_tokens.fc2.bias"].shape) == (tokens,)


def _solver_cfg(results):
    cfg = load_config("exprs/robust_baseline_exp/mlp_mixer/mixer_b16_224/config.yaml")
    return {
        "model": {**dict(cfg.model), "type": "mixer_tiny_test"},
        "seed": 0,
        "data": {
            "batch_size": 4, "num_workers": 2, "input_size": SIZE, "test_resize": 36,
            "read_from": "fake", "fake_size": 8, "fake_num_classes": 10,
            "test": {"imagenet_c_online": True, "transforms": {"type": "JUSTNORM"},
                     "sampler": {"type": "distributed"}, "limit_samples": 8,
                     "corruptions": ["gaussian_noise"], "severities": [2],
                     "evaluator": {"type": "imagenetc", "kwargs": {"topk": [1, 5]}}},
        },
        "saver": {"results_dir": str(results)},
    }


def test_online_solver_matches_jax_with_zero_draws(tmp_path, monkeypatch):
    """Both solvers online on the fake backend with the mixer_b16_224
    config's model block, a tiny Mixer in its place and the same weights,
    the noise draw zero: the same top-1, logits within the f32 tolerance."""
    from robustart_torch.solvers import multi_eval_solver as pme
    from robustart_tpu.noise.corruptions import jax_kernels as jk

    monkeypatch.setitem(jax_registry.MODELS._factories, "mixer_tiny_test",
                        lambda **kw: jax_mixer.MlpMixer(**TINY))
    monkeypatch.setitem(jax_registry._META, "mixer_tiny_test",
                        {**jax_registry._META["mixer_b16_224"], "input_size": SIZE})
    monkeypatch.setitem(port_registry.MODELS, "mixer_tiny_test",
                        lambda **kw: port_mixer.MlpMixer(**TINY, img_size=SIZE))
    monkeypatch.setitem(port_registry._META, "mixer_tiny_test",
                        port_registry._META["mixer_b16_224"])
    monkeypatch.setitem(jk.CORRUPTIONS, "gaussian_noise", lambda x, key, severity=1: x)
    monkeypatch.setitem(pme.NOISE_SEVERITY, "gaussian_noise", [0.0] * 5)

    numpy_init(monkeypatch)
    jax_solver = JaxSolver(Config(_solver_cfg(tmp_path / "jax")))
    jax_solver.build_model(seed=0)
    flat = _flax_vars(0)
    jax_solver.classifier.variables = unflatten({k: jnp.asarray(v) for k, v in flat.items()})
    jax_summary = jax_solver.evaluate()
    port = PortSolver(PortConfig(_solver_cfg(tmp_path / "port")), device="cpu")
    port.build_model(seed=0)
    port.classifier.model.load_state_dict(convert.state_dict_from_flax(flat))
    port_summary = port.evaluate()
    assert port_summary["top1_per_corruption"] == jax_summary["top1_per_corruption"]
    rows = [[json.loads(x) for x in open(tmp_path / side / "gaussian_noise" / "2"
                                         / "results.txt.all")] for side in ("jax", "port")]
    sa, sb = (np.array([r["score"] for r in side]) for side in rows)
    assert sa.shape == sb.shape == (8, 10)
    np.testing.assert_array_equal(sa.argmax(-1), sb.argmax(-1))
    assert np.abs(sa - sb).max() <= 2e-4 * np.abs(sa).max()


def test_mixer_init_is_lecun_and_seeded():
    """Random lecun-normal weights from the seed (std 1/√fan_in: 1/√16 in
    the tiny token MLP's fc1), zero biases, LayerNorm at identity; another
    seed gives other weights."""
    models = [port_mixer.MlpMixer(**TINY, img_size=SIZE) for _ in range(2)]
    for seed, model in enumerate(models):
        port_registry.init_weights(model, torch.Generator().manual_seed(seed))
    a, b = (m.blocks[0].mlp_tokens for m in models)
    w = a.fc1.weight.detach()
    assert not torch.equal(w, b.fc1.weight.detach())
    assert abs(float(w.std()) - 0.25) < 0.03
    assert torch.equal(a.fc2.bias.detach(), torch.zeros(16))
    assert torch.equal(models[0].blocks[0].norm1.weight.detach(), torch.ones(64))
