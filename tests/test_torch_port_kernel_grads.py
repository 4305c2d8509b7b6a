"""Gradients through the port's model kernels (K6-K12) against the JAX
package's custom VJPs, and the autograd Function that carries them.

On the card every launch of K6-K12 that needs a gradient runs through
``ops/plain_grad.py``: the kernel forward, the plain version's backward. On
the CPU the wrappers run the plain versions, so the gradients here are the
plain versions' autograd, which is what the card's backward computes. They
are held, for the input and every parameter, to the JAX package's ops with
their custom VJPs, the forwards in interpret mode as
``tests/test_pallas_mlp.py`` runs them (``jax.grad`` of ⟨out, r⟩ for a fixed
random cotangent r), f32: max|Δ| ≤ 1e-4·max|g|. The port's weights are the
JAX weights in nn.Linear's (out, in) layout (K11's in Conv2d's).

The Function itself is held on the CPU with a stand-in kernel: its
gradients are the plain version's for the inputs that need one, None
inputs and constants pass and are kept, not saved. The models' caches made
by a forward under inference mode (the DenseNet's packed blocks, the
Mixer's packed token weights, Swin's shift mask) are normal tensors and
serve a later forward that needs the input's gradient; the stage launches
of K10 and K12 refuse a gradient of their own.
"""

import tests.torch_port_threads  # noqa: F401  (before any torch work)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustart_torch.models import densenet as port_densenet
from robustart_torch.models import mlp_mixer as port_mixer
from robustart_torch.models import swin as port_swin
from robustart_torch.models.registry import init_weights
from robustart_torch.ops import attention as pa
from robustart_torch.ops import convnext as pc
from robustart_torch.ops import densenet as pd
from robustart_torch.ops import mlp as pm
from robustart_torch.ops.plain_grad import plain_grad, refuse_grad
from robustart_tpu.ops import pallas_attention as ja
from robustart_tpu.ops import pallas_convnext as jc
from robustart_tpu.ops import pallas_densenet as jd
from robustart_tpu.ops import pallas_mlp as jm

TOL = 1e-4


def _arr(rng, *shape, s=1.0, loc=0.0):
    return (loc + rng.standard_normal(shape) * s).astype(np.float32)


def _mask(rng, nw, n):
    return np.where(rng.uniform(size=(nw, n, n)) < 0.3, -100.0, 0.0).astype(np.float32)


# each case: (numpy inputs, the JAX op, the port op on torch tensors, which
# inputs are differentiated, which are JAX (in, out) weights the port takes
# transposed); the ops take the inputs positionally. K6's key bias (input
# 6) has a zero gradient in exact arithmetic (a row's softmax does not move
# when q·bk shifts all its scores), so both packages' are roundoff: each is
# held below 1e-4 of the largest gradient of the case instead.
ZERO = {"K6 window_block": (6,)}


def _window_block(rng):
    bnw, n, h, d, nw = 4, 49, 4, 32, 2
    c = h * d
    xs = [_arr(rng, bnw, n, c), _arr(rng, c, s=0.2, loc=1.0), _arr(rng, c, s=0.1)]
    for _ in range(4):
        xs += [_arr(rng, c, c, s=c ** -0.5), _arr(rng, c, s=0.05)]
    xs += [_arr(rng, h, n, n, s=0.5), _mask(rng, nw, n)]
    kw = dict(num_windows=nw, eps=1e-5)
    return (xs, lambda *a: ja.window_block_pallas(*a, interpret=True, **kw),
            lambda *a: pa.window_block(*a, **kw), range(12), (3, 5, 7, 9))


def _mlp_vit(rng):
    m, c, f = 34, 64, 256
    xs = [_arr(rng, m, c), _arr(rng, c, f, s=c ** -0.5), _arr(rng, f, s=0.05),
          _arr(rng, f, c, s=f ** -0.5), _arr(rng, c, s=0.05), _arr(rng, c, s=0.2, loc=1.0),
          _arr(rng, c, s=0.1)]
    return (xs, lambda x, w1, b1, w2, b2, s, b: jm.mlp_pallas(
                x, w1, b1, w2, b2, interpret=True, ln=(s, b), residual_input=True),
            lambda x, w1, b1, w2, b2, s, b: pm.mlp(x, w1, b1, w2, b2, ln=(s, b), residual=x),
            range(7), (1, 3))


def _mlp_convnext(rng):
    m, c, f = 72, 64, 256
    xs = [_arr(rng, m, c), _arr(rng, c, f, s=c ** -0.5), _arr(rng, f, s=0.05),
          _arr(rng, f, c, s=f ** -0.5), _arr(rng, c, s=0.05),
          rng.uniform(0.5, 1.5, c).astype(np.float32), _arr(rng, m, c)]
    return (xs, lambda x, w1, b1, w2, b2, g, sc: jm.mlp_pallas(
                x, w1, b1, w2, b2, gamma=g, shortcut=sc, interpret=True),
            lambda x, w1, b1, w2, b2, g, sc: pm.mlp(x, w1, b1, w2, b2, gamma=g, residual=sc),
            range(7), (1, 3))


def _mha(rng):
    xs = [_arr(rng, 2, 50, 3, 64) for _ in range(3)]
    return xs, lambda *a: ja.mha_pallas(*a, interpret=True), pa.mha, range(3), ()


def _window_mha(rng):
    bnw, n, h, d, nw = 8, 49, 3, 32, 4
    xs = [_arr(rng, bnw, n, h, d) for _ in range(3)] + [_arr(rng, h, n, n, s=0.5),
                                                         _mask(rng, nw, n)]
    return (xs, lambda *a: ja.window_mha_pallas(*a, num_windows=nw, interpret=True),
            lambda *a: pa.window_mha(*a, num_windows=nw), range(4), ())


def _token_mlp(rng):
    b, t, c, h = 2, 49, 20, 40
    xs = [_arr(rng, b, t, c), _arr(rng, t, h, s=t ** -0.5), _arr(rng, h, s=0.1),
          _arr(rng, h, t, s=h ** -0.5), _arr(rng, t, s=0.1), _arr(rng, c, s=0.2, loc=1.0),
          _arr(rng, c, s=0.1)]
    return (xs, lambda x, w1, b1, w2, b2, s, bb: jm.token_mlp_pallas(
                x, w1, b1, w2, b2, interpret=True, ln=(s, bb), residual_input=True),
            lambda x, w1, b1, w2, b2, s, bb: pm.token_mlp(
                x, w1, b1, w2, b2, ln=(s, bb), residual_input=True),
            range(7), (1, 3))


def _dwconv_ln(rng):
    c = 32
    xs = [_arr(rng, 2, 9, 11, c), _arr(rng, 7, 7, 1, c, s=1 / 7), _arr(rng, c, s=0.1),
          rng.uniform(0.5, 1.5, c).astype(np.float32), _arr(rng, c, s=0.1)]
    return (xs, lambda *a: jc.dwconv_ln_pallas(*a, interpret=True),
            lambda x, w, *a: pc.dwconv_ln(x, w.permute(3, 2, 0, 1), *a), range(5), ())


def _dense_block(rng):
    blk = dict(c0=8, growth=4, n_layers=2, mid=16)
    c0, g, n, mid = blk["c0"], blk["growth"], blk["n_layers"], blk["mid"]
    s = sum(c0 + li * g for li in range(n))
    xs = [_arr(rng, 2, 6, 6, c0), rng.uniform(0.5, 1.5, (1, s)).astype(np.float32),
          _arr(rng, 1, s, s=0.1), _arr(rng, s, mid, s=0.3),
          rng.uniform(0.5, 1.5, (n, mid)).astype(np.float32), _arr(rng, n, mid, s=0.1),
          _arr(rng, n * 9 * mid, g, s=0.15)]
    return (xs, lambda *a: jd.dense_block_pallas(*a, interpret=True, **blk),
            lambda *a: pd.dense_block(*a, **blk), range(7), ())


CASES = {"K6 window_block": _window_block, "K7 mlp (ViT form)": _mlp_vit,
         "K7 mlp (ConvNeXt form)": _mlp_convnext, "K8 mha": _mha, "K9 window_mha": _window_mha,
         "K10 token_mlp": _token_mlp, "K11 dwconv_ln": _dwconv_ln, "K12 dense_block": _dense_block}


@pytest.mark.parametrize("case", list(CASES))
def test_op_gradients_match_jax_custom_vjp(case):
    rng = np.random.default_rng(list(CASES).index(case))
    xs, jax_op, port_op, diff, transposed = CASES[case](rng)
    cot = _arr(rng, *np.shape(jax_op(*map(jnp.asarray, xs))))
    diff = tuple(diff)

    def loss(*a):
        return jnp.sum(jax_op(*a) * cot)

    ref = jax.jit(jax.grad(loss, argnums=diff))(*map(jnp.asarray, xs))
    ts = [torch.from_numpy(np.ascontiguousarray(a.T if i in transposed else a)) for i, a in
          enumerate(xs)]
    for i in diff:
        ts[i].requires_grad_(True)
    (port_op(*ts) * torch.from_numpy(cot)).sum().backward()
    largest = max(float(np.abs(r).max()) for r in ref)
    for i, r in zip(diff, ref):
        got = ts[i].grad.numpy()
        got, r = (got.T if i in transposed else got), np.asarray(r)
        top = np.abs(r).max()
        assert got.shape == r.shape and top > 0, (case, i)
        if i in ZERO.get(case, ()):
            assert max(top, np.abs(got).max()) <= TOL * largest, (case, i, top, largest)
        else:
            assert np.abs(got - r).max() <= TOL * top, (case, i, np.abs(got - r).max(), top)


def _plain(x, w, b, m):
    """A stand-in plain version: f32 math on x (B, K), w (N, K), an
    optional bias, a constant m."""
    y = torch.tanh(x @ w.t()) * m
    return y if b is None else y + b


def test_plain_grad_function_gives_the_plain_versions_gradient():
    """The Function's forward is the kernel's (here the plain version
    shifted by 1e-3, so that the two are told apart), its backward the plain
    version's vjp: for the inputs that need one, with None and constant
    inputs, the constant kept and not saved."""
    rng = np.random.default_rng(0)
    x0, w0, b0 = (torch.from_numpy(_arr(rng, *s)) for s in ((5, 8), (3, 8), (3,)))
    m = torch.from_numpy(_arr(rng, 5, 3))

    def kernel(x, w, b, m):
        with torch.no_grad():
            return _plain(x, w, b, m) + 1e-3

    for bias, need_w in ((b0, True), (None, True), (b0, False)):
        x = x0.clone().requires_grad_(True)
        w = w0.clone().requires_grad_(need_w)
        b = None if bias is None else bias.clone().requires_grad_(True)
        out = plain_grad(kernel, _plain, x, w, b, m)
        assert out.grad_fn is not None
        torch.testing.assert_close(out, _plain(x0, w0, bias, m) + 1e-3, rtol=0, atol=0)
        cot = torch.from_numpy(_arr(rng, *out.shape))
        (out * cot).sum().backward()
        xr = x0.clone().requires_grad_(True)
        wr = w0.clone().requires_grad_(need_w)
        br = None if bias is None else bias.clone().requires_grad_(True)
        (_plain(xr, wr, br, m) * cot).sum().backward()
        for got, want in ((x, xr), (w, wr), (b, br)):
            if want is None or not want.requires_grad:
                assert got is None or got.grad is None
            else:
                torch.testing.assert_close(got.grad, want.grad, rtol=0, atol=0)


def test_plain_grad_runs_the_kernel_alone_where_no_gradient_is_needed():
    x = torch.ones(2, 3, requires_grad=True)
    calls = []

    def kernel(x):
        calls.append(torch.is_grad_enabled())
        return x.detach() * 2

    with torch.no_grad():
        out = plain_grad(kernel, lambda x: x * 2, x)
    assert out.grad_fn is None and calls == [False]
    assert plain_grad(kernel, lambda x: x * 2, x.detach()).grad_fn is None
    with pytest.raises(RuntimeError, match="differentiate token_mlp"):
        refuse_grad("token_fused", "token_mlp", x)
    refuse_grad("token_fused", "token_mlp", x.detach(), None)


def _input_grad(model, x, forward=None):
    x = x.clone().requires_grad_(True)
    out = (forward or model)(x)
    (out * torch.linspace(-1, 1, out.shape[-1])).sum().backward()
    return x.grad


def test_densenet_pack_made_in_inference_mode_serves_a_gradient():
    """The DenseNet's packed blocks, made by a forward under inference mode,
    are normal tensors without history: a later forward that needs the
    input's gradient (frozen parameters) saves them for K12's plain
    backward, and the gradient equals the concat forward's."""
    model = port_densenet.DenseNet(block_config=(2, 2), growth_rate=8, num_init_features=16,
                                   num_classes=10)
    init_weights(model, torch.Generator().manual_seed(0), probe=True)
    model.eval().requires_grad_(False)
    x = torch.from_numpy(_arr(np.random.default_rng(1), 2, 32, 32, 3))
    with torch.inference_mode():
        model.fused_forward(x)
    packs = [t for _, (params, _) in model._pack_cache.values() for t in params]
    assert packs and not any(t.is_inference() or t.requires_grad for t in packs)
    got = _input_grad(model, x, model.fused_forward)
    want = _input_grad(model, x, model.concat_forward)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * float(want.abs().max()))


def test_mixer_and_swin_constants_made_in_inference_mode_serve_a_gradient():
    """The Mixer's bf16 token pack and Swin's shift mask, made by a forward
    under inference mode, are normal tensors; a later forward gives the
    input's gradient."""
    mixer = port_mixer.MlpMixer(patch_size=8, embed_dim=64, depth=1, tokens_mlp_dim=32,
                                channels_mlp_dim=128, num_classes=10, img_size=32,
                                dtype=torch.bfloat16).eval().requires_grad_(False)
    swin = port_swin.SwinTransformer(embed_dim=32, depths=(2,), num_heads=(2,), window_size=4,
                                     num_classes=10, img_size=16).eval().requires_grad_(False)
    for model, size in ((mixer, 32), (swin, 16)):
        x = torch.from_numpy(_arr(np.random.default_rng(2), 2, size, size, 3))
        with torch.inference_mode():
            model(x)
        g = _input_grad(model, x)
        assert g.shape == x.shape and bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0
    assert not any(t.is_inference() for blk in mixer.blocks for t in blk.token_pack())


def test_densenet_refuses_a_gradient_for_its_parameters():
    """K12's pack carries no history, so a forward whose block parameters
    require a gradient is refused rather than losing that gradient."""
    model = port_densenet.DenseNet(block_config=(2,), growth_rate=8, num_init_features=16,
                                   num_classes=10)
    init_weights(model, torch.Generator().manual_seed(0), probe=True)
    model.eval()
    x = torch.from_numpy(_arr(np.random.default_rng(3), 1, 16, 16, 3))
    with pytest.raises(RuntimeError, match="parameter gradients through the DenseNet"):
        model.fused_forward(x)
    with torch.no_grad():
        assert model.fused_forward(x).shape == (1, 10)
