"""Gradients through the hand-written model kernels (K6-K12).

A kernel launched through ctypes is invisible to autograd: its output is a
fresh tensor with no history, and a gradient that should pass through it is
lost without an error. So every wrapper that launches a model kernel runs
it through :func:`plain_grad` when a gradient is needed: the forward is the
kernel, unchanged; the backward recomputes the wrapper's plain version (the
``*_reference`` beside it) under ``torch.enable_grad()`` and returns
``torch.autograd.grad`` of it for every input that requires a gradient,
parameters included. This is the JAX package's design: its custom VJPs
differentiate the reference (``pallas_convnext.py:114-126``,
``pallas_densenet.py:191-207``) or an XLA formula of the same function
(``pallas_attention.py``, ``pallas_mlp.py``).

One :class:`torch.autograd.Function` serves every launcher. Its boundary is
the entry that launches, one level below the JAX package's per-op VJPs
where an op is a composition of such entries:

- ``ops/linear.py``: ``linear_fused`` and ``layer_norm`` (K6's two products
  with the LN prologue, K7's two, and the LN pass);
- ``ops/attention.py``: ``attention_core`` (K6's core, K8, K9);
- ``ops/mlp.py``: ``token_mlp``, the whole op (K10's statistics pass and
  fused kernel, its f32 kernel, and its route over the product);
- ``ops/convnext.py``: ``dwconv_ln`` (K11);
- ``ops/densenet.py``: ``dense_block``, the whole op (K12's three launches
  a layer in bf16, one in f32).

The launches that are one step of such a whole op (``token_stats``,
``token_fused``, ``bn_relu``, ``conv3x3``) have no gradient of their own
and refuse one (:func:`refuse_grad`).

So K6's gradient is the composition of its three launches' plain
backwards, which is the gradient of its plain version: each launch's plain
version rounds where ``window_block_reference`` rounds. The backward is
plain torch; the launch counters count forwards only. Where no gradient is
needed (grad mode off, inference mode, or no input requiring one) the
kernel runs alone.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.autograd.function import once_differentiable


def needs_grad(*tensors) -> bool:
    """Whether autograd would record an op on these tensors (None skipped)."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


class _PlainGrad(torch.autograd.Function):
    """forward ``kernel(*tensors)``; backward the vector-Jacobian product of
    ``plain(*tensors)``, recomputed. Inputs that require a gradient are
    saved for the backward; the others (constants, None) are kept as they
    are; they must not be inference tensors, which the recompute's ops
    cannot save (the models make their cached constants outside inference
    mode)."""

    @staticmethod
    def forward(ctx, kernel, plain, *tensors):
        need = ctx.needs_input_grad[2:]
        ctx.plain, ctx.need = plain, need
        ctx.kept = [None if n else t for t, n in zip(tensors, need)]
        ctx.save_for_backward(*(t if n else None for t, n in zip(tensors, need)))
        return kernel(*tensors)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        inputs = [s.detach().requires_grad_() if n else k
                  for s, k, n in zip(ctx.saved_tensors, ctx.kept, ctx.need)]
        wanted = [t for t, n in zip(inputs, ctx.need) if n]
        with torch.enable_grad():
            out = ctx.plain(*inputs)
        grads = iter(torch.autograd.grad(out, wanted, grad, allow_unused=True))
        return (None, None, *(next(grads) if n else None for n in ctx.need))


def plain_grad(kernel: Callable[..., torch.Tensor], plain: Callable[..., torch.Tensor],
               *tensors) -> torch.Tensor:
    """``kernel(*tensors)``, differentiable as ``plain(*tensors)`` is where a
    gradient is needed. Both take the tensors (or None) positionally and
    return one tensor of one shape and type; every other argument is bound
    in the callables."""
    if needs_grad(*tensors):
        return _PlainGrad.apply(kernel, plain, *tensors)
    return kernel(*tensors)


def refuse_grad(what: str, owner: str, *tensors) -> None:
    """Raise where a launch that is one step of ``owner`` is asked for a
    gradient on its own: only ``owner`` has a plain version to
    differentiate."""
    if needs_grad(*tensors):
        raise RuntimeError(f"{what} is one launch of {owner} and has no gradient of its own: "
                           f"differentiate {owner}")
