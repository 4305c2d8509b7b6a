"""Fused transformer and ConvNeXt MLP (kernel K7).

Counterpart of ``robustart_tpu/ops/pallas_mlp.py::mlp_pallas`` (the Pallas
TPU kernel, ``pl.pallas_call`` at :200):

    y = [LN →] gelu(x·W1ᵀ + b1)·W2ᵀ + b2 [· gamma] [+ residual]

:func:`mlp_reference` is its plain PyTorch version, ``pallas_mlp.py:68-86``
step by step with the exact-erf GELU. On CUDA tensors :func:`mlp` runs the
hand-written kernel ``csrc/linear_fused.cu`` twice: fc1 with the LN prologue
and the GELU epilogue, then fc2 with the bias, ConvNeXt's layer-scale
``gamma`` and the ``residual``: the raw pre-norm x (the ViT and Swin form)
or ConvNeXt's block input, added after the layer-scale as
``(acc + b2)·gamma + residual`` in f32 with one cast. The (M, F) hidden goes through device memory in this version; the TPU
kernel keeps it in VMEM. CPU tensors run the plain version.

Weights are in nn.Linear's (out, in) layout: W1 (F, C), W2 (C, F), the
transposes of the JAX package's; biases, gamma and LN parameters f32. CLIP's
``quick_gelu`` comes with CLIP (ROADMAP.md, item 10).
"""

from __future__ import annotations

import torch

from robustart_torch.ops.linear import linear_fused, linear_fused_reference


def _check(x, act, residual) -> None:
    if act != "gelu":
        raise NotImplementedError(
            f"mlp takes act='gelu' only, not {act!r}; CLIP's quick_gelu comes with CLIP "
            "(ROADMAP.md, item 10)")
    if x.ndim < 2:
        raise ValueError(f"x must be (..., C), got {tuple(x.shape)}")
    if residual is not None and residual.shape != x.shape:
        raise ValueError(f"residual must have x's shape {tuple(x.shape)}, "
                         f"got {tuple(residual.shape)}")


def mlp_reference(x, w1, b1, w2, b2, ln=None, ln_eps: float = 1e-6, residual=None,
                  act: str = "gelu", gamma=None) -> torch.Tensor:
    """Plain version of :func:`mlp`: the LN prologue cast to x's type, fc1
    with f32 accumulation + b1, exact GELU, cast, fc2 + b2 [· gamma]
    [+ residual] in f32, one cast."""
    _check(x, act, residual)
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    res = None if residual is None else residual.reshape(x2.shape)
    h = linear_fused_reference(x2, w1, b1, ln=ln, eps=ln_eps, gelu=True)
    y = linear_fused_reference(h, w2, b2, gamma=gamma, residual=res)
    return y.reshape(shape)


def mlp(x, w1, b1, w2, b2, ln=None, ln_eps: float = 1e-6, residual=None, act: str = "gelu",
        gamma=None) -> torch.Tensor:
    """K7 on x (..., C) in bf16 or f32. ``ln = (weight, bias)``: x is the
    pre-norm input; ``gamma`` (C,) scales fc2's output and ``residual``
    (x's shape and type) is added after it. CUDA tensors run the kernel
    (counted in ``mlp.launches``, once a call); CPU tensors run the plain
    version."""
    if x.device.type == "cpu":
        return mlp_reference(x, w1, b1, w2, b2, ln, ln_eps, residual, act, gamma)
    _check(x, act, residual)
    out = fused_mlp(x, w1, b1, w2, b2, ln, ln_eps, residual, gamma)
    mlp.launches += 1
    return out


mlp.launches = 0


def fused_mlp(x, w1, b1, w2, b2, ln, ln_eps: float, residual=None, gamma=None) -> torch.Tensor:
    """The two launches of K7 on CUDA tensors (on CPU tensors, the plain
    version of each: the tests check the composition there)."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    if ln is not None:
        ln = (ln[0].float(), ln[1].float())
    res = None if residual is None else residual.reshape(x2.shape)
    h = linear_fused(x2, w1.to(x.dtype), b1.float(), ln=ln, eps=ln_eps, gelu=True)
    y = linear_fused(h, w2.to(x.dtype), b2.float(),
                     gamma=None if gamma is None else gamma.float(), residual=res)
    return y.reshape(shape)
