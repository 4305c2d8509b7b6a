"""A DenseNet dense block in eval mode (kernel K12).

Counterpart of ``robustart_tpu/ops/pallas_densenet.py::dense_block_pallas``
(the Pallas TPU kernel, ``pl.pallas_call`` at :141), forward only. Per layer
li, on the first ``c = c0 + li·g`` channels of the block's buffer:

    a1 = relu(x·g1 + b1) → x's type       (BN1 folded, f32)
    t  = a1 · W1                           (1×1, c → mid, f32 sums)
    t2 = relu(t·g2 + b2) → x's type        (BN2 folded, f32)
    y  = conv3×3(zero-padded t2, W2)       (mid → g, f32 sums, one cast)

and y is appended at channel offset c. The parameters come packed as the
JAX package packs them (``models/densenet.py::fused_eval_forward``): g1, b1
(1, S) with S = Σ c_li, W1 (S, mid), g2, b2 (L, mid), W2 (L·9·mid, g) with
tap-major (ky, kx, mid) rows.

:func:`dense_block_reference` is the plain version. It follows the Pallas
kernel's roundings (``_block_kernel``, :86-124): in bf16 a1 and t2 are
rounded to bf16 before their products. The JAX package's XLA reference
(``dense_block_reference``, :57-83) does not round a1 (x·g1 promotes to
f32), so the two JAX functions differ in bf16; in f32 all three agree.

On CUDA tensors :func:`dense_block` allocates the block's final buffer
(B, H, W, c0 + L·g), copies x into its first c0 channels and runs
``csrc/dense_block.cu`` once per layer, each launch writing its g channels
in place; the (M, mid) bottleneck stays on the chip. It counts its calls in
``dense_block.calls`` and its launches (L a call) in
``dense_block.launches``. CPU tensors run the plain version.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from robustart_torch.ops import build

MAX_MID = 128  # a tile's bottleneck is held in shared memory
MAX_GROWTH = 32


def fold_bn(weight, bias, mean, var, eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """Eval-mode BatchNorm as an f32 affine: ``inv = γ/√(var + ε)``,
    ``shift = β − mean·inv`` (``robustart_tpu/models/densenet.py::_fold_bn``)."""
    inv = weight.float() / torch.sqrt(var.float() + eps)
    return inv, bias.float() - mean.float() * inv


def _check(x, g1, b1, w1, g2, b2, w2, c0, growth, n_layers, mid) -> None:
    if x.ndim != 4 or x.shape[-1] != c0:
        raise ValueError(f"x must be (B, H, W, {c0}), got {tuple(x.shape)}")
    s = sum(c0 + li * growth for li in range(n_layers))
    shapes = {"g1": (g1, (1, s)), "b1": (b1, (1, s)), "w1": (w1, (s, mid)),
              "g2": (g2, (n_layers, mid)), "b2": (b2, (n_layers, mid)),
              "w2": (w2, (n_layers * 9 * mid, growth))}
    for what, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{what} must be {shape}, got {tuple(t.shape)}")


def dense_block_reference(x, g1, b1, w1, g2, b2, w2, *, c0: int, growth: int, n_layers: int,
                          mid: int = 128) -> torch.Tensor:
    """Plain version of :func:`dense_block`, the Pallas kernel's steps: the
    3×3 as nine tap products over the zero-padded t2, summed in f32."""
    _check(x, g1, b1, w1, g2, b2, w2, c0, growth, n_layers, mid)
    dtype = x.dtype
    b, h, w, _ = x.shape
    out = x
    off = 0
    for li in range(n_layers):
        c = c0 + li * growth
        a1 = torch.relu(out.float() * g1[0, off:off + c].float()
                        + b1[0, off:off + c].float()).to(dtype)
        t = torch.matmul(a1.float().reshape(-1, c), w1[off:off + c].to(dtype).float())
        t2 = torch.relu(t * g2[li].float() + b2[li].float()).to(dtype)
        tp = torch.nn.functional.pad(t2.float().reshape(b, h, w, mid), (0, 0, 1, 1, 1, 1))
        k2 = w2[li * 9 * mid:(li + 1) * 9 * mid].to(dtype).float().reshape(9, mid, growth)
        acc = torch.zeros((b, h, w, growth), dtype=torch.float32, device=x.device)
        for tap in range(9):
            ky, kx = divmod(tap, 3)
            acc = acc + torch.matmul(tp[:, ky:ky + h, kx:kx + w], k2[tap])
        out = torch.cat([out, acc.to(dtype)], dim=-1)
        off += c
    return out


@functools.lru_cache(maxsize=None)
def _launcher():
    p, i = ctypes.c_void_p, ctypes.c_int
    return build.bind("dense_block", "dense_layer_launch", [p] * 7 + [i] * 8 + [p])


def dense_block(x, g1, b1, w1, g2, b2, w2, *, c0: int, growth: int, n_layers: int,
                mid: int = 128) -> torch.Tensor:
    """K12: a whole dense block on x (B, H, W, c0) in bf16 or f32 →
    (B, H, W, c0 + n_layers·growth), the packed parameters as
    :func:`dense_block_reference` takes them (W1 and W2 cast to x's type,
    the affines to f32). CUDA tensors run ``csrc/dense_block.cu``, one
    launch a layer; CPU tensors run the plain version."""
    if x.device.type == "cpu":
        return dense_block_reference(x, g1, b1, w1, g2, b2, w2, c0=c0, growth=growth,
                                     n_layers=n_layers, mid=mid)
    _check(x, g1, b1, w1, g2, b2, w2, c0, growth, n_layers, mid)
    if x.dtype not in build.DTYPE_CODE:
        raise TypeError(f"x must be bfloat16 or float32, not {x.dtype}")
    if mid > MAX_MID or growth > MAX_GROWTH:
        raise ValueError(f"the kernel takes mid <= {MAX_MID} and growth <= {MAX_GROWTH}, "
                         f"got {mid} and {growth}")
    w1, w2 = w1.to(x.dtype).contiguous(), w2.to(x.dtype).contiguous()
    g1, b1, g2, b2 = (t.float().contiguous() for t in (g1, b1, g2, b2))
    build.check_cuda_tensor(x, "x", x.dtype)
    for t, what in ((w1, "w1"), (w2, "w2"), (g1, "g1"), (b1, "b1"), (g2, "g2"), (b2, "b2")):
        if t.device != x.device:
            raise ValueError(f"{what} must be on {x.device}, not {t.device}")
    bsz, h, w, _ = x.shape
    ctot = c0 + n_layers * growth
    buf = torch.empty((bsz, h, w, ctot), dtype=x.dtype, device=x.device)
    buf[..., :c0] = x
    dense_block.calls += 1
    if buf.numel() == 0:
        return buf
    isz = x.element_size()
    off = 0
    for li in range(n_layers):
        c = c0 + li * growth
        build.launch(_launcher(), x.device, buf.data_ptr(), g1.data_ptr() + off * 4,
                     b1.data_ptr() + off * 4, w1.data_ptr() + off * mid * isz,
                     g2.data_ptr() + li * mid * 4, b2.data_ptr() + li * mid * 4,
                     w2.data_ptr() + li * 9 * mid * growth * isz, bsz, h, w, ctot, c, mid,
                     growth, build.DTYPE_CODE[x.dtype])
        dense_block.launches += 1
        off += c
    return buf


dense_block.calls = 0
dense_block.launches = 0
