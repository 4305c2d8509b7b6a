"""A DenseNet dense block in eval mode (kernel K12).

Counterpart of ``robustart_tpu/ops/pallas_densenet.py::dense_block_pallas``
(the Pallas TPU kernel, ``pl.pallas_call`` at :141); its gradient is the
plain version's. Per layer li, on the first ``c = c0 + li·g`` channels of
the block's buffer:

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
(B, H, W, c0 + L·g), copies x into its first c0 channels, and each layer
writes its g channels in place (``csrc/dense_block.cu``):

- bf16, three launches a layer: the BN1-ReLU pass into an (M, c) scratch
  (:func:`bn_relu`), the 1×1 on ``linear_fused.cu``'s product with its
  ``relu(acc·g2 + b2)`` epilogue into an (M, mid) scratch
  (``ops/linear.py::linear_fused(..., scale=g2)``), and the 3×3 as an
  implicit GEMM into the buffer (:func:`conv3x3`). The arguments are checked
  and the pointers worked out once a call (:func:`block_plan`); then each
  layer is three ctypes calls. W1 goes to the product as each layer's
  (mid, c) transpose (:func:`pack_w1t`) and W2 to the 3×3 as each tap's
  (g, mid) transpose in the kernel's shared-memory order
  (:func:`pack_w2t`), which a caller that packs once
  (``models/densenet.py``) passes in.
- f32, for checks: one CUDA-core launch a layer.

It counts its calls in ``dense_block.calls`` and its launches (3 a layer in
bf16, 1 in f32) in ``dense_block.launches``; :func:`bn_relu` and
:func:`conv3x3` count theirs there too. :func:`dense_block_stages` runs the
three bf16 stages one by one through their wrappers: on the CPU it is the
plain version of the bf16 path, stage by stage. CPU tensors run the plain
versions.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from robustart_torch.ops import build, linear
from robustart_torch.ops.plain_grad import plain_grad, refuse_grad

MAX_MID = 128  # the kernels' widest bottleneck and growth
MAX_GROWTH = 32
TILE_PIXELS = 64  # the 3×3's output pixels a tile (csrc/dense_block.cu)
W2T_ROWS, W2T_K = 32, 64  # the 3×3's W2ᵀ: 32 output channels × K in steps of 64


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


def pack_w1t(w1, *, c0: int, growth: int, n_layers: int, mid: int) -> torch.Tensor:
    """W1's layer slices (c, mid) of the packed (S, mid) matrix, each
    transposed to the (mid, c) = (N, K) layout of the 1×1's product, flat
    and in layer order (S·mid values; layer li at ``block_plan``'s
    ``w1t`` offset)."""
    parts, off = [], 0
    for li in range(n_layers):
        c = c0 + li * growth
        parts.append(w1[off:off + c].t().reshape(-1))
        off += c
    return torch.cat(parts)


def pack_w2t(w2, *, growth: int, n_layers: int, mid: int) -> torch.Tensor:
    """W2's taps transposed for the 3×3 kernel: for each layer and tap the
    (g, mid) matrix, its rows padded to 32 output channels and its K to a
    multiple of 64 with zeros, cut into 64-wide K slices, in that order
    (L, 9, ⌈mid/64⌉, 32, 64); layer li at ``block_plan``'s ``w2t`` offset."""
    kh = -(-mid // W2T_K)
    t = w2.reshape(n_layers, 9, mid, growth).transpose(2, 3)
    t = torch.nn.functional.pad(t, (0, kh * W2T_K - mid, 0, W2T_ROWS - growth))
    return t.reshape(n_layers, 9, W2T_ROWS, kh, W2T_K).transpose(2, 3).contiguous()


def block_plan(batch: int, h: int, w: int, *, c0: int, growth: int, n_layers: int,
               mid: int) -> dict:
    """The arithmetic of one bf16 :func:`dense_block` call on the card: M =
    B·H·W pixel rows, the buffer's width ``ctot``, the scratch sizes in
    values (``a1``: M × the widest c, ``t2``: M × mid), the 3×3's
    ``tiles`` of :data:`TILE_PIXELS` pixels, and per layer its c, its offsets
    in values into g1/b1 (``bn1``), the flat W1 transposes (``w1t``), g2/b2
    (``bn2``) and the W2 transposes (``w2t``), and the product's ``gemm``
    plan (M × mid × c, ``ops/linear.py::gemm_plan``). Raises where the
    kernels do not take the block: c0 and growth multiples of 8 (16-byte
    rows), growth ≤ 32, mid a multiple of 16 up to 128, M·c/8 < 2^31."""
    if c0 <= 0 or c0 % 8 or growth <= 0 or growth % 8 or growth > MAX_GROWTH:
        raise ValueError(f"the bf16 kernels take c0 and growth multiples of 8, growth <= "
                         f"{MAX_GROWTH}; got {c0} and {growth}")
    if mid <= 0 or mid % 16 or mid > MAX_MID:
        raise ValueError(f"the bf16 kernels take mid a multiple of 16 up to {MAX_MID}, got {mid}")
    m = batch * h * w
    widest = c0 + (n_layers - 1) * growth
    if m * widest // 8 >= 2 ** 31:
        raise ValueError(f"the BN1-ReLU pass takes fewer than 2^31 vectors, got {m * widest // 8}")
    layers, off = [], 0
    for li in range(n_layers):
        c = c0 + li * growth
        layers.append({"c": c, "bn1": off, "w1t": off * mid, "bn2": li * mid,
                       "w2t": li * 9 * W2T_ROWS * -(-mid // W2T_K) * W2T_K,
                       "gemm": linear.gemm_plan(m, mid, c, 2)})
        off += c
    return {"m": m, "ctot": c0 + n_layers * growth, "a1": m * widest, "t2": m * mid,
            "tiles": -(-m // TILE_PIXELS), "layers": layers}


def bn_relu_reference(x, g1, b1) -> torch.Tensor:
    """Plain version of :func:`bn_relu`: relu(x·g1 + b1) in f32, cast to
    x's type."""
    return torch.relu(x.float() * g1.float() + b1.float()).to(x.dtype)


def conv3x3_reference(t2, w2) -> torch.Tensor:
    """Plain version of :func:`conv3x3`: the 3×3 of t2 (B, H, W, mid),
    zero-padded, by w2 (9·mid, g) tap-major, as nine tap products summed
    in f32 and cast once to t2's type."""
    b, h, w, mid = t2.shape
    tp = torch.nn.functional.pad(t2.float(), (0, 0, 1, 1, 1, 1))
    k2 = w2.to(t2.dtype).float().reshape(9, mid, -1)
    acc = torch.zeros((b, h, w, k2.shape[-1]), dtype=torch.float32, device=t2.device)
    for tap in range(9):
        ky, kx = divmod(tap, 3)
        acc = acc + torch.matmul(tp[:, ky:ky + h, kx:kx + w], k2[tap])
    return acc.to(t2.dtype)


@functools.lru_cache(maxsize=None)
def _launchers():
    """The bf16 layer's three entry points: the BN1-ReLU pass, the product
    (``linear_fused.cu``) and the 3×3."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    return (build.bind("dense_block", "dense_bn_relu_launch", [p] * 4 + [ll, i, i, p]),
            linear._launcher(),
            build.bind("dense_block", "dense_conv3x3_launch", [p] * 3 + [ll] + [i] * 6 + [p]))


@functools.lru_cache(maxsize=None)
def _f32_launcher():
    p, i = ctypes.c_void_p, ctypes.c_int
    return build.bind("dense_block", "dense_layer_f32_launch", [p] * 7 + [i] * 7 + [p])


def _check_bf16_stage(tensors, dev) -> None:
    for t, what, dtype in tensors:
        build.check_cuda_tensor(t, what, dtype)
        if t.device != dev:
            raise ValueError(f"{what} must be on {dev}, not {t.device}")
        build.check_aligned(t, what)


def bn_relu(buf, c: int, g1, b1) -> torch.Tensor:
    """Stage 1 of a bf16 layer: a1 (M, c) = T(relu(buf[..., :c]·g1 + b1))
    of the block buffer buf (B, H, W, Ctot), g1 and b1 (c,) f32. A CUDA
    tensor launches the BN1-ReLU pass (bf16, c and Ctot multiples of 8),
    which has no gradient of its own (differentiate :func:`dense_block`);
    CPU tensors run :func:`bn_relu_reference`."""
    ctot = buf.shape[-1]
    if tuple(g1.shape) != (c,) or tuple(b1.shape) != (c,) or not 0 < c <= ctot:
        raise ValueError(f"g1 and b1 must be ({c},) for c <= {ctot}")
    if buf.device.type == "cpu":
        return bn_relu_reference(buf[..., :c], g1, b1).reshape(-1, c)
    if c % 8 or ctot % 8:
        raise ValueError(f"the pass takes c and Ctot multiples of 8, got {c} and {ctot}")
    _check_bf16_stage(((buf, "buf", torch.bfloat16), (g1, "g1", torch.float32),
                       (b1, "b1", torch.float32)), buf.device)
    refuse_grad("bn_relu", "dense_block", buf, g1, b1)
    m = buf.numel() // ctot
    a1 = torch.empty((m, c), dtype=buf.dtype, device=buf.device)
    build.launch(_launchers()[0], buf.device, buf.data_ptr(), g1.data_ptr(), b1.data_ptr(),
                 a1.data_ptr(), m, ctot, c)
    dense_block.launches += 1
    return a1


def conv3x3(t2, w2, buf, c: int) -> torch.Tensor:
    """Stage 3 of a bf16 layer: the 3×3 of t2 (B, H, W, mid) by w2 (9·mid,
    g), zero-padded, written into channels [c, c + g) of the block buffer
    buf (B, H, W, Ctot) in place; returns buf. A CUDA tensor launches the
    implicit GEMM (bf16, mid a multiple of 16 up to 128, g a multiple of 8
    up to 32), which has no gradient of its own (differentiate
    :func:`dense_block`); CPU tensors run :func:`conv3x3_reference`."""
    b, h, w, mid = t2.shape
    g = w2.shape[-1]
    if tuple(w2.shape) != (9 * mid, g) or tuple(buf.shape[:3]) != (b, h, w) or (
            c + g > buf.shape[-1]):
        raise ValueError(f"w2 must be (9·{mid}, g) and buf (B, H, W, >= c + g) beside t2 "
                         f"{tuple(t2.shape)}")
    if t2.device.type == "cpu":
        buf[..., c:c + g] = conv3x3_reference(t2, w2)
        return buf
    if mid % 16 or mid > MAX_MID or g % 8 or g > MAX_GROWTH or c % 2 or buf.shape[-1] % 2:
        raise ValueError(f"the 3×3 takes mid a multiple of 16 up to {MAX_MID}, g a multiple "
                         f"of 8 up to {MAX_GROWTH} and even c and Ctot")
    _check_bf16_stage(((t2, "t2", torch.bfloat16), (w2, "w2", torch.bfloat16),
                       (buf, "buf", torch.bfloat16)), t2.device)
    refuse_grad("conv3x3", "dense_block", t2, w2, buf)
    m = b * h * w
    w2t = pack_w2t(w2, growth=g, n_layers=1, mid=mid)
    build.launch(_launchers()[2], t2.device, t2.data_ptr(), w2t.data_ptr(),
                 buf.data_ptr() + c * buf.element_size(), m, h, w, buf.shape[-1], mid, g,
                 -(-m // TILE_PIXELS))
    dense_block.launches += 1
    return buf


def dense_block_stages(x, g1, b1, w1, g2, b2, w2, *, c0: int, growth: int, n_layers: int,
                       mid: int = 128) -> torch.Tensor:
    """The bf16 path of :func:`dense_block` stage by stage through the
    stages' wrappers, in the kernels' order: :func:`bn_relu`, the product
    ``linear_fused(a1, W1ᵀ, b2, scale=g2, act="relu")`` on each layer's
    (mid, c) transpose, :func:`conv3x3`. On CPU tensors every stage is its
    plain version, so this is the plain version of the three launches."""
    _check(x, g1, b1, w1, g2, b2, w2, c0, growth, n_layers, mid)
    bsz, h, w, _ = x.shape
    buf = torch.empty((bsz, h, w, c0 + n_layers * growth), dtype=x.dtype, device=x.device)
    buf[..., :c0] = x
    w1t = pack_w1t(w1.to(x.dtype), c0=c0, growth=growth, n_layers=n_layers, mid=mid)
    g1, b1, g2, b2 = (t.float() for t in (g1, b1, g2, b2))
    off = 0
    for li in range(n_layers):
        c = c0 + li * growth
        a1 = bn_relu(buf, c, g1[0, off:off + c], b1[0, off:off + c])
        t2 = linear.linear_fused(a1, w1t[off * mid:(off + c) * mid].view(mid, c), b2[li],
                                 scale=g2[li], act="relu")
        conv3x3(t2.view(bsz, h, w, mid), w2[li * 9 * mid:(li + 1) * 9 * mid].to(x.dtype), buf,
                c)
        off += c
    return buf


def dense_block(x, g1, b1, w1, g2, b2, w2, *, c0: int, growth: int, n_layers: int,
                mid: int = 128, w1t=None, w2t=None) -> torch.Tensor:
    """K12: a whole dense block on x (B, H, W, c0) in bf16 or f32 →
    (B, H, W, c0 + n_layers·growth), the packed parameters as
    :func:`dense_block_reference` takes them (W1 and W2 cast to x's type,
    the affines to f32). ``w1t``, ``w2t``: the transposes of W1 and W2 as
    :func:`pack_w1t` and :func:`pack_w2t` make them, in x's type, made here
    when None (bf16 only). CUDA tensors run ``csrc/dense_block.cu`` (bf16:
    three launches a layer; f32: one), the whole call differentiable as the
    plain version (``ops/plain_grad.py``, the JAX package's vjp of its
    reference; ``w1t`` and ``w2t`` are read by the kernels only); CPU
    tensors run the plain version."""
    if x.device.type == "cpu":
        return dense_block_reference(x, g1, b1, w1, g2, b2, w2, c0=c0, growth=growth,
                                     n_layers=n_layers, mid=mid)
    _check(x, g1, b1, w1, g2, b2, w2, c0, growth, n_layers, mid)
    if x.dtype not in build.DTYPE_CODE:
        raise TypeError(f"x must be bfloat16 or float32, not {x.dtype}")
    if mid > MAX_MID or growth > MAX_GROWTH:
        raise ValueError(f"the kernel takes mid <= {MAX_MID} and growth <= {MAX_GROWTH}, "
                         f"got {mid} and {growth}")
    shape = dict(c0=c0, growth=growth, n_layers=n_layers, mid=mid)
    return plain_grad(functools.partial(_dense_block_launch, **shape, w1t=w1t, w2t=w2t),
                      functools.partial(dense_block_reference, **shape), x, g1, b1, w1, g2, b2,
                      w2)


def _dense_block_launch(x, g1, b1, w1, g2, b2, w2, *, c0: int, growth: int, n_layers: int,
                        mid: int, w1t, w2t) -> torch.Tensor:
    """The launches of one :func:`dense_block` call on CUDA tensors."""
    bsz, h, w, _ = x.shape
    bf16 = x.dtype == torch.bfloat16
    plan = block_plan(bsz, h, w, c0=c0, growth=growth, n_layers=n_layers, mid=mid) if bf16 else None
    w1, w2 = w1.to(x.dtype).contiguous(), w2.to(x.dtype).contiguous()
    g1, b1, g2, b2 = (t.float().contiguous() for t in (g1, b1, g2, b2))
    if bf16 and w1t is None:
        w1t = pack_w1t(w1, c0=c0, growth=growth, n_layers=n_layers, mid=mid)
    if bf16 and w2t is None:
        w2t = pack_w2t(w2, growth=growth, n_layers=n_layers, mid=mid)
    build.check_cuda_tensor(x, "x", x.dtype)
    params = [(w1, "w1"), (w2, "w2"), (g1, "g1"), (b1, "b1"), (g2, "g2"), (b2, "b2")]
    if bf16:
        w2t_shape = (n_layers, 9, -(-mid // W2T_K), W2T_ROWS, W2T_K)
        if tuple(w1t.shape) != (w1.numel(),) or tuple(w2t.shape) != w2t_shape:
            raise ValueError(f"w1t and w2t must be ({w1.numel()},) and {w2t_shape}, got "
                             f"{tuple(w1t.shape)} and {tuple(w2t.shape)}")
        for t, what in ((w1t, "w1t"), (w2t, "w2t")):
            build.check_cuda_tensor(t, what, x.dtype)
            params.append((t, what))
    for t, what in params:
        if t.device != x.device:
            raise ValueError(f"{what} must be on {x.device}, not {t.device}")
        if bf16:
            build.check_aligned(t, what)
    ctot = c0 + n_layers * growth
    buf = torch.empty((bsz, h, w, ctot), dtype=x.dtype, device=x.device)
    buf[..., :c0] = x
    dense_block.calls += 1
    if buf.numel() == 0:
        return buf
    if bf16:
        _run_bf16(buf, plan, g1, b1, w1t, g2, b2, w2t, h, w, mid, growth)
        return buf
    off = 0
    for li in range(n_layers):
        c = c0 + li * growth
        build.launch(_f32_launcher(), x.device, buf.data_ptr(), g1.data_ptr() + off * 4,
                     b1.data_ptr() + off * 4, w1.data_ptr() + off * mid * 4,
                     g2.data_ptr() + li * mid * 4, b2.data_ptr() + li * mid * 4,
                     w2.data_ptr() + li * 9 * mid * growth * 4, bsz, h, w, ctot, c, mid,
                     growth)
        dense_block.launches += 1
        off += c
    return buf


def _run_bf16(buf, plan, g1, b1, w1t, g2, b2, w2t, h, w, mid, growth) -> None:
    """The bf16 layers: the scratch once, every launch's arguments worked out
    from ``plan``, then three ctypes calls a layer."""
    dev = buf.device
    a1 = torch.empty(plan["a1"], dtype=buf.dtype, device=dev)
    t2 = torch.empty(plan["t2"], dtype=buf.dtype, device=dev)
    pass_fn, gemm_fn, conv_fn = _launchers()
    m, ctot = plan["m"], plan["ctot"]
    bp, a1p, t2p = buf.data_ptr(), a1.data_ptr(), t2.data_ptr()
    g1p, b1p, g2p, b2p = (t.data_ptr() for t in (g1, b1, g2, b2))
    w1p, w2p = w1t.data_ptr(), w2t.data_ptr()
    calls = []
    for lay in plan["layers"]:
        c, bn1, bn2 = lay["c"], 4 * lay["bn1"], 4 * lay["bn2"]
        calls += [
            (pass_fn, (bp, g1p + bn1, b1p + bn1, a1p, m, ctot, c)),
            (gemm_fn, (a1p, w1p + 2 * lay["w1t"], b2p + bn2, None, g2p + bn2, None, None, 0.0,
                       t2p, None, m, mid, c, linear.SCALE_RELU, 1, *lay["gemm"]["box"],
                       *lay["gemm"]["tiles"])),
            (conv_fn, (t2p, w2p + 2 * lay["w2t"], bp + 2 * c, m, h, w, ctot, mid, growth,
                       plan["tiles"])),
        ]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for fn, args in calls:
            err = fn(*args, stream)
            if err != 0:
                raise RuntimeError(f"{fn.__name__} failed with cudaError {err}")
            dense_block.launches += 1


dense_block.calls = 0
dense_block.launches = 0
