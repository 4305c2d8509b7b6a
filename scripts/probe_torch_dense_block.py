#!/usr/bin/env python3
"""Design study of the PyTorch port's dense block (K12) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a card:

    python3 scripts/probe_torch_dense_block.py

It prints, with the card's name and power limit:

1. for each of DenseNet-121's dense blocks at B = 128 in bf16, the device
   time of each of K12's three kernels summed over one call
   (``torch.profiler``, after a second of work that lets the card's clocks
   rise): the BN1-ReLU pass, the 1×1 product (``linear_fused.cu``'s
   ``gemm_bf16_kernel<5>``) and the 3×3, with their launches and the bytes
   each must move at that call's widths (each input read once, each output
   written once) over its time;
2. the 3×3 alone at block 1's shape (128 × 56², mid 128 → 32) as built
   and in variants built from the same source with one part taken out: no
   wgmma, no ldmatrix (the A registers from a constant), no loads of the
   tap rows (the outputs of these are wrong; they time what is left). Each
   variant is one ``nvcc`` of an edited copy under
   ``build/probe_kernels/``;
3. the 1×1 product alone (``linear_fused(..., scale=g2, act="relu")``) at
   block 1's first layer (401,408 × 64 → 128) and block 3's and block 4's
   last (25,088 and 6,272 × 992 → 128), against its bytes' floor;
4. the host's time a launch: each of the three entry points called 2,000
   times back to back through ctypes at a tiny layer (one 8 × 8 image, c
   64), with no synchronisation between calls, against the card's time for
   the same launches (CUDA events), and ``dense_block`` itself at that
   size: where the host's time is the larger, the host sets the pace.

It exits non-zero without a card.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

BLOCKS = (("block 1", 56, 64, 6), ("block 2", 28, 128, 12), ("block 3", 14, 256, 24),
          ("block 4", 7, 512, 16))
GROWTH, MID, BATCH = 32, 128, 128
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
KERNELS = {"bn_relu_bf16_kernel": "BN1-ReLU pass", "gemm_bf16_kernel<5>": "1x1 product",
           "conv3x3_bf16_kernel": "3x3"}
OUT = ROOT / "build" / "probe_kernels"
# (name, [(text in dense_block.cu, its replacement)]); every text must be found
VARIANTS = [
    ("as built", []),
    ("no wgmma", [("""    wgmma_m64n32k16_rs(acc, af[ks], smem_desc(wt + (ks / 4) * NB * 128) + 2 * (ks % 4));""",
                   "")]),
    ("no ldmatrix", [("""    ldmatrix_x4(af[ks], rows + (lane % 16) * LDA + ks * 16 + (lane / 16) * 8);""",
                      """    af[ks][0] = af[ks][1] = af[ks][2] = af[ks][3] = 0x3f803f80u + ks;""")]),
    ("no tap-row loads", [("""      cp_async16(dst + r * LDA + ch * 8, p.t2 + (in ? static_cast<int64_t>(q) * MID + ch * 8 : 0),
                 in);""", "")]),
]


def warm_up(seconds: float = 1.0) -> None:
    a = torch.randn((4096, 4096), device="cuda", dtype=torch.bfloat16)
    t = time.time()
    while time.time() - t < seconds:
        a @ a
    torch.cuda.synchronize()


def block_inputs(b: int, hw: int, c0: int, layers: int, gen) -> tuple:
    """x and the packed parameters of one block, as chip_smoke.py makes them."""
    s = sum(c0 + li * GROWTH for li in range(layers))

    def arr(*shape, scale=1.0):
        return torch.randn(shape, device="cuda", generator=gen) * scale

    x = arr(b, hw, hw, c0).to(torch.bfloat16)
    params = (torch.rand((1, s), device="cuda", generator=gen) + 0.5, arr(1, s, scale=0.1),
              arr(s, MID, scale=(c0 + (layers - 1) * GROWTH) ** -0.5).to(torch.bfloat16),
              torch.rand((layers, MID), device="cuda", generator=gen) + 0.5,
              arr(layers, MID, scale=0.1),
              arr(layers * 9 * MID, GROWTH, scale=(9 * MID) ** -0.5).to(torch.bfloat16))
    return x, params, dict(c0=c0, growth=GROWTH, n_layers=layers, mid=MID)


def transposes(params: tuple, kw: dict) -> dict:
    """W1's and W2's transposes, packed once as the model packs them."""
    from robustart_torch.ops import densenet

    shape = {k: kw[k] for k in ("growth", "n_layers", "mid")}
    return {"w1t": densenet.pack_w1t(params[2], c0=kw["c0"], **shape),
            "w2t": densenet.pack_w2t(params[5], **shape)}


def kernel_times(fn) -> dict:
    """{kernel name: (launches, device ms)} of one call of ``fn``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out: dict[str, list] = {}
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        name = next((k for k in KERNELS if k in e.key), "other")
        slot = out.setdefault(name, [0, 0.0])
        slot[0] += e.count
        slot[1] += e.self_device_time_total / 1e3
    return out


def probe_blocks(card: str) -> None:
    from robustart_torch.ops import densenet

    gen = torch.Generator(device="cuda").manual_seed(0)
    for label, hw, c0, layers in BLOCKS:
        x, params, kw = block_inputs(BATCH, hw, c0, layers, gen)
        t = transposes(params, kw)
        times = kernel_times(lambda: densenet.dense_block(x, *params, **t, **kw))
        m = BATCH * hw * hw
        cs = [c0 + li * GROWTH for li in range(layers)]
        nbytes = {"bn_relu_bf16_kernel": sum(4 * m * c for c in cs),
                  "gemm_bf16_kernel<5>": sum(2 * m * c + 2 * m * MID for c in cs),
                  "conv3x3_bf16_kernel": sum(2 * m * MID + 2 * m * GROWTH for _ in cs)}
        total = sum(ms for _, ms in times.values())
        parts = []
        for name, what in KERNELS.items():
            n, ms = times.get(name, (0, 0.0))
            rate = nbytes[name] / (ms * 1e-3) / 1e9 if ms else float("nan")
            floor = nbytes[name] / HBM_BYTES_PER_S * 1e3
            parts.append(f"{what} {ms:.4f} ms in {n} launches ({rate:.0f} GB/s; its bytes' floor "
                         f"{floor:.4f} ms)")
        other = times.get("other", (0, 0.0))
        print(f"[probe] K12 DenseNet-121 {label} {BATCH}x{hw}x{hw}x{c0} bf16, device time "
              f"{total:.4f} ms: " + "; ".join(parts) + f"; other {other[1]:.4f} ms in "
              f"{other[0]} launches | {card}")


def build_variants() -> dict:
    """One library per variant of dense_block.cu, all nvcc started together."""
    from robustart_torch.ops import build

    source = (build.CSRC / "dense_block.cu").read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, edits) in enumerate(VARIANTS):
        text = source
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"variant {name!r}: its text is not in dense_block.cu")
            text = text.replace(old, new)
        cu = OUT / f"dense_block_v{i}.cu"
        cu.write_text(text)
        so = cu.with_suffix(".so")
        procs[name] = (subprocess.Popen([build.nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
                                         "-o", str(so), str(cu)], stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"variant {name!r} does not build:\n{log}")
        fn = ctypes.CDLL(str(so)).dense_conv3x3_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 3 + [ctypes.c_longlong] + [i] * 6 + [p]
        libs[name] = fn
    return libs


def probe_conv(card: str) -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from robustart_torch.ops import densenet

    libs = build_variants()
    gen = torch.Generator(device="cuda").manual_seed(2)
    b, hw, c, ctot = BATCH, 56, 224, 256
    m = b * hw * hw
    t2 = torch.randn((m, MID), device="cuda", generator=gen).to(torch.bfloat16)
    w2 = (torch.randn((9 * MID, GROWTH), device="cuda", generator=gen) * 0.03).to(torch.bfloat16)
    w2t = densenet.pack_w2t(w2, growth=GROWTH, n_layers=1, mid=MID)
    buf = torch.zeros((m, ctot), dtype=torch.bfloat16, device="cuda")
    tiles = -(-m // densenet.TILE_PIXELS)
    floor = (2 * m * MID + 2 * m * GROWTH) / HBM_BYTES_PER_S * 1e3
    for name, fn in libs.items():
        def call():
            err = fn(t2.data_ptr(), w2t.data_ptr(), buf.data_ptr() + 2 * c, m, hw, hw, ctot, MID,
                     GROWTH, tiles, torch.cuda.current_stream().cuda_stream)
            if err:
                raise SystemExit(f"variant {name!r} failed with cudaError {err}")
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                call()
            torch.cuda.synchronize()
        ms = sum(e.self_device_time_total for e in prof.key_averages()
                 if getattr(e, "device_type", None) == DeviceType.CUDA) / 1e3 / 20
        print(f"[probe] K12 3x3 {b}x{hw}x{hw}, mid {MID} -> {GROWTH}, variant {name}: {ms:.4f} ms "
              f"(its bytes' floor {floor:.4f} ms) | {card}")


def probe_product(card: str) -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from robustart_torch.ops import linear

    gen = torch.Generator(device="cuda").manual_seed(3)
    for label, m, k in (("block 1, layer 1", BATCH * 56 * 56, 64),
                        ("block 3, layer 24", BATCH * 14 * 14, 992),
                        ("block 4, layer 16", BATCH * 7 * 7, 992)):
        a1 = torch.randn((m, k), device="cuda", generator=gen).to(torch.bfloat16)
        w = (torch.randn((MID, k), device="cuda", generator=gen) * k ** -0.5).to(torch.bfloat16)
        scale = torch.rand(MID, device="cuda", generator=gen) + 0.5
        shift = torch.randn(MID, device="cuda", generator=gen) * 0.1
        linear.linear_fused(a1, w, shift, scale=scale, act="relu")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                linear.linear_fused(a1, w, shift, scale=scale, act="relu")
            torch.cuda.synchronize()
        ms = sum(e.self_device_time_total for e in prof.key_averages()
                 if getattr(e, "device_type", None) == DeviceType.CUDA) / 1e3 / 20
        nbytes = 2 * m * k + 2 * MID * k + 2 * m * MID
        print(f"[probe] K12 1x1 product {label}, {m} x {k} -> {MID}: {ms:.4f} ms, "
              f"{nbytes / (ms * 1e-3) / 1e9:.0f} GB/s (its bytes' floor "
              f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms), {-(-m // 128)} tiles of 128 rows | "
              f"{card}")


def probe_host(card: str) -> None:
    from robustart_torch.ops import densenet, linear

    gen = torch.Generator(device="cuda").manual_seed(1)
    layers = 16
    x, params, kw = block_inputs(1, 8, 64, layers, gen)
    packed = transposes(params, kw)
    plan = densenet.block_plan(1, 8, 8, **kw)
    buf = torch.zeros((1, 8, 8, plan["ctot"]), dtype=torch.bfloat16, device="cuda")
    a1 = torch.empty(plan["a1"], dtype=torch.bfloat16, device="cuda")
    t2 = torch.empty(plan["t2"], dtype=torch.bfloat16, device="cuda")
    g1, b1, _, g2, b2, _ = params
    lay, m = plan["layers"][0], plan["m"]
    pass_fn, gemm_fn, conv_fn = densenet._launchers()
    stream = torch.cuda.current_stream().cuda_stream
    calls = {
        "BN1-ReLU pass": (pass_fn, (buf.data_ptr(), g1.data_ptr(), b1.data_ptr(), a1.data_ptr(),
                                    m, plan["ctot"], 64, stream)),
        "1x1 product": (gemm_fn, (a1.data_ptr(), packed["w1t"].data_ptr(), b2.data_ptr(), None,
                                  g2.data_ptr(), None, None, 0.0, t2.data_ptr(), None, m, MID, 64,
                                  linear.SCALE_RELU, 1, *lay["gemm"]["box"],
                                  *lay["gemm"]["tiles"], stream)),
        "3x3": (conv_fn, (t2.data_ptr(), packed["w2t"].data_ptr(), buf.data_ptr() + 128, m, 8, 8,
                          plan["ctot"], MID, GROWTH, plan["tiles"], stream)),
    }
    n = 2000
    for what, (fn, args) in calls.items():
        for _ in range(20):
            assert fn(*args) == 0
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        start.record()
        for _ in range(n):
            fn(*args)
        host = (time.perf_counter() - t) / n * 1e6
        end.record()
        torch.cuda.synchronize()
        dev = start.elapsed_time(end) / n * 1e3
        print(f"[probe] K12 host per launch, {what} at 1x8x8 (c 64): host {host:.2f} us a "
              f"ctypes call, card {dev:.2f} us a launch back to back | {card}")
    reps = 100
    fn = lambda: densenet.dense_block(x, *params, **packed, **kw)  # noqa: E731
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t) / reps * 1e6
    torch.cuda.synchronize()
    print(f"[probe] K12 host per dense_block call at 1x8x8, c0 64, {layers} layers "
          f"({3 * layers} launches): {host:.1f} us, {host / (3 * layers):.2f} us a launch | {card}")


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_torch_dense_block: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(f"[device] {card}; torch {torch.__version__} CUDA {torch.version.cuda}")
    from robustart_torch.ops import build

    build.build(("dense_block", "linear_fused"))
    warm_up()
    probe_blocks(card)
    probe_conv(card)
    probe_product(card)
    probe_host(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
