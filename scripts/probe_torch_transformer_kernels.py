#!/usr/bin/env python3
"""Design study of the PyTorch port's transformer kernels on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a card:

    python3 scripts/probe_torch_transformer_kernels.py

It prints, with the card's name and power limit, device times (the
``torch.profiler`` sum of one call's kernels, over 30 calls, after a
second of work that lets the card's clocks rise):

1. the bf16 attention core (``robustart_torch/csrc/attention_core.cu``)
   at DeiT-Tiny's 128×197×3×64, CLIP-L/14's 128×257×16×64 and Swin-T's
   8192×49×3×32 windows, beside ``scaled_dot_product_attention`` (and the
   name of the kernel it runs), and variants of the core built from the
   same source with one part taken out or one constant changed: no Q·Kᵀ
   product, no P·V product, no exponentials, no K/V loads (the outputs of
   these are wrong; they time what is left) and the registers left
   uncapped at D = 64. Each variant is one ``nvcc`` of an edited
   copy under ``build/probe_kernels/``;
2. the bf16 product (``csrc/linear_fused.cu``) at ViT-B's fc1 and fc2
   shapes with no activation, with GELU, with the LayerNorm pass and GELU,
   and with a residual, beside ``torch.matmul`` on the bare product.

It exits non-zero without a card.
"""

from __future__ import annotations

import ctypes
import math
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

OUT = ROOT / "build" / "probe_kernels"
BOUNDS = "__global__ void __launch_bounds__(kThreads, blocks_per_sm(DP)) attention_bf16_kernel"
# (name, [(text in the source, its replacement)]); every text must be found
VARIANTS = [
    ("as built", []),
    ("no Q·Kᵀ", [("""          mma(s[2 * jj], qf[kk], b[0], b[1]);
          mma(s[2 * jj + 1], qf[kk], b[2], b[3]);""", "")]),
    ("no P·V", [("""          mma(o[2 * dd], pf, b[0], b[1]);
          mma(o[2 * dd + 1], pf, b[2], b[3]);""", "")]),
    ("no exponentials", [("""          s[i][2 * h] = ex2(fmaf(s[i][2 * h], kLog2e, -ml));
          s[i][2 * h + 1] = ex2(fmaf(s[i][2 * h + 1], kLog2e, -ml));""", "")]),
    ("no K/V loads", [("""      load_tile<DP>(sK + (j % kSlots) * TILE, kg, j * BKV, n, d, a.tok_in);
      load_tile<DP>(sV + (j % kSlots) * TILE, vg, j * BKV, n, d, a.tok_in);""", "")]),
    ("registers uncapped", [(BOUNDS, BOUNDS.replace(", blocks_per_sm(DP)", ""))]),
]


def warm_up(seconds: float = 1.0) -> None:
    """Keep the card busy for a while, so that its clocks have risen before
    the first measurement."""
    import time

    a = torch.randn((8192, 8192), device="cuda").to(torch.bfloat16)
    t = time.time()
    while time.time() - t < seconds:
        for _ in range(10):
            a @ a
        torch.cuda.synchronize()


def device_ms(fn, iters: int = 30) -> tuple[float, list[str]]:
    """Device time of one call and the names of the kernels it ran."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if getattr(e, "device_type", None) == DeviceType.CUDA]
    return (sum(e.self_device_time_total for e in events) / 1e3 / iters,
            [e.key[:100] for e in events])


def build_variants() -> dict:
    """One library per variant of the core, all nvcc started together."""
    from robustart_torch.ops import build

    source = (build.CSRC / "attention_core.cu").read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, edits) in enumerate(VARIANTS):
        text = source
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"variant {name!r}: its text is not in attention_core.cu")
            text = text.replace(old, new)
        cu = OUT / f"attention_v{i}.cu"
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
        fn = ctypes.CDLL(str(so)).attention_core_launch
        p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        fn.argtypes = [p] * 6 + [i] * 7 + [ll] * 4 + [f, f, i, i, p]
        libs[name] = fn
    return libs


def probe_attention(card: str) -> None:
    import torch.nn.functional as F

    from robustart_torch.ops import attention

    libs = build_variants()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for b, n, h, d in ((128, 197, 3, 64), (128, 257, 16, 64), (8192, 49, 3, 32)):
        q, k, v = (torch.randn((b, n, h, d), device="cuda", generator=gen).to(torch.bfloat16)
                   for _ in range(3))
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        lib_ms, lib_names = device_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
        ours_ms, _ = device_ms(lambda: attention.mha(q, k, v))
        print(f"[attention {b}x{n}x{h}x{d}] mha {ours_ms:.4f} ms; scaled_dot_product_attention "
              f"{lib_ms:.4f} ms ({', '.join(lib_names)}) | {card}")
        plan = attention.core_plan(n, d)
        out = torch.empty_like(q)
        for name, fn in libs.items():
            def call():
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None, None, b,
                         n, h, d, plan["head_dim_padded"], plan["query_tiles"], 1, q.stride(1),
                         q.stride(0), h * d, n * h * d, 1.0, 1.0 / math.sqrt(d), 0, 1,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise SystemExit(f"variant {name!r} failed with cudaError {err}")
            print(f"[attention {b}x{n}x{h}x{d}] variant {name}: {device_ms(call)[0]:.4f} ms "
                  f"| {card}")


def probe_product(card: str) -> None:
    from robustart_torch.ops.linear import linear_fused

    gen = torch.Generator(device="cuda").manual_seed(1)
    m = 128 * 197
    for name, k, n in (("ViT-B fc1", 768, 3072), ("ViT-B fc2", 3072, 768)):
        x = torch.randn((m, k), device="cuda", generator=gen).to(torch.bfloat16)
        w = (torch.randn((n, k), device="cuda", generator=gen) * k ** -0.5).to(torch.bfloat16)
        bias = torch.randn(n, device="cuda", generator=gen) * 0.1
        res = torch.randn((m, n), device="cuda", generator=gen).to(torch.bfloat16)
        ln = (torch.rand(k, device="cuda", generator=gen) + 0.5,
              torch.randn(k, device="cuda", generator=gen) * 0.1)
        flops = 2 * m * n * k
        forms = {"no activation": {}, "GELU": {"act": "gelu"},
                 "LN pass and GELU": {"ln": ln, "act": "gelu"}, "residual": {"residual": res}}
        for form, kw in forms.items():
            ms, _ = device_ms(lambda: linear_fused(x, w, bias, **kw))
            print(f"[product {name} {m}x{k}x{n}] {form}: {ms:.4f} ms = "
                  f"{flops / ms / 1e9:.1f} TFLOP/s | {card}")
        ms, _ = device_ms(lambda: torch.matmul(x, w.t()))
        print(f"[product {name} {m}x{k}x{n}] torch.matmul on the bare product: {ms:.4f} ms = "
              f"{flops / ms / 1e9:.1f} TFLOP/s | {card}")


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_torch_transformer_kernels: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    warm_up()
    probe_attention(card)
    probe_product(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
