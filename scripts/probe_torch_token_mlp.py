#!/usr/bin/env python3
"""The PyTorch port's token-mixing MLP (K10) on one NVIDIA GPU, part by part.

Run from the root of a checkout, on a machine with a card:

    python3 scripts/probe_torch_token_mlp.py           # checks, then times
    python3 scripts/probe_torch_token_mlp.py --check   # checks only
    python3 scripts/probe_torch_token_mlp.py --parts   # checks, times, variants

It prints, with the card's name and power limit:

1. ptxas's registers, shared memory and spills of every kernel of
   ``csrc/token_mlp.cu`` (``nvcc -Xptxas -v``), and any line of its log
   that names wgmma (ptxas says there where it serializes the products);
2. the bf16 K10 against its plain version (one bf16 ulp of max|ref|) at
   Mixer-B/16's shape (128 × 196 × 768, hidden 384) and Mixer-L/16's (128
   × 196 × 1024, hidden 512), in the Mixer's form, and at ragged shapes (T
   49, 50, 256; C 20, 96; H 40) in all three residual forms;
3. without ``--check``, at Mixer-B/16 and Mixer-L/16: K10 a call, the
   statistics pass alone and the fused kernel alone, by CUDA events over
   back-to-back calls after a second of work (the card's clocks rise over
   the first second) and by ``torch.profiler``'s device time of one call;
   each against its bound (the larger of its bytes over 3.35 TB/s and its
   products over 989 TFLOP/s; each input read once, each output written
   once); and ``torch.matmul``'s two batched bf16 products of the same
   shapes (x̂ᵀ·W1ᵀ, then W2·aᵀ, no LN or activation), a yardstick the port
   never calls;
4. with ``--parts``, the fused kernel at Mixer-B/16 built from edited
   copies of ``token_mlp.cu`` (one ``nvcc`` each under
   ``build/probe_kernels/``), each with one part taken out (the outputs of
   these are wrong; they time what is left), and as built with no
   activation (act code 0), by CUDA events.

It exits non-zero without a card or where a check fails.
"""

from __future__ import annotations

import argparse
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
BF16_FLOPS_PER_S = 989e12  # H100 SXM, dense
SHAPES = {"Mixer-B/16": (128, 196, 768, 384), "Mixer-L/16": (128, 196, 1024, 512),
          "128 tokens": (128, 128, 768, 384), "256 tokens": (128, 256, 768, 384)}
RAGGED = [(3, 49, 20, 40), (3, 50, 96, 40), (3, 256, 96, 40), (2, 196, 20, 384)]
OUT = ROOT / "build" / "probe_kernels"
# (name, [(text in token_mlp.cu, its replacement)]); every text must be found
VARIANTS = [
    ("as built", []),
    ("no first product", [("      wgmma_m64n64k16_ta(u, da_k + 128 * j, db1 + 512 * (j / 4) + 2 * (j % 4));",
                           "")]),
    ("no second product", [("    for (int ks = 0; ks < 4; ++ks) wgmma_rs<TP>(y, a[ks], db2 + 2 * ks);",
                            "")]),
    ("first product untransposed", [('"}, %32, %33, p, 1, 1, 1, 0;\\n}\\n"', '"}, %32, %33, p, 1, 1, 0, 0;\\n}\\n"')]),
    ("no x tile staged", [("  stage_tile<TP, TP / 16>(p, p.x, row0, c0, tile, p.ln_w != nullptr, wl);",
                           "")]),
    ("no epilogue", [("      if (p.residual) stage_tile<TP, S::kResGroup>(p, p.residual, row0, c0, tile, false, wl);",
                      ""), ("    if (t >= p.t) continue;", "    if (t >= 0) continue;")]),
    # globaltimer stamps of each block's warpgroups (start, x^ staged, the
    # chunks' loop done, the epilogue done) and its SM, written over the
    # output in place of the tile's stores
    ("timeline", [("  const int c0 = blockIdx.x * kTokChannels + wg * 64;",
                   """  const int c0 = blockIdx.x * kTokChannels + wg * 64;
  unsigned long long* stamps = reinterpret_cast<unsigned long long*>(p.out) +
                               ((blockIdx.y * gridDim.x + blockIdx.x) * 2 + wg) * 12;
  auto stamp = [&](int i) {
    unsigned long long v;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(v));
    if (wl == 0) stamps[i] = v;
  };
  stamp(0);"""),
                  ("  named_sync(1 + wg, 128);\n\n  // y^T", "  named_sync(1 + wg, 128);\n  stamp(1);\n\n  // y^T"),
                  ("  }\n\n#pragma unroll\n  for (int e = 0; e < TP / 2; ++e) fence_operand(y[e]);", "  }\n  stamp(2);\n\n#pragma unroll\n  for (int e = 0; e < TP / 2; ++e) fence_operand(y[e]);"),
                  ("    if (t >= p.t) continue;", "    if (t >= 0) continue;"),
                  ("""    activate(k, u);
    release_w1(k);
    second(k);
    first(k + 1, u);
""", """    if (k == 2) stamp(5);
    activate(k, u);
    release_w1(k);
    if (k == 2) stamp(6);
    second(k);
    if (k == 2) stamp(7);
    first(k + 1, u);
    if (k == 2) stamp(8);
"""),
                  ("""    wgmma_wait<0>();  // P2(k) and P1(k + 1)
""", """    wgmma_wait<0>();  // P2(k) and P1(k + 1)
    if (k == 2) stamp(9);
"""),
                  ("""  named_sync(1 + wg, 128);  // the residual's tile is in
""", """  named_sync(1 + wg, 128);  // the residual's tile is in
  stamp(10);
"""),
                  ("""  named_sync(1 + wg, 128);

  // the tile out""", """  named_sync(1 + wg, 128);
  stamp(11);

  // the tile out"""),
                  ("""        if (c + jj < p.c) dst[jj] = e[jj];
      }
    }
  }
}""", """        if (c + jj < p.c) dst[jj] = e[jj];
      }
    }
  }
  stamp(3);
  if (wl == 0) {
    unsigned int sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    stamps[4] = sm;
  }
}""")]),
    ("no weight loads", [("""  mbar_expect_tx(full, TokShape<TP>::kW1Bytes + 256);
  for (int kb = 0; kb < TokShape<TP>::kKBlocks; ++kb) {
    tma_load(dst + kb * 8192, map, kb * 64, k * kTokHidden, full);
  }
  tma_load(bias, map_b1, k * kTokHidden, 0, full);""", "  mbar_arrive(full);"), ("""  mbar_expect_tx(full, TokShape<TP>::kW2Bytes);
  tma_load(dst, map, k * kTokHidden, 0, full);""", "  mbar_arrive(full);")]),
]


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def inputs(b, t, c, h, gen):
    def arr(*shape, s=1.0):
        return torch.randn(shape, device="cuda", generator=gen) * s

    return dict(x=arr(b, t, c).to(torch.bfloat16), ln=(arr(c, s=0.2) + 1.0, arr(c, s=0.1)),
                w1=arr(h, t, s=t ** -0.5).to(torch.bfloat16), b1=arr(h, s=0.05),
                w2=arr(t, h, s=h ** -0.5).to(torch.bfloat16), b2=arr(t, s=0.05),
                shortcut=arr(b, t, c).to(torch.bfloat16))


def within(name, got, ref) -> float:
    top = float(ref.float().abs().max())
    err = float((got.float() - ref.float()).abs().max())
    ulp = 2.0 ** (math.floor(math.log2(top)) - 7)
    print(f"[check] {name}: max|d| {err:.3e}, one bf16 ulp of max|ref| {ulp:.3e}")
    if not err <= ulp:
        raise SystemExit(f"probe_torch_token_mlp: {name} disagrees with the plain version")
    return err


def events_ms(fn, iters=20) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters=10) -> dict[str, float]:
    """Device time of one ``fn()`` by kernel name (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out: dict[str, float] = {}
    for e in prof.key_averages():
        if getattr(e, "device_type", None) == DeviceType.CUDA:
            name = re.sub(r"^void |\(anonymous namespace\)::|\(.*$", "", e.key)
            out[name] = out.get(name, 0.0) + e.self_device_time_total / 1e3 / iters
    return out


def warm(seconds=1.0) -> None:
    a = torch.randn((8192, 8192), device="cuda", dtype=torch.bfloat16)
    t = time.time()
    while time.time() - t < seconds:
        a @ a
    torch.cuda.synchronize()


def sass(build) -> None:
    """The fused kernel's SASS at Tp 208 (cuobjdump) into
    chiprun_out/token_mlp_208.sass, and a count of its instructions by
    opcode, the tensor-core ones (HGMMA) and the waits among them first."""
    out = subprocess.run([str(Path(build.nvcc()).parent / "cuobjdump"), "-sass",
                          str(build.library_path("token_mlp"))], capture_output=True, text=True,
                         timeout=120).stdout
    keep, lines = False, []
    for line in out.splitlines():
        if "Function :" in line:
            keep = "token_mlp_bf16_kernelILi208" in line
        if keep:
            lines.append(line)
    dest = ROOT / "chiprun_out" / "token_mlp_208.sass"
    dest.parent.mkdir(exist_ok=True)
    dest.write_text("\n".join(lines))
    ops: dict[str, int] = {}
    for line in lines:
        m = re.search(r"\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
        if m:
            ops[m.group(1)] = ops.get(m.group(1), 0) + 1
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:25]
    print(f"[sass] token_mlp_bf16_kernel<208>: {sum(ops.values())} instructions; "
          + ", ".join(f"{k} {v}" for k, v in top))


def build_variants(build) -> dict:
    """Each variant's library, built from an edited copy of token_mlp.cu,
    one nvcc each, all at once."""
    src = (build.CSRC / "token_mlp.cu").read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    for header in build.CSRC.glob("*.cuh"):
        (OUT / header.name).write_text(header.read_text())
    jobs = {}
    for name, edits in VARIANTS:
        text = src
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"probe_torch_token_mlp: variant {name!r}: text not found: {old}")
            text = text.replace(old, new)
        stem = "token_mlp_" + re.sub(r"\W+", "_", name)
        (OUT / f"{stem}.cu").write_text(text)
        cmd = [build.nvcc(), *build.NVCC_FLAGS, "-o", str(OUT / f"{stem}.so"),
               str(OUT / f"{stem}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True), OUT / f"{stem}.so")
    libs = {}
    for name, (proc, path) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"probe_torch_token_mlp: variant {name!r} failed to build:\n{log}")
        import ctypes

        fn = ctypes.CDLL(str(path)).token_mlp_bf16_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes, fn.restype = [p] * 10 + [i] * 7 + [p], ctypes.c_int
        libs[name] = fn
    return libs


def clocks(fn, where: str, seconds: float = 1.5) -> None:
    """The card's SM clock and power, sampled every 100 ms by nvidia-smi
    while ``fn`` runs back to back."""
    proc = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
                             "--format=csv,noheader", "-lms", "100"], stdout=subprocess.PIPE,
                            text=True)
    t = time.time()
    while time.time() - t < seconds:
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
    proc.terminate()
    lines = [line.strip() for line in proc.communicate()[0].splitlines() if line.strip()]
    print(f"[clocks] during the fused kernel: {'; '.join(lines[2:8])} | {where}")


def timeline(out: torch.Tensor, plan: dict, where: str) -> None:
    """The stamps of the timeline variant's last call: each warpgroup's
    phases in µs, averaged over the blocks, and the blocks at work at once."""
    n = plan["grid"][0] * plan["grid"][1]
    st = out.view(torch.int64).reshape(-1)[: n * 2 * 12].view(n, 2, 12).cpu().double()
    t0 = float(st[:, :, 0].min())
    staged = (st[:, :, 1] - st[:, :, 0]).mean() / 1e3
    loop = (st[:, :, 2] - st[:, :, 1]).mean() / 1e3
    epi = (st[:, :, 3] - st[:, :, 2]).mean() / 1e3
    span = (float(st[:, :, 3].max()) - t0) / 1e3
    life = (st[:, 0, 3] - st[:, 0, 0]).mean() / 1e3
    sms = len(set(int(v) for v in st[:, 0, 4].tolist()))
    skew = (st[:, 1, 1] - st[:, 0, 1]).abs().mean() / 1e3
    print(f"[timeline] Mixer-B/16 fused kernel, {n} blocks on {sms} SMs, span {span:.2f} us; "
          f"a block's life {life:.2f} us: x^ staged {staged:.2f}, {plan['chunks']} chunks "
          f"{loop:.2f} ({loop / plan['chunks']:.2f} a chunk), epilogue {epi:.2f}; the two "
          f"warpgroups' staging ends {skew:.2f} us apart | {where}")
    d = [(st[:, :, i + 1] - st[:, :, i]).mean() / 1e3 for i in range(5, 9)]
    print(f"[timeline] chunk 2 of a block, us: activation {d[0]:.2f}, its second product "
          f"issued {d[1]:.2f}, the next first issued {d[2]:.2f}, both awaited {d[3]:.2f} "
          f"| {where}")
    e = [(st[:, :, j] - st[:, :, i]).mean() / 1e3 for i, j in ((2, 10), (10, 11), (11, 3))]
    print(f"[timeline] epilogue, us: the last products and the residual {e[0]:.2f}, + b2 and "
          f"the residual in place {e[1]:.2f}, the stores issued {e[2]:.2f} | {where}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--check", action="store_true", help="checks only, no timing")
    parser.add_argument("--parts", action="store_true",
                        help="also time variants of the fused kernel with parts taken out")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("probe_torch_token_mlp: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from robustart_torch.ops import build, mlp

    where = card()
    print(f"[device] {where}; torch {torch.__version__} CUDA {torch.version.cuda}")
    t0 = time.time()
    build.build(("token_mlp",))
    print(f"[build] token_mlp.cu in {time.time() - t0:.1f}s")
    variants = build_variants(build) if args.parts else {}
    if args.parts:
        sass(build)
    log = build.build_log("token_mlp")
    for line in log.splitlines():
        if re.search(r"Compiling entry|Used \d+ registers|spill|wgmma", line):
            print(f"[ptxas] {line.strip()}")
    import ctypes

    regs, smem = ctypes.c_int(), ctypes.c_int()
    lib = build.library("token_mlp")
    for which, label in enumerate(("stats pass", "fused Tp 64", "fused Tp 128", "fused Tp 208",
                                   "fused Tp 256", "f32 kernel")):
        err = lib.token_mlp_resources(which, ctypes.byref(regs), ctypes.byref(smem))
        if err:
            raise SystemExit(f"token_mlp_resources({which}) failed with cudaError {err}")
        print(f"[build] {label}: {regs.value} registers a thread, {smem.value} bytes of shared "
              f"memory a block")

    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = {}
    for name, shape in SHAPES.items():
        p = inputs(*shape, gen)
        cases[name] = p
        kw = {"ln": p["ln"], "residual_input": True}
        args_ = (p["x"], p["w1"], p["b1"], p["w2"], p["b2"])
        got = mlp.token_mlp(*args_, **kw)
        torch.cuda.synchronize()
        within(f"{name} {tuple(p['x'].shape)} hidden {shape[3]}", got,
               mlp.token_mlp_reference(*args_, **kw))
    for shape in RAGGED:
        p = inputs(*shape, gen)
        args_ = (p["x"], p["w1"], p["b1"], p["w2"], p["b2"])
        for form, kw in (("x residual", {"ln": p["ln"], "residual_input": True}),
                         ("shortcut", {"shortcut": p["shortcut"]}), ("none", {"ln": p["ln"]})):
            got = mlp.token_mlp(*args_, **kw)
            torch.cuda.synchronize()
            within(f"{shape} {form}", got, mlp.token_mlp_reference(*args_, **kw))
    if args.check:
        return 0

    warm()
    for name, p in cases.items():
        b, t, c = p["x"].shape
        h = p["w1"].shape[0]
        x, ln = p["x"], p["ln"]
        packed = mlp.pack_token_weights(p["w1"], p["w2"])
        plan = mlp.token_plan(b, t, c, h)
        stats = mlp.token_stats(x, 1e-6)
        whole = lambda: mlp.token_mlp(x, p["w1"], p["b1"], p["w2"], p["b2"], ln=ln,
                                      residual_input=True, packed=packed)
        alone = lambda: mlp.token_stats(x, 1e-6)
        fused = lambda: mlp.token_fused(x, packed, p["b1"], p["b2"], plan, h, x, ln, stats)
        xt = x.transpose(1, 2)
        w1t, a = p["w1"].t(), torch.randn((b, h, c), device="cuda").to(torch.bfloat16)
        cublas = lambda: (torch.matmul(xt, w1t), torch.matmul(p["w2"], a))
        flops = 4 * b * c * t * h
        nbytes = 2 * x.numel() * 2 + 2 * t * h * 2 + (h + t + 2 * c) * 4
        bound = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S) * 1e3
        stats_bound = (x.numel() * 2 + b * t * 8) / HBM_BYTES_PER_S * 1e3
        for label, fn, bnd in (("K10 a call", whole, bound), ("stats pass", alone, stats_bound),
                               ("fused kernel", fused, bound),
                               ("cuBLAS two products (yardstick)", cublas, flops / BF16_FLOPS_PER_S * 1e3)):
            ms = events_ms(fn)
            dev = device_ms(fn)
            dev_s = "; ".join(f"{k} {v:.4f}" for k, v in dev.items())
            print(f"[time] {name} {label}: {ms:.4f} ms (CUDA events), device {sum(dev.values()):.4f}"
                  f" ms ({dev_s}); bound {bnd:.4f} ms, {bnd / ms:.1%} of it; "
                  f"{flops / ms / 1e9:.1f} TFLOP/s of the two products | {where}")
    p = cases["Mixer-B/16"]
    x, (ln_w, ln_b) = p["x"], p["ln"]
    b, t, c = x.shape
    h = p["w1"].shape[0]
    packed = mlp.pack_token_weights(p["w1"], p["w2"])
    plan = mlp.token_plan(b, t, c, h)
    stats = mlp.token_stats(x, 1e-6)
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream().cuda_stream
    for name, fn in variants.items():
        for act, code in (("gelu", 1), ("no activation", 0)):
            if act != "gelu" and name not in ("as built", "timeline", "no first product",
                                              "no second product"):
                continue

            def call():
                err = fn(x.data_ptr(), packed[0].data_ptr(), p["b1"].data_ptr(),
                         packed[1].data_ptr(), p["b2"].data_ptr(), x.data_ptr(), ln_w.data_ptr(),
                         ln_b.data_ptr(), stats.data_ptr(), out.data_ptr(), b, t, c, h,
                         plan["tp"], plan["hp"], code, stream)
                if err:
                    raise SystemExit(f"variant {name!r} failed with cudaError {err}")

            print(f"[parts] Mixer-B/16 fused kernel, {name}, {act}: {events_ms(call):.4f} ms "
                  f"(CUDA events) | {where}")
            if name == "timeline":
                timeline(out, plan, where)
            if name == "as built" and code == 1:
                clocks(call, where)
    return 0


if __name__ == "__main__":
    sys.exit(main())
