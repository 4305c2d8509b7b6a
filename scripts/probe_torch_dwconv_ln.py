#!/usr/bin/env python3
"""The PyTorch port's depthwise 7×7 + LayerNorm (K11) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a card:

    python3 scripts/probe_torch_dwconv_ln.py            # checks, then times
    python3 scripts/probe_torch_dwconv_ln.py --check    # checks only
    python3 scripts/probe_torch_dwconv_ln.py --old FILE # also times FILE
    python3 scripts/probe_torch_dwconv_ln.py --parts    # and variants
    python3 scripts/probe_torch_dwconv_ln.py --sass     # and the SASS's opcodes

It prints, with the card's name and power limit:

1. ptxas's registers and spills of ``csrc/dwconv_ln.cu``'s kernels
   (``nvcc -Xptxas -v``);
2. K11 against its plain version, in bf16 (one bf16 ulp of max|ref|) and
   f32 (1e-5 of max|ref|), at ConvNeXt-B's four stages (128 × 56² × 128,
   28² × 256, 14² × 512, 7² × 1024) and at ragged shapes, with each
   launch's plan (``ops/convnext.py::dwconv_plan``);
3. without ``--check``, at the four stages in bf16 and f32: K11 a call by
   CUDA events over back-to-back calls after a second of work (the card's
   clocks rise over the first second) and by ``torch.profiler``'s device
   time, against its bound; and in bf16 cuDNN's depthwise
   ``F.conv2d(groups=C)`` on channels_last bf16 followed by
   ``F.layer_norm``, a yardstick the port never calls. The inputs, the
   bound, the timers and the yardstick are ``chip_smoke.py``'s own;
4. with ``--old FILE``, the same times of an earlier ``dwconv_ln.cu`` whose
   entry takes the (49, C) tap table (``dwconv_ln_launch(x, taps, b,
   gamma, beta, out, n, h, w, c, eps, dtype, stream)``), built with the
   same flags under ``build/probe_kernels/``, checked against the plain
   version first;
5. with ``--parts``, K11 at the four stages in bf16 built from edited
   copies of ``dwconv_ln.cu`` (one ``nvcc`` each under
   ``build/probe_kernels/``), each with one part taken out (their outputs
   are wrong; they time what is left), by CUDA events.

It exits non-zero without a card or where a check fails.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

STAGES = {"stage 0": (128, 56, 56, 128), "stage 1": (128, 28, 28, 256),
          "stage 2": (128, 14, 14, 512), "stage 3": (128, 7, 7, 1024)}
RAGGED = [(3, 13, 11, 96), (3, 9, 15, 1024), (2, 13, 11, 128), (3, 7, 7, 544), (2, 5, 3, 32),
          (1, 30, 61, 64), (1, 9, 300, 32)]
OUT = ROOT / "build" / "probe_kernels"
# (name, [(text in dwconv_ln.cu, its replacement)]); every text must be found.
# The outputs of these are wrong; they time what is left.
VARIANTS = [
    ("as built", []),
    ("loads but no FMAs", [("""            if (t < 7) {
              const float2 wv = wt[t * 7 + dj];
              acc[0][j].x = fmaf(v.x, wv.x, acc[0][j].x);
              acc[0][j].y = fmaf(v.y, wv.y, acc[0][j].y);
            }
            if (t > 0) {
              const float2 wv = wt[(t - 1) * 7 + dj];
              acc[1][j].x = fmaf(v.x, wv.x, acc[1][j].x);
              acc[1][j].y = fmaf(v.y, wv.y, acc[1][j].y);
            }""", """            if (dj == 0) {
              acc[0][j].x += v.x;
              acc[0][j].y += v.y;
            }""")]),
    ("no bf16 unpacking", [("    return make_float2(__uint_as_float(v << 16), __uint_as_float(v & 0xffff0000u));",
                            "    return make_float2(__uint_as_float(v), __uint_as_float(v));")]),
    ("no butterfly", [("""    scatter<8>(v, wmask, m, lane & m);
    scatter<4>(v, wmask, m / 2, lane & (m / 2));
    scatter<2>(v, wmask, m / 4, lane & (m / 4));
    scatter<1>(v, wmask, m / 8, lane & (m / 8));
    if (L == 32) v[0] += __shfl_xor_sync(wmask, v[0], 1);
""", "")]),
    ("no LayerNorm sums", [("""auto f, auto between) {
""", """auto f, auto between) {
    __syncthreads();
    between();
    for (int k = 0; k < kPix; ++k) s[k] = 1.0f;
    return;
""")]),
    ("no stores", [("      if (row >= i1 || col >= W) continue;", "      if (row >= 0) continue;")]),
    # %globaltimer stamps of each block (thread 0) written over the output in
    # place of the stores: 0 start, 1 weights in registers, then per patch
    # 2 + 4·k convolution done, 3 + 4·k mean, 4 + 4·k rstd, 5 + 4·k stores
    # done; 62 end, 63 the SM
    ("timeline", [
        ("  const int K = a.cluster, H = a.h, W = a.w_, C = a.c, G = a.groups;\n",
         """  const int K = a.cluster, H = a.h, W = a.w_, C = a.c, G = a.groups;
  unsigned long long* stamps = reinterpret_cast<unsigned long long*>(a.out) + blockIdx.x * 64;
  auto stamp = [&](int k) {
    unsigned long long v;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(v));
    if (threadIdx.x == 0) stamps[k] = v;
  };
  stamp(0);
"""),
        ("  // input row r into its ring slot", "  stamp(1);\n  // input row r into its ring slot"),
        ("    float v[kPix], s[kPix];\n", "    stamp(2 + (i - i0) / 2 * 4);\n    float v[kPix], s[kPix];\n"),
        ("""#pragma unroll
    for (int k = 0; k < kRows * kS; ++k) {
      float2& y = acc[k / kS][k % kS];
      y.x = __fsub_rn(y.x, s[k]);""", """    stamp(3 + (i - i0) / 2 * 4);
#pragma unroll
    for (int k = 0; k < kRows * kS; ++k) {
      float2& y = acc[k / kS][k % kS];
      y.x = __fsub_rn(y.x, s[k]);"""),
        ("    if (!active) continue;\n", "    stamp(4 + (i - i0) / 2 * 4);\n    if (!active) continue;\n"),
        ("      if (row >= i1 || col >= W) continue;", "      if (row >= 0) continue;"),
        ("    }\n  }\n  if (K == 2) cg::this_cluster().sync();",
         """    }
    stamp(5 + (i - i0) / 2 * 4);
  }
  stamp(62);
  if (threadIdx.x == 0) {
    unsigned int sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    stamps[63] = sm;
  }
  if (K == 2) cg::this_cluster().sync();"""),
    ]),
]


def inputs(shape, dtype, gen):
    """K11's arguments (x, w, b, gamma, beta) as ``chip_smoke.py`` makes them."""
    inp = cs.convnext_inputs(*shape, dtype, gen)
    return tuple(inp[k] for k in ("x", "w", "b", "gamma", "beta"))


def within(name, got, ref) -> bool:
    exact32 = ref.dtype == torch.float32
    got, ref = got.float(), ref.float()
    top = float(ref.abs().max())
    err = float((got - ref).abs().max())
    tol = 1e-5 * top if exact32 else 2.0 ** (math.floor(math.log2(top)) - 7)
    ok = math.isfinite(err) and err <= tol
    print(f"[check] {name}: max|d| {err:.3e} (allowed {tol:.3e}, max|ref| {top:.3e}) "
          f"{'ok' if ok else 'FAILED'}")
    return ok


def warm(seconds=1.0) -> None:
    a = torch.randn((4096, 4096), device="cuda", dtype=torch.bfloat16)
    t = time.time()
    while time.time() - t < seconds:
        a @ a
    torch.cuda.synchronize()


def old_kernel(path: Path, build):
    """An earlier dwconv_ln.cu, built as build.py builds, and a call of it on
    the (49, C) tap table."""
    OUT.mkdir(parents=True, exist_ok=True)
    lib_path = OUT / "dwconv_ln_old.so"
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(lib_path), str(path)], check=True,
                   capture_output=True)
    fn = ctypes.CDLL(str(lib_path)).dwconv_ln_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 6 + [i] * 4 + [ctypes.c_float, i, p]
    fn.restype = i

    def call(x, w, b, gamma, beta):
        from robustart_torch.ops import convnext

        taps = convnext._taps(w)
        out = torch.empty_like(x)
        n, h, wd, c = x.shape
        build.launch(fn, x.device, x.data_ptr(), taps.data_ptr(), b.data_ptr(),
                     gamma.data_ptr(), beta.data_ptr(), out.data_ptr(), n, h, wd, c,
                     convnext.EPS, build.DTYPE_CODE[x.dtype])
        return out

    return call


def build_variants(build, names=None) -> dict:
    """Each variant's entry point (or those named), built from an edited copy
    of dwconv_ln.cu, one nvcc each, all at once."""
    import re

    src = (build.CSRC / "dwconv_ln.cu").read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, edits in VARIANTS:
        if names is not None and name not in names:
            continue
        text = src
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"probe_torch_dwconv_ln: variant {name!r}: text not found: {old}")
            text = text.replace(old, new)
        stem = "dwconv_ln_" + re.sub(r"\W+", "_", name)
        (OUT / f"{stem}.cu").write_text(text)
        cmd = [build.nvcc(), *build.NVCC_FLAGS, "-o", str(OUT / f"{stem}.so"),
               str(OUT / f"{stem}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True), OUT / f"{stem}.so")
    fns = {}
    for name, (proc, path) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"probe_torch_dwconv_ln: variant {name!r} failed to build:\n{log}")
        from robustart_torch.ops import convnext

        fn = ctypes.CDLL(str(path)).dwconv_ln_launch
        fn.argtypes, fn.restype = convnext._launcher().argtypes, ctypes.c_int
        fns[name] = fn
    return fns


def sass(build) -> None:
    """``cuobjdump -sass`` of the built library into
    ``build/probe_kernels/dwconv_ln.sass``, and each kernel's count of
    instructions by opcode, largest first."""
    import collections
    import re

    tool = Path(build.nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(build.library_path("dwconv_ln"))],
                          capture_output=True, text=True, check=True).stdout
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "dwconv_ln.sass").write_text(text)
    for func in re.split(r"\n\s*Function : ", text)[1:]:
        name = func.split("\n", 1)[0].strip()
        ops = collections.Counter(m.group(1).split(".")[0] for m in
                                  re.finditer(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                                              func))
        total = sum(ops.values())
        top = ", ".join(f"{op} {n}" for op, n in ops.most_common(18))
        print(f"[sass] {name}: {total} instructions: {top}")


def timeline(out: torch.Tensor, plan: dict, where: str, card_: str) -> None:
    """Where a block's time goes, from the timeline variant's stamps: the
    launch's span, blocks an SM, and the mean of each phase in µs."""
    torch.cuda.synchronize()
    n = plan["grid"]
    st = out.reshape(-1).view(torch.int64)[: n * 64].view(n, 64).cpu().to(torch.float64)
    t0 = st[:, 0].min()
    iters = -(-min(plan["band"], 10 ** 9) // 2)
    span = (st[:, 62].max() - t0) / 1e3
    per_sm = torch.bincount(st[:, 63].long()).max().item()
    life = (st[:, 62] - st[:, 0]).mean() / 1e3
    parts = {"weights": (st[:, 1] - st[:, 0]).mean() / 1e3,
             "first rows + convolution": (st[:, 2] - st[:, 1]).mean() / 1e3}
    conv, mean, rstd, store = [], [], [], []
    for k in range(iters):
        b = 2 + 4 * k
        mean.append(st[:, b + 1] - st[:, b])
        rstd.append(st[:, b + 2] - st[:, b + 1])
        store.append(st[:, b + 3] - st[:, b + 2])
        if k:
            conv.append(st[:, b] - st[:, b - 1])
    cat = lambda xs: torch.stack(xs).mean().item() / 1e3 if xs else float("nan")
    parts.update({"convolution a patch": cat(conv), "mean a patch": cat(mean),
                  "rstd a patch": cat(rstd), "normalize + store a patch": cat(store)})
    print(f"[timeline] {where}: span {span:.2f} µs, at most {per_sm} blocks an SM, a block "
          f"{life:.2f} µs, {iters} patches: "
          + ", ".join(f"{k} {v:.3f} µs" for k, v in parts.items()) + f" | {card_}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--check", action="store_true", help="checks only, no timing")
    parser.add_argument("--old", type=Path, help="an earlier dwconv_ln.cu to time beside")
    parser.add_argument("--sass", action="store_true",
                        help="dump the SASS to build/probe_kernels/ and count its opcodes")
    parser.add_argument("--parts", nargs="?", const="", default=None,
                        help="also time variants with one part taken out (bf16); "
                             "optionally a comma-separated list of their names")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("probe_torch_dwconv_ln: no CUDA device", file=sys.stderr)
        return 2
    from robustart_torch.ops import build, convnext

    where = cs.card_line()
    print(f"[device] {where}; torch {torch.__version__} CUDA {torch.version.cuda}")
    t = time.time()
    build.build(["dwconv_ln"])
    print(f"[build] dwconv_ln.cu in {time.time() - t:.1f}s")
    for line in build.build_log("dwconv_ln").splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"[ptxas] {line.strip()}")
    if args.sass:
        sass(build)
    gen = torch.Generator(device="cuda").manual_seed(0)
    ok = True
    for shape in [*STAGES.values(), *RAGGED]:
        for dtype in (torch.bfloat16, torch.float32):
            args_ = inputs(shape, dtype, gen)
            before = convnext.dwconv_ln.launches
            got = convnext.dwconv_ln(*args_)
            ref = convnext.dwconv_ln_reference(*args_)
            torch.cuda.synchronize()
            plan = convnext.dwconv_plan(*shape, dtype)
            ok &= convnext.dwconv_ln.launches == before + 1
            ok &= within(f"{shape} {str(dtype)[6:]} plan {plan}", got, ref)
    old = old_kernel(args.old, build) if args.old else None
    if old is not None:
        for shape in (STAGES["stage 0"], RAGGED[0]):
            a = inputs(shape, torch.bfloat16, gen)
            ok &= within(f"old kernel {shape} bf16", old(*a), convnext.dwconv_ln_reference(*a))
    if not ok:
        print("probe_torch_dwconv_ln: FAILED", file=sys.stderr)
        return 1
    if args.check:
        return 0
    warm()
    rate = cs.hbm_rate(where)
    for label, shape in STAGES.items():
        for dtype in (torch.bfloat16, torch.float32):
            inp = cs.convnext_inputs(*shape, dtype, gen)
            a = tuple(inp[k] for k in ("x", "w", "b", "gamma", "beta"))
            tag = "bf16" if dtype == torch.bfloat16 else "f32"
            bnd, by = cs.form_bound("dwconv_ln", inp, tag, rate)
            ms = cs.cuda_ms(lambda: convnext.dwconv_ln(*a), 20)
            dev = cs.device_ms(lambda: convnext.dwconv_ln(*a))
            line = (f"[time] K11 {label} {shape} {tag}: {ms:.4f} ms (device "
                    f"{dev if dev is None else f'{dev:.4f}'} ms), bound {bnd:.4f} ms ({by}), "
                    f"{bnd / ms:.1%} of bound")
            if old is not None:
                old_ms = cs.cuda_ms(lambda: old(*a), 20)
                line += f"; earlier kernel {old_ms:.4f} ms ({old_ms / ms:.2f}x)"
            print(f"{line} | {where}")
            if dtype == torch.bfloat16:
                cs.dwconv_yardstick(inp, where)
    if args.parts is not None:
        fns = build_variants(build, args.parts.split(",") if args.parts else None)
        launcher = convnext._launcher
        try:
            for name, fn in fns.items():
                convnext._launcher = lambda fn=fn: fn
                if name == "timeline":
                    for label, shape in STAGES.items():
                        timeline(convnext.dwconv_ln(*inputs(shape, torch.bfloat16, gen)),
                                 convnext.dwconv_plan(*shape, torch.bfloat16),
                                 f"{label} {shape}", where)
                    continue
                times = []
                for label, shape in STAGES.items():
                    a = inputs(shape, torch.bfloat16, gen)
                    times.append(f"{label} {cs.cuda_ms(lambda: convnext.dwconv_ln(*a), 20):.4f}")
                print(f"[parts] {name}: {' ms, '.join(times)} ms (bf16, events) | {where}")
        finally:
            convnext._launcher = launcher
    return 0


if __name__ == "__main__":
    sys.exit(main())
