#!/usr/bin/env python3
"""The PyTorch port's chamfer propagation (K5) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a card:

    python3 scripts/probe_torch_chamfer.py           # checks, then times
    python3 scripts/probe_torch_chamfer.py --check   # checks only
    python3 scripts/probe_torch_chamfer.py --old     # also the round route's split
    python3 scripts/probe_torch_chamfer.py --spatter [--root DIR]

It prints, with the card's name and power limit:

1. ptxas's registers and spills of ``csrc/chamfer.cu``'s two kernels;
2. K5 against its plain version, bitwise, at 1 and 12 rounds, at the
   main path's shape (128 × 224²), 3 × 56 × 40, odd H and W, 384² and
   maps beyond a cluster's shared memory, with each shape's plan
   (``ops/motion.py::chamfer_plan``) and launches;
3. without ``--check``, at the main path's call (128 × 224², cap 20, 12
   rounds): the cluster kernel a call by CUDA events over back-to-back
   calls after a second of work (the card's clocks rise over the first
   second) and by ``torch.profiler``'s device time, against the bounds of
   ``chip_smoke.py``; and its split from ``%globaltimer`` stamps of each
   block, from a copy of ``chamfer.cu`` built apart with
   ``-DCHAMFER_STAMPS`` under ``build/probe_kernels/`` (a block barrier
   before each stamp, so the stamped launch runs a little slower than the
   plain one):
   the load of the band, each round's compute, each round's halo exchange
   (the push, and the wait for the neighbour's rows), and the last round,
   whose results go straight to device memory;
4. with ``--old``, the round route (the port's first K5, one launch a
   round, which the plan keeps for large maps) at the same call, events
   and device time, and its split: each round's device time from
   ``torch.profiler``, a round of a variant that only copies the map (one
   load and one store a pixel: the memory floor of a round), built from an
   edited copy of ``chamfer.cu`` under ``build/probe_kernels/``, and the
   same round at 16 images (3.2 MB, resident in the 50 MB L2) against 128
   (25.7 MB in, 25.7 MB out a round), by device time;
5. with ``--spatter``, only the spatter corruption alone at 128 × 224²
   (severity 3, the water branch, one K5 call; severity 5, the mud branch,
   none), by CUDA events, with K5's launches a call, from the
   ``robustart_torch`` of ``--root`` (default: this checkout): run it on
   two trees in one chip call, in turns, to compare them.

It exits non-zero without a card or where a check fails. Run it with
``python3 -u`` under a ``timeout``: a chip call returns its output only at
the end.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

MAIN = (128, 224, 224)
CAP, ITERS = 20.0, 12
SHAPES = [MAIN, (3, 56, 40), (2, 57, 41), (2, 384, 384), (2, 480, 480), (1, 1000, 64)]
OUT = ROOT / "build" / "probe_kernels"
# the round kernel that copies the centre and takes no tap: its memory floor
COPY_ONLY = ("""#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const int y = i + dys[k], x = j + dxs[k];""", """#pragma unroll
  for (int k = 0; k < 0; ++k) {
    const int y = i + dys[k], x = j + dxs[k];""")


def warm(seconds=1.0) -> None:
    a = torch.randn((4096, 4096), device="cuda", dtype=torch.bfloat16)
    t = time.time()
    while time.time() - t < seconds:
        a @ a
    torch.cuda.synchronize()


def bounds(dist0: torch.Tensor, rate: float) -> dict:
    """``chip_smoke.py``'s bounds of one call (ms): the map in and out once
    over the memory rate; the plain version's 33 f32 instructions and the
    least, 15, a pixel and round, over the f32 instruction rate."""
    n, iters = dist0.numel(), ITERS
    return {"bytes": n * 8 / rate * 1e3,
            "33 ops": n * iters * cs.K5_PLAIN_OPS / cs.FP32_OPS_PER_S * 1e3,
            "15 ops": n * iters * cs.K5_LEAST_OPS / cs.FP32_OPS_PER_S * 1e3}


def round_launch_times(fn) -> list[float]:
    """Device ms of each kernel launch in one call of ``fn``, in order."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events() if getattr(e, "device_type", None) == DeviceType.CUDA]
    evs.sort(key=lambda e: e.time_range.start)
    return [e.time_range.elapsed_us() / 1e3 for e in evs]


def probe_entry(build, name: str, src: str, entry: str, argtypes: list, *flags: str):
    """C function ``entry`` of ``src`` (a copy of chamfer.cu) built under
    ``build/probe_kernels/<name>`` with ``flags`` besides the port's."""
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / f"{name}.cu").write_text(src)
    lib = OUT / f"{name}.so"
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, *flags, "-o", str(lib),
                    str(OUT / f"{name}.cu")], check=True, capture_output=True)
    fn = getattr(ctypes.CDLL(str(lib)), entry)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def copy_only_round(build):
    """``chamfer_round_launch`` of a copy of chamfer.cu whose round kernel
    takes no tap (its output is the input clamped at cap)."""
    from robustart_torch.ops import motion

    src = (build.CSRC / "chamfer.cu").read_text()
    old, new = COPY_ONLY
    if old not in src:
        raise SystemExit(f"probe_torch_chamfer: text not found in chamfer.cu: {old}")
    return probe_entry(build, "chamfer_copy_only", src.replace(old, new), "chamfer_round_launch",
                       motion._chamfer_round_launcher().argtypes)


def rounds(fn, dist0: torch.Tensor, iters: int) -> torch.Tensor:
    """``iters`` launches of round entry ``fn``, ping-ponging as
    ``motion.chamfer``'s round route does (uncounted: the probe's own)."""
    from robustart_torch.ops import build, motion

    maps = (torch.empty_like(dist0), torch.empty_like(dist0))
    src = dist0
    for r in range(iters):
        dst = maps[(iters - 1 - r) % 2]
        build.launch(fn, dist0.device, src.data_ptr(), dst.data_ptr(), *dist0.shape, CAP,
                     *motion.CHAMFER_WEIGHTS)
        src = dst
    return src


def timeline(build, dist0: torch.Tensor, plan: dict, where: str) -> None:
    """The cluster kernel's split from the stamps of its instrumented
    copy: mean µs a block of the load, of a round's compute and exchange
    (rounds 1 to iters-2), and of the last round with its stores; the
    launch's span and blocks an SM."""
    from robustart_torch.ops import motion

    argtypes = motion._chamfer_cluster_launcher().argtypes
    fn = probe_entry(build, "chamfer_stamped", (build.CSRC / "chamfer.cu").read_text(),
                     "chamfer_cluster_launch", argtypes[:-1] + [ctypes.c_void_p] * 2,
                     "-DCHAMFER_STAMPS")
    b = dist0.shape[0]
    n = plan["cluster"]
    slots = 2 * ITERS + 3
    stamps = torch.zeros((b * n, slots), dtype=torch.int64, device="cuda")
    out = torch.empty_like(dist0)
    for _ in range(2):  # the first warms
        build.launch(fn, dist0.device, dist0.data_ptr(), out.data_ptr(), *dist0.shape, CAP,
                     *motion.CHAMFER_WEIGHTS, ITERS, *(plan[k] for k in (
                         "cluster", "band", "wp", "groups", "strips", "threads", "smem")),
                     stamps.data_ptr())
    torch.cuda.synchronize()
    if not torch.equal(out, motion.chamfer_reference(dist0, CAP, ITERS)):
        raise SystemExit("probe_torch_chamfer: the stamped copy disagrees with the plain version")
    st = stamps.cpu().to(torch.float64)
    end = st[:, 2 * ITERS]  # the last round's compute and stores
    span = (end.max() - st[:, 0].min()) / 1e3
    life = (end - st[:, 0]).mean() / 1e3
    per_sm = torch.bincount(st[:, slots - 1].long()).max().item()
    load = (st[:, 1] - st[:, 0]).mean() / 1e3

    def done(r):  # a round's end: its exchange, or its compute where there is none
        return st[:, 1] if r < 0 else st[:, (3 if n > 1 else 2) + 2 * r]

    compute, exchange = [], []
    for r in range(ITERS - 1):
        compute.append((st[:, 2 + 2 * r] - done(r - 1)).mean() / 1e3)
        if n > 1:
            exchange.append((st[:, 3 + 2 * r] - st[:, 2 + 2 * r]).mean() / 1e3)
    last = (end - done(ITERS - 2)).mean() / 1e3
    mean = lambda xs: sum(float(x) for x in xs) / len(xs) if xs else float("nan")
    print(f"[timeline] K5 cluster {tuple(dist0.shape)}, cluster {n}, {plan['threads']} threads: "
          f"span {float(span):.2f} µs, at most {per_sm} blocks an SM, a block "
          f"{float(life):.2f} µs: "
          f"load {float(load):.3f} µs; a round's compute {mean(compute):.3f} µs (first "
          f"{float(compute[0]):.3f}), its exchange {mean(exchange):.3f} µs; the last round with "
          f"its stores {float(last):.3f} µs; {ITERS} rounds | {where}")


def spatter(root: Path, where: str) -> int:
    """The spatter corruption alone on a pre-staged 128 × 224² batch."""
    from robustart_torch.noise import corruptions as pc
    from robustart_torch.ops import motion

    gen = torch.Generator(device="cuda").manual_seed(0)
    imgs = torch.randint(0, 256, (MAIN[0], MAIN[1], MAIN[2], 3), dtype=torch.uint8,
                         device="cuda", generator=gen)
    x01 = pc.to_unit(imgs)
    warm()
    for severity in (3, 5):
        before = motion.chamfer.launches
        pc.corrupt_batch(x01, "spatter", severity, generator=gen)
        launches = motion.chamfer.launches - before
        ms = cs.cuda_ms(lambda: pc.corrupt_batch(x01, "spatter", severity, generator=gen), 20)
        print(f"[spatter] {root.resolve().name or root}: spatter/{severity} alone, B={MAIN[0]} "
              f"{MAIN[1]}^2: {ms:.4f} ms, {launches} K5 launches a call | {where}")
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--check", action="store_true", help="checks only, no timing")
    parser.add_argument("--old", action="store_true",
                        help="also time the round route and print its split")
    parser.add_argument("--spatter", action="store_true",
                        help="time only the spatter corruption (severities 3 and 5)")
    parser.add_argument("--root", type=Path, default=ROOT,
                        help="the checkout whose robustart_torch --spatter imports")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("probe_torch_chamfer: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.root.resolve()))
    from robustart_torch.ops import build, motion

    where = cs.card_line()
    print(f"[device] {where}; torch {torch.__version__} CUDA {torch.version.cuda}")
    if args.spatter:
        return spatter(args.root, where)
    t = time.time()
    build.build(["chamfer"])
    print(f"[build] chamfer.cu in {time.time() - t:.1f}s")
    for line in build.build_log("chamfer").splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"[ptxas] {line.strip()}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    ok = True
    for shape in SHAPES:
        dist0 = torch.where(torch.rand(shape, device="cuda", generator=gen) < 0.02, 0.0, CAP)
        for iters in (1, ITERS):
            plan = motion.chamfer_plan(*shape, iters)
            before = motion.chamfer.launches
            got = motion.chamfer(dist0, CAP, iters)
            same = torch.equal(got, motion.chamfer_reference(dist0, CAP, iters))
            launched = motion.chamfer.launches - before
            ok &= same and launched == plan["launches"]
            print(f"[check] {shape} {iters} rounds: bitwise {same}, {launched} launches, plan "
                  f"{plan} {'ok' if same else 'FAILED'}")
    if not ok:
        print("probe_torch_chamfer: FAILED", file=sys.stderr)
        return 1
    if args.check:
        return 0
    warm()
    rate = cs.hbm_rate(where)
    dist0 = cs.kernel_inputs(*MAIN, gen)["dist0"]
    bnd = bounds(dist0, rate)
    plan = motion.chamfer_plan(*MAIN, ITERS)
    ms = cs.cuda_ms(lambda: motion.chamfer(dist0, CAP, ITERS), 50)
    dev = cs.device_ms(lambda: motion.chamfer(dist0, CAP, ITERS))
    print(f"[time] K5 cluster route {MAIN}, {ITERS} rounds, 1 launch: {ms:.4f} ms (device "
          f"{cs._ms(dev)}); bounds: bytes {bnd['bytes']:.4f} ms, the plain version's 33 ops a "
          f"pixel-round {bnd['33 ops']:.4f} ms ({bnd['33 ops'] / ms:.1%}), the least 15 "
          f"{bnd['15 ops']:.4f} ms ({bnd['15 ops'] / ms:.1%}) | {where}")
    timeline(build, dist0, plan, where)
    if args.old:
        round_fn = motion._chamfer_round_launcher()
        old = rounds(round_fn, dist0, ITERS)
        if not torch.equal(old, motion.chamfer_reference(dist0, CAP, ITERS)):
            print("probe_torch_chamfer: the round route disagrees at the main shape",
                  file=sys.stderr)
            return 1
        old_ms = cs.cuda_ms(lambda: rounds(round_fn, dist0, ITERS), 20)
        old_dev = cs.device_ms(lambda: rounds(round_fn, dist0, ITERS))
        per = round_launch_times(lambda: rounds(round_fn, dist0, ITERS))
        print(f"[time] K5 round route {MAIN}, {ITERS} launches: {old_ms:.4f} ms (device "
              f"{cs._ms(old_dev)}), {old_ms / ms:.2f}x the cluster route; rounds' device ms "
              f"{', '.join(f'{v:.4f}' for v in per)} | {where}")
        copy = copy_only_round(build)
        for b in (MAIN[0], 16):
            # device time: at one round a call the host's allocations and
            # launch outlast a small kernel, and CUDA events would time them
            x = dist0[:b].contiguous()
            full = cs.device_ms(lambda: rounds(round_fn, x, 1), 20)
            floor = cs.device_ms(lambda: rounds(copy, x, 1), 20)
            mb = x.numel() * 4 / 1e6
            print(f"[split] K5 round route, one round at {b} images ({mb:.1f} MB in, {mb:.1f} "
                  f"out), device time: {full:.4f} ms; the copy-only round {floor:.4f} ms "
                  f"({floor / full:.0%}), {2 * mb / 1e3 / floor:.2f} TB/s; the taps' share "
                  f"{(full - floor) / full:.0%} | {where}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
