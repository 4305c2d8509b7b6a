#!/usr/bin/env python3
"""The PyTorch port's motion taps (K3) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a card:

    python3 scripts/probe_torch_motion.py --old FILE      # checks, stats, times
    python3 scripts/probe_torch_motion.py --check         # checks and stats only
    python3 scripts/probe_torch_motion.py --corruption [--root DIR]

It prints, with the card's name and power limit:

1. ptxas's registers, spills and shared memory of each instance of
   ``csrc/motion_taps.cu`` and of the copies the probe builds apart under
   ``build/probe_kernels/``;
2. for every severity of motion_blur (C = 3) and snow (C = 1) at 128 ×
   224², each image at one of the 32 bank angles (4 images each), the
   plan's box statistics (a tile's source box over the tile's area, mean
   and max, its largest KB, the tiles that fit the plan's budget) beside
   the tiles each route took on the card, counted by a copy built with
   ``-DMOTION_PROBE_ROUTES``, and K3 against the plain version, bitwise;
   then K3 bitwise at 3 × 56 × 40 and 8 × 8 and on far offsets (the
   gathering route, its tiles counted);
3. without ``--check``, at every severity's taps, in turns (forward, then
   backward), by CUDA events over back-to-back calls and by
   ``torch.profiler``'s device time, against the byte bound of
   ``chip_smoke.py``: K3; the parent's kernel (``--old FILE``, the
   parent's ``motion_taps.cu``, built apart); the designs without shared
   memory of ``scripts/probe_motion_variants.cu`` (a thread a pixel with no
   division and 32-bit offsets; a thread a float of a row); copies of K3
   built with its probe defines (:data:`VARIANTS`: other fills, a block a
   tile) and other nvcc flags (``--variant NAME=FLAGS``); and K3's split:
   copies built with one or two of its parts left out, the boxes' fill,
   the taps and the stores (``-DMOTION_PROBE_SKIP_FILL``, ``_TAPS``,
   ``_STORES``; :data:`SPLIT`);
4. with ``--corruption``, only motion_blur and snow alone at 128 × 224²,
   severities 3 and 5, by CUDA events, from the ``robustart_torch`` of
   ``--root`` (default: this checkout): run it on two trees in one chip
   call, in turns, to compare them.

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
OUT = ROOT / "build" / "probe_kernels"
VARIANTS_SRC = ROOT / "scripts" / "probe_motion_variants.cu"
P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
PARENT_ARGS = [P] * 5 + [L] + [I] * 4 + [P]  # the parent's entry: no box budget
KERNEL_ARGS = [P] * 5 + [L] + [I] * 8 + [P]
ROUTES_ARGS = KERNEL_ARGS[:-1] + [P, P]
# copies of K3 timed beside it: name -> nvcc flags (csrc/motion_taps.cu's
# probe defines)
VARIANTS = {
    "no tensor copy": ["-DMOTION_PROBE_NO_TENSOR"],
    "4-byte cp.async everywhere": ["-DMOTION_PROBE_NO_ALIGN"],
    "a block a tile": ["-DMOTION_PROBE_TILE_BLOCKS"],
}
# K3's split: copies built with parts left out (-DMOTION_PROBE_SKIP_<part>)
SPLIT = {"fill and stores": ("TAPS",), "fill and taps": ("STORES",),
         "taps and stores": ("FILL",), "fill alone": ("TAPS", "STORES"),
         "taps alone": ("FILL", "STORES"), "stores alone": ("FILL", "TAPS")}


def severities() -> list[tuple]:
    """(label, C, radius, sigma, bank) of every severity of both corruptions."""
    from robustart_torch.noise import corruptions as pc

    out = [(f"motion_blur s{s + 1}", 3, float(r), float(g), pc.MOTION_BANK)
           for s, (r, g) in enumerate(pc.MOTION_SEVERITY)]
    return out + [(f"snow s{s + 1}", 1, float(c[4]), float(c[5]), pc.SNOW_BANK)
                  for s, c in enumerate(pc.SNOW_SEVERITY)]


def probe_entry(build, name: str, src: str, entry: str, argtypes: list, *flags: str):
    """``entry`` of ``src`` built under ``build/probe_kernels/<name>`` with
    ``flags`` besides the port's; ptxas's lines of it are printed."""
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / f"{name}.cu").write_text(src)
    lib = OUT / f"{name}.so"
    done = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, *flags, "-o", str(lib),
                           str(OUT / f"{name}.cu")], capture_output=True, text=True)
    if done.returncode:
        raise SystemExit(f"probe_torch_motion: {name} did not build:\n{done.stdout}{done.stderr}")
    for line in (done.stdout + done.stderr).splitlines():
        if any(k in line for k in ("registers", "spill")):
            print(f"[ptxas] {name}: {line.strip()}")
    fn = getattr(ctypes.CDLL(str(lib)), entry)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def call(fn, img, dy, dx, wt, out, *extra):
    """One launch of a probe build's entry (uncounted)."""
    from robustart_torch.ops import build

    build.launch(fn, img.device, img.data_ptr(), dy.data_ptr(), dx.data_ptr(), wt.data_ptr(),
                 out.data_ptr(), *img.shape, dy.shape[1], *extra)
    return out


def box_stats(dy, dx, h: int, w: int, c: int, box_bytes: int) -> dict:
    """The plan's boxes of one batch of tap rows: box over a full tile's
    area (mean, max), the largest box in KB, the tiles that fit, and their
    floats."""
    from robustart_torch.ops import motion as km

    th, tw = km.MOTION_TILE
    ratios, boxed, floats, most = [], 0, 0, 0
    rows = {}
    for n in range(dy.shape[0]):
        key = (tuple(dy[n].tolist()), tuple(dx[n].tolist()))
        if key not in rows:
            rows[key] = [km.tile_box(dy[n], dx[n], (r0, c0), h, w)[2:]
                         for r0 in range(0, h, th) for c0 in range(0, w, tw)]
        for bh, bw in rows[key]:
            ratios.append(bh * bw / (th * tw))
            most = max(most, bh * bw * c * 4)
            if bh * bw * c * 4 <= box_bytes:
                boxed += 1
                floats += bh * bw * c
    return {"mean": sum(ratios) / len(ratios), "max": max(ratios), "kb": most / 1024,
            "box": boxed, "tiles": len(ratios), "floats": floats}


def check_routes(counting, name, img, dy, dx, wt, reach) -> bool:
    """K3 and its route-counting copy against the plain version; the
    counted routes against :func:`box_stats`."""
    from robustart_torch.ops import motion as km

    b, h, w, c = img.shape
    plan = km.motion_plan(b, h, w, c, reach, km._sms(0))
    st = box_stats(dy.cpu(), dx.cpu(), h, w, c, plan["box_bytes"])
    counts = torch.zeros(3, dtype=torch.int64, device="cuda")
    ref = km.motion_taps_reference(img, dy, dx, wt)
    same = torch.equal(call(counting, img, dy, dx, wt, torch.empty_like(img),
                            plan["box_bytes"], plan["grid"][0], *plan["map"],
                            counts.data_ptr()), ref)
    counts = counts.tolist()
    before = km.motion_taps.launches
    bitwise = torch.equal(km.motion_taps(img, dy, dx, wt, reach=reach), ref)
    one = km.motion_taps.launches - before == 1
    agree = counts == [st["box"], st["tiles"] - st["box"], st["floats"]]
    ok = agree and same and bitwise and one
    print(f"[stats] {name} {b}x{h}x{w} C={c}, T={dy.shape[1]}: box/tile area mean "
          f"{st['mean']:.3f}, max {st['max']:.3f} ({st['kb']:.1f} KB); {st['box']} of "
          f"{st['tiles']} tiles fit the plan's {plan['box_bytes']} B; routes on the card: box "
          f"{counts[0]}, gather {counts[1]}, {counts[2]} box floats; bitwise {bitwise} (routes "
          f"copy {same}), one launch {one} {'ok' if ok else 'FAILED'}")
    return ok


def path_inputs(gen) -> dict:
    """Every severity's tap rows at 128 × 224², each image at bank angle
    n mod 32: label -> (image, dy, dx, wt, reach)."""
    from robustart_torch.ops import motion as km

    idx = torch.arange(MAIN[0], device="cuda") % 32
    out = {}
    for label, c, radius, sigma, bank in severities():
        img = torch.rand((*MAIN, c), device="cuda", generator=gen)
        out[label] = (img, *km.tap_rows(idx, radius, sigma, bank),
                      km.tap_spans(radius, sigma, tuple(bank)))
    return out


def corruption(root: Path, where: str) -> int:
    """motion_blur and snow alone on a pre-staged 128 × 224² batch."""
    from robustart_torch.noise import corruptions as pc
    from robustart_torch.ops import motion as km

    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.rand((*MAIN, 3), device="cuda", generator=gen)
    warm()
    for name in ("motion_blur", "snow"):
        for s in (3, 5):
            before = km.motion_taps.launches
            pc.corrupt_batch(x, name, s, generator=gen)
            launches = km.motion_taps.launches - before
            ms = cs.cuda_ms(lambda: pc.corrupt_batch(x, name, s, generator=gen), 20)
            print(f"[corruption] {root.resolve().name or root}: {name}/{s} alone, B={MAIN[0]} "
                  f"{MAIN[1]}^2: {ms:.4f} ms, {launches} K3 launch(es) a call | {where}")
    return 0


def warm(seconds=1.0) -> None:
    a = torch.randn((4096, 4096), device="cuda", dtype=torch.bfloat16)
    t = time.time()
    while time.time() - t < seconds:
        a @ a
    torch.cuda.synchronize()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--check", action="store_true", help="checks and statistics only")
    parser.add_argument("--old", type=Path, default=None,
                        help="the parent's motion_taps.cu (needed to time)")
    parser.add_argument("--corruption", action="store_true",
                        help="time only motion_blur and snow at severities 3 and 5")
    parser.add_argument("--root", type=Path, default=ROOT,
                        help="the checkout whose robustart_torch --corruption imports")
    parser.add_argument("--variant", action="append", default=[], metavar="NAME=FLAGS",
                        help="also time a copy of K3 built with nvcc FLAGS")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("probe_torch_motion: no CUDA device", file=sys.stderr)
        return 2
    if not (args.check or args.corruption or args.old):
        print("probe_torch_motion: pass --old FILE (the parent's motion_taps.cu) to time, "
              "or --check", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.root.resolve()))
    from robustart_torch.ops import build
    from robustart_torch.ops import motion as km

    where = cs.card_line()
    print(f"[device] {where}; torch {torch.__version__} CUDA {torch.version.cuda}")
    if args.corruption:
        return corruption(args.root, where)
    t = time.time()
    build.build(["motion_taps"])
    print(f"[build] motion_taps.cu in {time.time() - t:.1f}s")
    for line in build.build_log("motion_taps").splitlines():
        if any(k in line for k in ("registers", "spill", "Compiling entry", "smem")):
            print(f"[ptxas] {line.strip()}")
    src = (build.CSRC / "motion_taps.cu").read_text()
    counting = probe_entry(build, "motion_routes", src, "motion_taps_launch", ROUTES_ARGS,
                           "-DMOTION_PROBE_ROUTES")

    gen = torch.Generator(device="cuda").manual_seed(0)
    inputs = path_inputs(gen)
    ok = True
    for label, (img, dy, dx, wt, reach) in inputs.items():
        ok &= check_routes(counting, label, img, dy, dx, wt, reach)
    # odd sizes and the gathering route
    for label, c, radius, sigma, bank in (severities()[4], severities()[9]):
        for b, h, w in ((3, 56, 40), (32, 8, 8)):
            idx = torch.arange(b, device="cuda") % 32
            img = torch.rand((b, h, w, c), device="cuda", generator=gen)
            ok &= check_routes(counting, label, img, *km.tap_rows(idx, radius, sigma, bank),
                               km.tap_spans(radius, sigma, tuple(bank)))
        img = torch.rand((8, 100, 90, c), device="cuda", generator=gen)
        far = torch.randint(-60, 61, (2, 8, 21), device="cuda", generator=gen).to(torch.int32)
        wt = torch.rand((8, 21), device="cuda", generator=gen)
        ok &= check_routes(counting, f"far offsets (±60 px), C={c}", img, far[0].contiguous(),
                           far[1].contiguous(), wt, None)
    if not ok:
        print("probe_torch_motion: FAILED", file=sys.stderr)
        return 1
    if args.check:
        return 0

    variants = VARIANTS_SRC.read_text()
    kernels = {
        "parent": (probe_entry(build, "motion_parent", args.old.read_text(),
                               "motion_taps_launch", PARENT_ARGS), False),
        "new": (km._motion_launcher(), True),
        "thread a pixel, no division": (probe_entry(build, "motion_direct32", variants,
                                                    "motion_direct32_launch", PARENT_ARGS), False),
        "thread a float": (probe_entry(build, "motion_floats", variants, "motion_floats_launch",
                                       PARENT_ARGS), False),
    }
    variants = dict(VARIANTS)
    for v in args.variant:
        name, flags = v.split("=", 1)
        variants[name] = flags.split()
    for i, (name, flags) in enumerate(variants.items()):
        kernels[name] = (probe_entry(build, f"motion_variant{i}", src, "motion_taps_launch",
                                     KERNEL_ARGS, *flags), True)
    split = {name: probe_entry(build, f"motion_split{i}", src, "motion_taps_launch", KERNEL_ARGS,
                               *(f"-DMOTION_PROBE_SKIP_{part}" for part in skip))
             for i, (name, skip) in enumerate(SPLIT.items())}

    warm()
    rate = cs.hbm_rate(where)
    for label, (img, dy, dx, wt, reach) in inputs.items():
        out = torch.empty_like(img)
        ref = km.motion_taps_reference(img, dy, dx, wt)
        plan = km.motion_plan(*img.shape, reach, km._sms(0))
        launch_args = (plan["box_bytes"], plan["grid"][0], *plan["map"])
        bound = (img.numel() * 8 + dy.numel() * 12) / rate * 1e3
        for name, (fn, boxed) in kernels.items():
            extra = launch_args if boxed else ()
            if not torch.equal(call(fn, img, dy, dx, wt, out, *extra), ref):
                print(f"probe_torch_motion: {name} disagrees on {label}", file=sys.stderr)
                return 1
        order = list(kernels) + list(reversed(kernels))
        times = {k: [] for k in kernels}
        for k in order:
            fn, boxed = kernels[k]
            extra = launch_args if boxed else ()
            run = lambda: call(fn, img, dy, dx, wt, out, *extra)  # noqa: E731
            times[k].append((cs.cuda_ms(run, 100), cs.device_ms(run, 20)))
        for k, runs in times.items():
            ms = ", ".join(f"{e:.4f} (device {cs._ms(d)})" for e, d in runs)
            best = min(d or e for e, d in runs)
            print(f"[time] {label} T={dy.shape[1]}, {k}: {ms} ms; bound {bound:.4f} ms (bytes), "
                  f"{bound / best:.1%} of bound at the least | {where}")
        for name, fn in split.items():
            run = lambda: call(fn, img, dy, dx, wt, out, *launch_args)  # noqa: E731
            dev = cs.device_ms(run, 20)
            print(f"[split] {label}, {name} only: {cs.cuda_ms(run, 100):.4f} ms, device "
                  f"{cs._ms(dev)} | {where}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
