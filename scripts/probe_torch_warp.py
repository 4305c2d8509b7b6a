#!/usr/bin/env python3
"""The PyTorch port's bilinear warp (K2) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a card:

    python3 scripts/probe_torch_warp.py [--old FILE] [--variant NAME=FLAGS ...]
    python3 scripts/probe_torch_warp.py --check        # checks and stats only
    python3 scripts/probe_torch_warp.py --elastic [--root DIR]

It prints, with the card's name and power limit:

1. ptxas's registers, spills and shared memory of ``csrc/warp_bilinear.cu``
   and of ``scripts/probe_warp_tile.cu``, a tile-staged design that the
   port does not use (built apart under ``build/probe_kernels/``);
2. the box statistics of elastic_transform's coordinates at 128 × 224²
   (a fixed seed, severities 1-5, each of its two warps): the source box of
   each 32 × 32 output tile over the tile's area (mean and max) and the
   share of tiles whose box fits the tile design's 32 KB budget; the same
   for the i.i.d. ±30 px input and a far-overhang input; and the tiles
   each of the tile design's routes took on the card, counted by a copy
   built with ``-DWARP_PROBE_ROUTES``, held to the statistics;
3. K2 and the tile design against the plain version, bitwise, on each of
   those inputs, and K2 at C = 1 and at 3 × 56 × 40;
4. without ``--check``, on elastic's severity-3 coordinates (both warps)
   and on the i.i.d. input, against the byte bound of ``chip_smoke.py``:
   in turns (forward, then backward), by CUDA events over back-to-back
   calls and by ``torch.profiler``'s device time, the kernel; the parent's
   kernel (``--old FILE``, the source of the parent's ``warp_bilinear.cu``;
   by default ``git show HEAD~:robustart_torch/csrc/warp_bilinear.cu``);
   the tile design; copies of the kernel built with other nvcc flags
   (:data:`VARIANTS`, and each ``--variant``); and a copy built with
   ``-DWARP_PROBE_FLOOR`` that only reads the coordinates and writes the
   output (the design's memory floor). Then the tile design's split: the
   mean µs of a tile's phases from ``%globaltimer`` stamps of a copy built
   with ``-DWARP_PROBE_STAMPS`` (a block barrier before each), its copies
   with every tile gathering (``-DWARP_PROBE_GATHER``) and every box by
   4-byte ``cp.async`` (``-DWARP_PROBE_NO_BULK``), and its other tiles and
   budgets (:data:`SWEEP`);
5. with ``--elastic``, only ``elastic_transform`` alone at 128 × 224²,
   severity 3, by CUDA events, from the ``robustart_torch`` of ``--root``
   (default: this checkout): run it on two trees in one chip call, in
   turns, to compare them.

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
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

MAIN = (128, 224, 224)
OUT = ROOT / "build" / "probe_kernels"
TILE_SRC = ROOT / "scripts" / "probe_warp_tile.cu"
# the tile design as measured: 32 × 32 tiles, a 32 KB box budget
TILE = (32, 32 * 1024)
# its other tiles and budgets: (tile_h, box_bytes)
SWEEP = [(32, 16384), (32, 49152), (16, 12288), (16, 24576)]
# copies of the port's kernel timed beside it: name -> nvcc flags
VARIANTS = {f"{n} pixels a thread": [f"-DWARP_PIXELS={n}"] for n in (1, 2, 4, 8)}
P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
KERNEL_ARGS = [P] * 4 + [L] + [I] * 3 + [P]
TILE_ARGS = [P] * 4 + [L] + [I] * 5 + [P]


def warm(seconds=1.0) -> None:
    a = torch.randn((4096, 4096), device="cuda", dtype=torch.bfloat16)
    t = time.time()
    while time.time() - t < seconds:
        a @ a
    torch.cuda.synchronize()


def probe_entry(build, name: str, src: str, argtypes: list, *flags: str):
    """``warp_bilinear_launch`` of ``src`` built under
    ``build/probe_kernels/<name>`` with ``flags`` besides the port's; ptxas's
    lines of it are printed."""
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / f"{name}.cu").write_text(src)
    lib = OUT / f"{name}.so"
    done = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, *flags, "-o", str(lib),
                           str(OUT / f"{name}.cu")], capture_output=True, text=True)
    if done.returncode:
        raise SystemExit(f"probe_torch_warp: {name} did not build:\n{done.stdout}{done.stderr}")
    for line in (done.stdout + done.stderr).splitlines():
        if any(k in line for k in ("registers", "spill")):
            print(f"[ptxas] {name}: {line.strip()}")
    fn = ctypes.CDLL(str(lib)).warp_bilinear_launch
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def parent_source(path: Path | None) -> str:
    if path is not None:
        return path.read_text()
    done = subprocess.run(["git", "-C", str(ROOT), "show",
                           "HEAD~:robustart_torch/csrc/warp_bilinear.cu"],
                          capture_output=True, text=True)
    if done.returncode:
        raise SystemExit("probe_torch_warp: no parent source; pass --old FILE")
    return done.stdout


def call(fn, img, cy, cx, out, *extra):
    """One launch of a probe build's entry (uncounted)."""
    from robustart_torch.ops import build

    build.launch(fn, img.device, img.data_ptr(), cy.data_ptr(), cx.data_ptr(), out.data_ptr(),
                 *img.shape, *extra)
    return out


def elastic_inputs(gen) -> dict:
    """elastic_transform's two warps at 128 × 224², severities 1-5: name ->
    (image, cy, cx); the second warp's image is the first's output."""
    from robustart_torch.noise.corruptions import elastic_coords
    from robustart_torch.ops import warp

    x = torch.rand((*MAIN, 3), device="cuda", generator=gen)
    out = {}
    for s in range(1, 6):
        first, second = elastic_coords(x, s, generator=gen)
        out[f"elastic s{s} warp 1"] = (x, *first)
        out[f"elastic s{s} warp 2"] = (warp.warp_bilinear_reference(x, *first), *second)
    return out


def other_inputs(gen) -> dict:
    """chip_smoke.py's i.i.d. ±30 px input and a far-overhang input (i.i.d.
    over three periods each side: every tile of the tile design gathers)."""
    inp = cs.kernel_inputs(*MAIN, gen)
    b, h, w = MAIN
    far = [torch.rand(MAIN, device="cuda", generator=gen) * 12 * n - 6 * n for n in (h, w)]
    return {"iid ±30 px": (inp["img"], inp["cy"], inp["cx"]),
            "far overhang": (inp["img"], *far)}


def tile_boxes(cy: torch.Tensor, cx: torch.Tensor, tile_h: int) -> torch.Tensor:
    """Each (tile_h × 32) output tile's source box, rows × columns:
    floor(·).max() - floor(·).min() + 2 over the tile's pixels, (B,
    tiles_y, tiles_x)."""
    b, h, w = cy.shape
    pad = (0, -(-w // 32) * 32 - w, 0, -(-h // tile_h) * tile_h - h)

    def extent(coords):
        # replicating the last row and column keeps a ragged tile's extent
        f = F.pad(torch.floor(coords)[:, None], pad, mode="replicate")[:, 0]
        f = f.reshape(b, f.shape[1] // tile_h, tile_h, f.shape[2] // 32, 32)
        return (f.amax(dim=(2, 4)) - f.amin(dim=(2, 4))).to(torch.int64) + 2

    return extent(cy) * extent(cx)


def stats(img, cy, cx, tile_h: int, box_bytes: int) -> dict:
    """Box statistics of one input: area over the tile's, tiles that fit."""
    area = tile_boxes(cy, cx, tile_h)
    fits = area * img.shape[-1] * 4 <= box_bytes
    return {"mean": float(area.double().mean()) / (tile_h * 32),
            "max": float(area.max()) / (tile_h * 32), "box": int(fits.sum()),
            "tiles": fits.numel(), "kb_max": float(area.max()) * img.shape[-1] * 4 / 1024}


def timeline(build, img, cy, cx, name: str, where: str) -> bool:
    """The tile design's split from the stamps of its instrumented copy:
    mean µs a tile of the floors and extent (the coordinates were loaded
    under the tile before), the box's fill (box tiles), the sampling and
    the stores; the launch's span and the mean tiles in flight an SM."""
    from robustart_torch.ops import warp

    fn = probe_entry(build, "warp_tile_stamped", TILE_SRC.read_text(), TILE_ARGS[:-1] + [P] * 2,
                     "-DWARP_PROBE_STAMPS")
    tiles = -(-img.shape[1] // TILE[0]) * -(-img.shape[2] // 32) * img.shape[0]
    stamps = torch.zeros((tiles, 6), dtype=torch.int64, device="cuda")
    out = torch.empty_like(img)
    for _ in range(2):  # the first warms
        call(fn, img, cy, cx, out, *TILE, stamps.data_ptr())
    torch.cuda.synchronize()
    same = torch.equal(out, warp.warp_bilinear_reference(img, cy, cx))
    st = stamps.cpu().to(torch.float64)
    boxed = st[:, 2] > 0
    span = float(st[:, 4].max() - st[:, 0].min()) / 1e3
    life = (st[:, 4] - st[:, 0]) / 1e3
    mean = lambda t: float(t.mean()) if t.numel() else float("nan")  # noqa: E731
    sms = int(st[:, 5].max()) + 1
    print(f"[timeline] tile design, {name}: span {span:.2f} µs, a tile {mean(life):.2f} µs, "
          f"{float(life.sum()) / span / sms:.2f} tiles in flight an SM on average; "
          f"coordinates and extent {mean((st[:, 1] - st[:, 0]) / 1e3):.3f} µs, "
          f"box fill {mean((st[boxed, 2] - st[boxed, 1]) / 1e3):.3f} µs "
          f"({int(boxed.sum())} box tiles), sampling "
          f"{mean((st[:, 3] - torch.where(boxed, st[:, 2], st[:, 1])) / 1e3):.3f} µs, "
          f"stores {mean((st[:, 4] - st[:, 3]) / 1e3):.3f} µs; bitwise {same} | {where}")
    return same


def elastic(root: Path, where: str) -> int:
    """elastic_transform alone on a pre-staged 128 × 224² batch."""
    from robustart_torch.noise import corruptions as pc
    from robustart_torch.ops import warp

    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.rand((*MAIN, 3), device="cuda", generator=gen)
    warm()
    before = warp.warp_bilinear.launches
    pc.corrupt_batch(x, "elastic_transform", 3, generator=gen)
    launches = warp.warp_bilinear.launches - before
    ms = cs.cuda_ms(lambda: pc.corrupt_batch(x, "elastic_transform", 3, generator=gen), 20)
    print(f"[elastic] {root.resolve().name or root}: elastic_transform/3 alone, B={MAIN[0]} "
          f"{MAIN[1]}^2: {ms:.4f} ms, {launches} K2 launches a call | {where}")
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--check", action="store_true", help="checks and statistics only")
    parser.add_argument("--old", type=Path, default=None,
                        help="the parent's warp_bilinear.cu (default: git show HEAD~:...)")
    parser.add_argument("--elastic", action="store_true",
                        help="time only elastic_transform at severity 3")
    parser.add_argument("--root", type=Path, default=ROOT,
                        help="the checkout whose robustart_torch --elastic imports")
    parser.add_argument("--variant", action="append", default=[], metavar="NAME=FLAGS",
                        help="also time a copy of the kernel built with nvcc FLAGS")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("probe_torch_warp: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.root.resolve()))
    from robustart_torch.ops import build, warp

    where = cs.card_line()
    print(f"[device] {where}; torch {torch.__version__} CUDA {torch.version.cuda}")
    if args.elastic:
        return elastic(args.root, where)
    old_src = None if args.check else parent_source(args.old)
    t = time.time()
    build.build(["warp_bilinear"])
    print(f"[build] warp_bilinear.cu in {time.time() - t:.1f}s")
    for line in build.build_log("warp_bilinear").splitlines():
        if any(k in line for k in ("registers", "spill", "Compiling entry", "smem")):
            print(f"[ptxas] {line.strip()}")
    tile_src = TILE_SRC.read_text()
    tile = probe_entry(build, "warp_tile", tile_src, TILE_ARGS)
    counting = probe_entry(build, "warp_tile_routes", tile_src, TILE_ARGS[:-1] + [P] * 2,
                           "-DWARP_PROBE_ROUTES")

    gen = torch.Generator(device="cuda").manual_seed(0)
    inputs = {**elastic_inputs(gen), **other_inputs(gen)}
    ok = True
    for name, (img, cy, cx) in inputs.items():
        st = stats(img, cy, cx, *TILE)
        counts = torch.zeros(3, dtype=torch.int64, device="cuda")
        ref = warp.warp_bilinear_reference(img, cy, cx)
        same = torch.equal(call(counting, img, cy, cx, torch.empty_like(img), *TILE,
                                counts.data_ptr()), ref)
        counts = counts.tolist()
        agree = counts[0] == st["box"] and counts[0] + counts[1] == st["tiles"]
        bitwise = torch.equal(warp.warp_bilinear(img, cy, cx), ref)
        if name == "far overhang":
            agree &= counts[0] == 0
        if name.startswith(("elastic s3", "elastic s4", "elastic s5")):
            agree &= counts[1] == 0
        ok &= agree and same and bitwise
        print(f"[stats] {name}: box/tile area mean {st['mean']:.3f}, max {st['max']:.3f} "
              f"({st['kb_max']:.1f} KB at C=3); {st['box']} of {st['tiles']} tiles "
              f"({st['box'] / st['tiles']:.1%}) fit {TILE[1]} B; tile design's routes on the "
              f"card: box {counts[0]}, gather {counts[1]}, mean box area "
              f"{counts[2] / max(counts[0], 1) / 1024:.3f} tiles, bitwise {same}; K2 bitwise "
              f"{bitwise} {'ok' if agree and same and bitwise else 'FAILED'}")
    img, cy, cx = inputs["elastic s3 warp 2"]
    extra = {"C=1, elastic s3 warp 2": (img[..., :1].contiguous(), cy, cx)}
    small = cs.kernel_inputs(3, 56, 40, gen)
    extra["3x56x40, iid ±30 px"] = (small["img"], small["cy"], small["cx"])
    for name, (img, cy, cx) in extra.items():
        same = torch.equal(warp.warp_bilinear(img, cy, cx),
                           warp.warp_bilinear_reference(img, cy, cx))
        ok &= same
        print(f"[check] {name}: K2 bitwise {same}")
    if not ok:
        print("probe_torch_warp: FAILED", file=sys.stderr)
        return 1
    if args.check:
        return 0

    src = (build.CSRC / "warp_bilinear.cu").read_text()
    kernels = {"parent": (probe_entry(build, "warp_parent", old_src, KERNEL_ARGS), ()),
               "new": (warp._launcher(), ()),
               "tile design": (tile, TILE)}
    variants = dict(VARIANTS)
    for v in args.variant:
        label, flags = v.split("=", 1)
        variants[label] = flags.split()
    for i, (label, flags) in enumerate(variants.items()):
        kernels[label] = (probe_entry(build, f"warp_variant{i}", src, KERNEL_ARGS, *flags), ())
    floor = probe_entry(build, "warp_floor", src, KERNEL_ARGS, "-DWARP_PROBE_FLOOR")
    tile_copies = {"every tile gathers": "-DWARP_PROBE_GATHER",
                   "boxes by 4-byte cp.async only": "-DWARP_PROBE_NO_BULK"}
    tile_copies = {k: probe_entry(build, f"warp_tile_copy{i}", tile_src, TILE_ARGS, flag)
                   for i, (k, flag) in enumerate(tile_copies.items())}

    warm()
    rate = cs.hbm_rate(where)
    for name in ("elastic s3 warp 1", "elastic s3 warp 2", "iid ±30 px"):
        img, cy, cx = inputs[name]
        out = torch.empty_like(img)
        ref = warp.warp_bilinear_reference(img, cy, cx)
        bound = (img.numel() * 8 + cy.numel() * 8) / rate * 1e3
        for label, (fn, extra) in kernels.items():
            if not torch.equal(call(fn, img, cy, cx, out, *extra), ref):
                print(f"probe_torch_warp: {label} disagrees on {name}", file=sys.stderr)
                return 1
        order = list(kernels) + list(reversed(kernels))
        times = {k: [] for k in kernels}
        for k in order:
            fn, extra = kernels[k]
            run = lambda: call(fn, img, cy, cx, out, *extra)  # noqa: E731
            times[k].append((cs.cuda_ms(run, 100), cs.device_ms(run, 20)))
        for k, runs in times.items():
            ms = ", ".join(f"{e:.4f} (device {cs._ms(d)})" for e, d in runs)
            best = min(d or e for e, d in runs)
            print(f"[time] {name}, {k}: {ms} ms; bound {bound:.4f} ms (bytes), "
                  f"{bound / best:.1%} of bound at the least | {where}")
        dev = cs.device_ms(lambda: call(floor, img, cy, cx, out), 20)
        print(f"[split] {name}, K2's coordinates and stores only: device {cs._ms(dev)}"
              f"{f' ({bound / dev:.1%} of bound)' if dev else ''} | {where}")
        for label, fn in tile_copies.items():
            dev = cs.device_ms(lambda: call(fn, img, cy, cx, out, *TILE), 20)
            same = torch.equal(out, ref)
            ok &= same
            print(f"[split] {name}, tile design, {label}: device {cs._ms(dev)}, bitwise {same} "
                  f"| {where}")
        ok &= timeline(build, img, cy, cx, name, where)
        for tile_h, box_bytes in SWEEP:
            st = stats(img, cy, cx, tile_h, box_bytes)
            dev = cs.device_ms(lambda: call(tile, img, cy, cx, out, tile_h, box_bytes), 20)
            same = torch.equal(out, ref)
            ok &= same
            print(f"[sweep] {name}, tile design, tile {tile_h}x32, {box_bytes} B: device "
                  f"{cs._ms(dev)}, {st['box'] / st['tiles']:.1%} of tiles on the box route, "
                  f"bitwise {same} | {where}")
    if not ok:
        print("probe_torch_warp: FAILED", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
