#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (robustart_torch) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failed check exits non-zero before the last line):

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions;
2. build the five kernels from ``robustart_torch/csrc/`` for sm_90a, one
   nvcc each, all at once (``robustart_torch.ops.build``);
3. each kernel against its plain PyTorch version on the card: K1 (fused
   noise) at B=64 and B=128, 224², every noise mode × {normalized bf16,
   normalized f32, centered_u8 int8}, its noise statistics and streams; K2
   (warp), K3 (motion taps, C = 3 and C = 1), K4 (glass shuffle) and K5
   (chamfer) at the main path's shape (B=128, 224²) and at 3×56×40;
4. the main path at full width: ``MultiEvalSolver`` online ImageNet-C on
   the fake backend, resnet50_official at 224² in bf16 with random weights
   from the seed, batch 128, 256 images, two noise and eight blur, weather
   and digital corruptions at severities 1-5, with every kernel's launches
   counted and held against the count the code implies; then each
   corruption's chain on the card against the same chain on the CPU at a
   small input, the random draws injected;
5. times, with the card's name and power limit beside each: each kernel
   against its plain version, its bound and the one PyTorch call that
   computes the same function where there is one; ResNet-50 forward alone
   (bf16, f32); each corruption's online step on a pre-staged batch; the
   solver's own img/s;
6. one JSON line describing every kernel of the path, the card's line, and
   the last line: ``{"ok": true, "device": {...}}``.

Exits non-zero without a result where ``torch.cuda.is_available()`` is
false, and where the ``robustart_torch`` package is not beside this file.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
RESULTS = ROOT / "build" / "chip_smoke_results"
IMG = 224
MAIN_BATCH = 128
MAIN_LIMIT = 256
NEW_CORRUPTIONS = ["defocus_blur", "glass_blur", "motion_blur", "zoom_blur", "snow",
                   "elastic_transform", "gaussian_blur", "spatter"]
MAIN_CORRUPTIONS = ["gaussian_noise", "shot_noise"] + NEW_CORRUPTIONS
SEVERITIES = [1, 2, 3, 4, 5]
ODD = (3, 56, 40)  # an odd size for the kernel checks: B, H, W
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
# device-memory rate of each card (NVIDIA data sheets), bytes/s
HBM_BYTES_PER_S = {
    "H100 80GB HBM3": 3.35e12,  # SXM
    "H100 PCIe": 2.0e12,
    "H100 NVL": 3.9e12,
    "H200": 4.8e12,
}
FP32_FLOPS_PER_S = 67e12  # H100 SXM, outside the tensor cores (an FMA is 2)
# f32 instructions that are not FMAs (add, min, mul): half the FLOP rate
FP32_OPS_PER_S = FP32_FLOPS_PER_S / 2
# K1's float32 work per element (gaussian): 2 uniforms (2 each), log, sqrt,
# cos (1 each), 4 multiplies/adds, clip (2), floor, 3 normalize steps
K1_FLOPS_PER_ELEMENT = 19
KERNELS = {  # name: (source, the TPU kernel's pl.pallas_call site)
    "fused_noise_normalize": ("robustart_torch/csrc/fused_noise.cu",
                              "robustart_tpu/ops/pallas_noise.py:141"),
    "warp_bilinear": ("robustart_torch/csrc/warp_bilinear.cu",
                      "robustart_tpu/ops/pallas_warp.py:172"),
    "motion_taps": ("robustart_torch/csrc/motion_taps.cu",
                    "robustart_tpu/ops/pallas_motion.py:114"),
    "glass_shuffle": ("robustart_torch/csrc/glass_shuffle.cu",
                      "robustart_tpu/ops/pallas_motion.py:219"),
    "chamfer": ("robustart_torch/csrc/chamfer.cu",
                "robustart_tpu/ops/pallas_motion.py:278"),
}


class Failed(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise Failed(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def hbm_rate(name: str) -> float:
    for key, rate in HBM_BYTES_PER_S.items():
        if key in name:
            return rate
    raise Failed(f"no memory rate known for {name!r}; add it to HBM_BYTES_PER_S")


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``iters`` runs (CUDA events)."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def levels(out: torch.Tensor) -> torch.Tensor:
    """uint8 levels of a K1 output (exact for f32 and int8)."""
    if out.dtype == torch.int8:
        return out.to(torch.int32) + 128
    mean = torch.tensor(MEAN, device=out.device)
    std = torch.tensor(STD, device=out.device)
    return torch.round((out.float() * std + mean) * 255.0).to(torch.int32)


def phase_build() -> None:
    """Phase 2: build every kernel from the checkout's sources, in parallel."""
    from robustart_torch.ops import build

    t = time.time()
    built = build.build()
    print(f"[build] {len(built)} of {len(build.KERNELS)} kernels built for sm_90a "
          f"({', '.join(built)}), one nvcc each in parallel, in {time.time() - t:.1f}s")


def phase_k1(k1, card: str) -> dict:
    """Phase 3, K1: the fused noise kernel against its plain version."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randint(0, 256, (64, IMG, IMG, 3), dtype=torch.uint8, device="cuda",
                      generator=gen)
    sigmas = {"gaussian_noise": 0.18, "speckle_noise": 0.35,
              "impulse_noise": 0.09, "shot_noise": 12.0}
    outputs = [("normalized", torch.bfloat16), ("normalized", torch.float32),
               ("centered_u8", torch.int8)]
    cases = [(n, s) for n, s in sigmas.items()] + [("gaussian_noise", 0.0)]
    for noise, sigma in cases:
        exact = sigma == 0.0 or noise == "impulse_noise"
        for output, dtype in outputs:
            kw = dict(noise=noise, sigma=sigma, mean=MEAN, std=STD,
                      out_dtype=dtype, output=output)
            got = k1.fused_noise_normalize(x, 1234, **kw)
            ref = k1.fused_noise_normalize_reference(x, 1234, **kw)
            torch.cuda.synchronize()
            differ = got != ref
            frac = float(differ.float().mean())
            max_abs = float((got.float() - ref.float()).abs().max())
            print(f"[K1 B=64] {noise} sigma={sigma} {output}/{dtype}: "
                  f"differing={frac:.3e} max_abs={max_abs:.3e}")
            if exact:
                check(torch.equal(got, ref), f"K1 {noise} sigma={sigma} {dtype} not exact")
                continue
            check(frac <= 1e-4, f"K1 {noise} {dtype}: {frac} of elements differ")
            if dtype == torch.bfloat16:
                # one uint8 level in normalized units, plus one bf16 ulp
                bound = 1.0 / (255.0 * min(STD)) + 2.0**-7 * float(ref.float().abs().max())
                check(max_abs <= bound, f"K1 {noise} bf16: max_abs {max_abs} > {bound}")
            else:
                dl = int((levels(got) - levels(ref)).abs().max())
                check(dl <= 1, f"K1 {noise} {dtype}: levels differ by {dl}")

    grey = torch.full((64, IMG, IMG, 3), 128, dtype=torch.uint8, device="cuda")
    out = k1.fused_noise_normalize(grey, 7, noise="gaussian_noise", sigma=0.1,
                                   mean=MEAN, std=STD, out_dtype=torch.float32)
    diff = (out * torch.tensor(STD, device="cuda") + torch.tensor(MEAN, device="cuda")
            - 128.0 / 255.0)
    sd = float(diff.std())
    print(f"[K1 stats] gaussian sigma=0.1 on mid-grey: std(out-clean)={sd:.5f} "
          f"mean={float(diff.mean()):.5f}")
    check(abs(sd - 0.1) <= 0.005, f"K1 gaussian std {sd} not within 5% of 0.1")
    same = k1.fused_noise_normalize(grey, 7, noise="gaussian_noise", sigma=0.1,
                                    mean=MEAN, std=STD, out_dtype=torch.float32)
    other = k1.fused_noise_normalize(grey, 8, noise="gaussian_noise", sigma=0.1,
                                     mean=MEAN, std=STD, out_dtype=torch.float32)
    check(torch.equal(out, same), "K1: the same seed does not repeat")
    check(not torch.equal(out, other), "K1: different seeds give the same noise")
    check(not torch.equal(out[0], out[1]), "K1: identical images got identical noise")
    # the TPU kernel's seed + image keying would make these two equal
    check(not torch.equal(out[1], other[0]),
          "K1: seed s image 1 repeats seed s+1 image 0")

    # at the main path's shape: batch 128, bf16 normalized, gaussian
    xm = torch.randint(0, 256, (MAIN_BATCH, IMG, IMG, 3), dtype=torch.uint8,
                       device="cuda", generator=gen)
    kw = dict(noise="gaussian_noise", sigma=0.18, mean=MEAN, std=STD,
              out_dtype=torch.bfloat16, output="normalized")
    got = k1.fused_noise_normalize(xm, 99, **kw)
    ref = k1.fused_noise_normalize_reference(xm, 99, **kw)
    torch.cuda.synchronize()
    max_abs_err = float((got.float() - ref.float()).abs().max())
    frac = float((got != ref).float().mean())
    print(f"[K1 B={MAIN_BATCH}] main-path shape: differing={frac:.3e} "
          f"max_abs_err={max_abs_err:.3e}")
    check(frac <= 1e-4, f"K1 at the main path's shape: {frac} of elements differ")
    return {"max_abs_err": max_abs_err, "input": xm, "kw": kw}


def kernel_inputs(b: int, h: int, w: int, gen: torch.Generator) -> dict:
    """Inputs of K2-K5 at the ranges the corruptions give them: elastic's
    coordinates (identity plus up to 30 px, past the border), the taps of
    motion_blur and snow at severity 5, glass codes at d = 4, a sparse
    spatter edge map."""
    from robustart_torch.noise.corruptions import MOTION_BANK, SNOW_BANK
    from robustart_torch.ops.motion import tap_rows

    dev = gen.device
    img = torch.rand((b, h, w, 3), device=dev, generator=gen)
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev), indexing="ij")
    cy = yy + torch.rand((b, h, w), device=dev, generator=gen) * 60.0 - 30.0
    cx = xx + torch.rand((b, h, w), device=dev, generator=gen) * 60.0 - 30.0
    idx = torch.randint(0, len(MOTION_BANK), (b,), device=dev, generator=gen)
    taps = {3: tap_rows(idx, 20.0, 15.0, MOTION_BANK), 1: tap_rows(idx, 12.0, 12.0, SNOW_BANK)}
    code = torch.randint(0, 64, (b, h, w), device=dev, generator=gen).to(torch.uint8)
    edges = torch.rand((b, h, w), device=dev, generator=gen) < 0.02
    dist0 = torch.where(edges, 0.0, 20.0)
    return {"img": img, "cy": cy.contiguous(), "cx": cx.contiguous(), "taps": taps,
            "img1": img[..., :1].contiguous(), "code": code, "dist0": dist0}


def phase_new_kernels(card: str) -> dict:
    """Phase 3, K2-K5: each against its plain version at the main path's
    shape and at an odd size. K4 and K5 must be bitwise; K2 and K3 round
    every step as their plain versions do (no FMA), so they are held to
    1e-6 and reported as bitwise or not."""
    from robustart_torch.ops import motion, warp

    gen = torch.Generator(device="cuda").manual_seed(1)
    errs = {}
    main = None
    for b, h, w in ((MAIN_BATCH, IMG, IMG), ODD):
        inp = kernel_inputs(b, h, w, gen)
        pairs = [
            ("warp_bilinear", warp.warp_bilinear, warp.warp_bilinear_reference,
             (inp["img"], inp["cy"], inp["cx"]), 1e-6),
            ("motion_taps", motion.motion_taps, motion.motion_taps_reference,
             (inp["img"], *inp["taps"][3]), 1e-6),
            ("motion_taps C=1", motion.motion_taps, motion.motion_taps_reference,
             (inp["img1"], *inp["taps"][1]), 1e-6),
            ("glass_shuffle", motion.glass_shuffle, motion.glass_shuffle_reference,
             (inp["img"], inp["code"], 4), 0.0),
            ("chamfer", motion.chamfer, motion.chamfer_reference,
             (inp["dist0"], 20.0, 12), 0.0),
        ]
        for name, kernel, plain, args, atol in pairs:
            got = kernel(*args)
            ref = plain(*args)
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            bitwise = torch.equal(got, ref)
            print(f"[{name} B={b} {h}x{w}] max_abs_err={err:.3e} bitwise={bitwise}")
            check(err <= atol and (atol > 0 or bitwise),
                  f"{name} at {b}x{h}x{w} disagrees with its plain version ({err})")
            if (b, h, w) == (MAIN_BATCH, IMG, IMG):
                errs[name] = err
        if main is None:
            main = inp
    return {"max_abs_err": errs, "inputs": main}


def expected_launches(n_batches: int) -> dict:
    """Each kernel's launches in the main path's run, from the code: one
    launch per call per batch; K4 one per glass pass, K5 one per round."""
    from robustart_torch.noise.corruptions import GLASS_SEVERITY, SPATTER_SEVERITY

    water = [s for s in SEVERITIES if SPATTER_SEVERITY[s - 1][5] == 0]
    return {
        "fused_noise_normalize": n_batches * len(SEVERITIES),  # gaussian_noise
        "warp_bilinear": n_batches * len(SEVERITIES) * 2,  # elastic: two warps
        "motion_taps": n_batches * len(SEVERITIES) * 2,  # motion_blur + snow
        "glass_shuffle": n_batches * sum(GLASS_SEVERITY[s - 1][2] for s in SEVERITIES),
        "chamfer": n_batches * len(water) * 12,  # spatter's water branch
    }


def wrappers() -> dict:
    from robustart_torch.ops import motion, noise, warp

    return {"fused_noise_normalize": noise.fused_noise_normalize,
            "warp_bilinear": warp.warp_bilinear, "motion_taps": motion.motion_taps,
            "glass_shuffle": motion.glass_shuffle, "chamfer": motion.chamfer}


def main_config(batch_size: int):
    from robustart_torch.core.config import Config

    return Config({
        "model": {"type": "resnet50_official", "dtype": "bf16"},
        "seed": 0,
        "data": {
            "read_from": "fake", "fake_size": MAIN_LIMIT, "batch_size": batch_size,
            "num_workers": 8, "input_size": IMG, "test_resize": 256,
            "test": {
                "imagenet_c_online": True,
                "corruptions": MAIN_CORRUPTIONS, "severities": SEVERITIES,
                "limit_samples": MAIN_LIMIT,
                "transforms": {"type": "JUSTNORM"},
                "evaluator": {"type": "imagenetc", "kwargs": {"topk": [1, 5]}},
            },
        },
        "saver": {"results_dir": str(RESULTS)},
    })


def phase_main_path(card: str) -> dict:
    """Phase 4: the ImageNet-C solver, online, at full width."""
    from robustart_torch.solvers import MultiEvalSolver

    shutil.rmtree(RESULTS, ignore_errors=True)
    solver = MultiEvalSolver(main_config(MAIN_BATCH))  # device: cuda by default
    solver.build_model(seed=0)
    for fn in wrappers().values():
        fn.launches = 0
    t0 = time.time()
    summary = solver.evaluate()
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {name: fn.launches for name, fn in wrappers().items()}
    n_batches = -(-MAIN_LIMIT // MAIN_BATCH)
    want = expected_launches(n_batches)
    for name, n in launches.items():
        print(f"[main] {name} launches in the solver run: {n} (expected {want[name]})")
        check(n > 0 and n == want[name], f"{name}: {n} launches on the main path, "
              f"expected {want[name]}")
    for corruption in MAIN_CORRUPTIONS:
        for s in SEVERITIES:
            path = RESULTS / corruption / str(s) / "results.txt.all"
            lines = path.read_text().splitlines()
            check(len(lines) == MAIN_LIMIT, f"{path}: {len(lines)} lines")
            scores = np.array([json.loads(line)["score"] for line in lines])
            check(scores.shape == (MAIN_LIMIT, 1000) and np.isfinite(scores).all(),
                  f"{path}: logits not finite or of the wrong shape")
            metric = json.loads((RESULTS / corruption / str(s) / "metric").read_text())
            print(f"[main] {corruption}/{s}: top1={metric['top1']:.2f} "
                  f"top5={metric['top5']:.2f} ({len(lines)} lines)")
    mce = summary["mCE"]
    check(mce is not None and np.isfinite(mce), f"mCE not finite: {mce}")
    print(f"[main] mCE={mce:.4f} top1_per_corruption={summary['top1_per_corruption']}")
    n_img = MAIN_LIMIT * len(SEVERITIES) * len(MAIN_CORRUPTIONS)
    return {"launches": launches, "wall": wall, "n_img": n_img, "solver": solver}


def injected_draws(name: str, severity: int, b: int, h: int, w: int) -> dict:
    """A random draw for ``name``, made on the CPU from a seed, in the form
    the corruptions take injected."""
    from robustart_torch.noise import corruptions as pc

    g = torch.Generator().manual_seed(severity)
    if name == "glass_blur":
        _, d, iters = pc.GLASS_SEVERITY[severity - 1]
        return {"offsets": torch.randint(-d, d, (iters, b, h, w, 2), generator=g)}
    if name == "motion_blur":
        return {"angles": torch.rand((b,), generator=g) * 90.0 - 45.0}
    if name == "snow":
        return {"normal": torch.randn((b, h, w), generator=g),
                "angles": torch.rand((b,), generator=g) * 90.0 - 135.0}
    if name == "spatter":
        return {"normal": torch.randn((b, h, w), generator=g)}
    if name == "elastic_transform":
        cc = pc.ELASTIC_SEVERITY[severity - 1][2]
        return {"affine": torch.rand((b, 3, 2), generator=g) * 2 * cc - cc,
                "field_x": torch.rand((b, h, w), generator=g) * 2 - 1,
                "field_y": torch.rand((b, h, w), generator=g) * 2 - 1}
    return {}


def phase_reference_check(card: str) -> None:
    """Phase 4b: each corruption's online chain on the card against the same
    chain on the CPU (plain kernels, CPU BLAS and convolutions) at a small
    input, float32, random draws injected."""
    from robustart_torch.models import create_classifier
    from robustart_torch.noise import corruptions as pc
    from robustart_torch.solvers.multi_eval_solver import online_logits

    gpu = create_classifier("resnet50_official", seed=1, device="cuda")
    cpu = create_classifier("resnet50_official", seed=1, device="cpu")
    imgs = torch.from_numpy(
        np.random.default_rng(5).integers(0, 256, (2, IMG, IMG, 3), np.uint8)
    )

    def rel_err(a, b):
        return float((a - b).abs().max()) / float(b.abs().max())

    with torch.inference_mode():
        for noise in ("gaussian_noise", "impulse_noise"):
            a = online_logits(gpu, noise, 3, imgs.cuda(), 4242).cpu()
            b = online_logits(cpu, noise, 3, imgs, 4242)
            err = rel_err(a, b)
            print(f"[check] {noise} chain, card vs CPU: rel max|dlogit|={err:.2e}")
            check(err <= 1e-3 and torch.equal(a.argmax(-1), b.argmax(-1)),
                  f"{noise} chain disagrees with the CPU reference ({err})")
        u = torch.rand(imgs.shape, generator=torch.Generator().manual_seed(0))
        x01 = pc.to_unit(imgs)
        a = gpu(pc.uint8_roundtrip(pc.shot_noise(x01.cuda(), 3, uniform=u.cuda()))).cpu()
        b = cpu(pc.uint8_roundtrip(pc.shot_noise(x01, 3, uniform=u)))
        err = rel_err(a, b)
        print(f"[check] shot_noise chain (injected uniforms), card vs CPU: "
              f"rel max|dlogit|={err:.2e}")
        check(err <= 1e-3, f"shot_noise chain disagrees with the CPU reference ({err})")

        for name in NEW_CORRUPTIONS:
            for severity in (3, 5):
                draws = injected_draws(name, severity, *imgs.shape[:3])
                fn = pc.CORRUPTIONS[name]
                ca = fn(x01.cuda(), severity, **{k: v.cuda() for k, v in draws.items()})
                cb = fn(x01, severity, **draws)
                d = (ca.cpu() - cb).abs()
                beyond = float((d > 1e-5).float().mean())
                lv = float((torch.floor(ca.cpu() * 255) != torch.floor(cb * 255))
                           .float().mean())
                la = gpu(pc.uint8_roundtrip(ca)).cpu()
                lb = cpu(pc.uint8_roundtrip(cb))
                err = rel_err(la, lb)
                print(f"[check] {name}/{severity}, card vs CPU: image max|d|="
                      f"{float(d.max()):.3e}, share beyond 1e-5 {beyond:.2e}, "
                      f"levels differing {lv:.2e}; chain rel max|dlogit|={err:.2e}")
                # an image's floors (glass, snow, spatter) can land on the
                # other level where the two libraries' sums differ by an ulp
                check(beyond <= 1e-3 and lv <= 1e-3,
                      f"{name}/{severity} image disagrees with the CPU reference")
                check(err <= 1e-3 and torch.equal(la.argmax(-1), lb.argmax(-1)),
                      f"{name}/{severity} chain disagrees with the CPU reference ({err})")


def time_kernels(card: str, k1_res: dict, new: dict, rate: float) -> dict:
    """Phase 5, kernels: each against its plain version, its bound and the
    library call, at the main path's shape."""
    import torch.nn.functional as F

    from robustart_torch.ops import motion, warp

    def bound(nbytes, ops):
        b_ms, o_ms = nbytes / rate * 1e3, ops / FP32_OPS_PER_S * 1e3
        return max(b_ms, o_ms), "bytes" if b_ms >= o_ms else "operations"

    def line(name, ms, plain, bnd, by, lib=None, note=""):
        lib_s = f", library {lib:.4f} ms" if lib is not None else ", library none"
        print(f"[time] {name}{note}: {ms:.4f} ms, plain {plain:.3f} ms, bound {bnd:.4f} ms "
              f"({by}), {bnd / ms:.1%} of bound{lib_s} | {card}")

    res = {}
    # K1, as in the first slice
    x, kw = k1_res["input"], k1_res["kw"]
    from robustart_torch.ops import noise as k1

    ms = cuda_ms(lambda: k1.fused_noise_normalize(x, 5, **kw), 200)
    plain = cuda_ms(lambda: k1.fused_noise_normalize_reference(x, 5, **kw), 5, warmup=1)
    b_ms = x.numel() * (1 + 2) / rate * 1e3
    o_ms = x.numel() * K1_FLOPS_PER_ELEMENT / FP32_FLOPS_PER_S * 1e3
    bnd, by = max(b_ms, o_ms), "bytes" if b_ms >= o_ms else "operations"
    line(f"K1 fused_noise_normalize B={x.shape[0]} bf16", ms, plain, bnd, by)
    res["fused_noise_normalize"] = dict(ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                                        library_ms=None)

    inp = new["inputs"]
    img, cy, cx = inp["img"], inp["cy"], inp["cx"]
    b, h, w, c = img.shape
    n_pix = b * h * w
    # K2: image in, two coordinate maps in, image out; 2 floors and 4
    # subtractions a pixel, 6 multiplies and 3 adds a channel
    ms = cuda_ms(lambda: warp.warp_bilinear(img, cy, cx), 100)
    plain = cuda_ms(lambda: warp.warp_bilinear_reference(img, cy, cx), 5, warmup=1)
    bnd, by = bound(img.numel() * 4 * 2 + n_pix * 4 * 2, n_pix * (6 + 9 * c))
    # scipy's 'reflect' is grid_sample's reflection with align_corners=False
    nchw = img.permute(0, 3, 1, 2).contiguous()
    grid = torch.stack([(2 * cx + 1) / w - 1, (2 * cy + 1) / h - 1], dim=-1)

    def lib_call():
        return F.grid_sample(nchw, grid, mode="bilinear", padding_mode="reflection",
                             align_corners=False)

    lib_err = float((lib_call().permute(0, 2, 3, 1)
                     - warp.warp_bilinear_reference(img, cy, cx)).abs().max())
    lib = cuda_ms(lib_call, 100) if lib_err <= 1e-4 else None
    print(f"[time] K2 library check: grid_sample(reflection) vs plain max|d|={lib_err:.3e}")
    line(f"K2 warp_bilinear B={b} {h}^2", ms, plain, bnd, by, lib)
    res["warp_bilinear"] = dict(ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                                library_ms=lib)

    # K3: image in and out; a multiply and an add per tap and channel (the
    # taps with weight, this draw: all of them at severity 5)
    for cc, x3 in ((3, img), (1, inp["img1"])):
        dy, dx, wt = inp["taps"][cc]
        ms = cuda_ms(lambda: motion.motion_taps(x3, dy, dx, wt), 100)
        plain = cuda_ms(lambda: motion.motion_taps_reference(x3, dy, dx, wt), 3, warmup=1)
        taps = int((wt != 0).sum())
        bnd, by = bound(x3.numel() * 4 * 2 + dy.numel() * 12, taps * h * w * cc * 2)
        line(f"K3 motion_taps B={b} {h}^2 C={cc}", ms, plain, bnd, by)
        if cc == 3:
            res["motion_taps"] = dict(ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                                      library_ms=None)

    # K4: image in, one-byte code in, image out; no float operation
    code = inp["code"]
    ms = cuda_ms(lambda: motion.glass_shuffle(img, code, 4), 100)
    plain = cuda_ms(lambda: motion.glass_shuffle_reference(img, code, 4), 5, warmup=1)
    bnd, by = bound(img.numel() * 4 * 2 + code.numel(), 0)
    k = code.to(torch.int64)
    rows = torch.arange(h, device="cuda").view(1, h, 1)
    cols = torch.arange(w, device="cuda").view(1, 1, w)
    inner = (rows > 4) & (rows < h - 4) & (cols > 4) & (cols < w - 4)
    src = (torch.where(inner, rows + k // 8 - 4, rows) * w
           + torch.where(inner, cols + k % 8 - 4, cols))
    flat_idx = src.reshape(b, h * w, 1).expand(b, h * w, c).contiguous()
    flat = img.reshape(b, h * w, c)
    lib = cuda_ms(lambda: torch.gather(flat, 1, flat_idx), 100)
    check(torch.equal(torch.gather(flat, 1, flat_idx).reshape(img.shape),
                      motion.glass_shuffle(img, code, 4)), "K4 library call disagrees")
    line(f"K4 glass_shuffle B={b} {h}^2 d=4", ms, plain, bnd, by, lib)
    res["glass_shuffle"] = dict(ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                                library_ms=lib)

    # K5, a call of 12 rounds (12 launches): the map read once and written
    # once; 16 (add, min) pairs and the cap's min a pixel a round
    dist0 = inp["dist0"]
    ms = cuda_ms(lambda: motion.chamfer(dist0, 20.0, 12), 50)
    plain = cuda_ms(lambda: motion.chamfer_reference(dist0, 20.0, 12), 3, warmup=1)
    bnd, by = bound(dist0.numel() * 4 * 2, dist0.numel() * 12 * (16 * 2 + 1))
    line(f"K5 chamfer B={b} {h}^2, a call of 12 rounds", ms, plain, bnd, by,
         note=f" ({ms / 12:.4f} ms a launch)")
    res["chamfer"] = dict(ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by, library_ms=None)
    return res


def time_path(card: str, main: dict) -> None:
    """Phase 5, the path: forward alone, each corruption's pre-staged online
    step, the fused steps, the solver end to end."""
    from robustart_torch.data import build_dataloader
    from robustart_torch.models import create_classifier
    from robustart_torch.noise import corruptions as pc
    from robustart_torch.solvers.multi_eval_solver import online_logits

    imgs = torch.randint(0, 256, (MAIN_BATCH, IMG, IMG, 3), dtype=torch.uint8,
                         device="cuda")
    for dtype in (torch.bfloat16, torch.float32):
        clf = create_classifier("resnet50_official", seed=0, device="cuda", dtype=dtype)
        xn = torch.randn((MAIN_BATCH, IMG, IMG, 3), device="cuda").to(dtype)
        with torch.inference_mode():
            fwd = cuda_ms(lambda: clf.forward_normalized(xn), 20)
        print(f"[time] ResNet-50 forward alone, {dtype}, B={MAIN_BATCH}: {fwd:.3f} ms, "
              f"{MAIN_BATCH / fwd * 1e3:.1f} img/s | {card}")
    clf = main["solver"].classifier
    gen = torch.Generator(device="cuda").manual_seed(0)
    fused_ms = {}
    with torch.inference_mode():
        x01 = pc.to_unit(imgs)
        for corruption in MAIN_CORRUPTIONS:
            step = cuda_ms(lambda: online_logits(clf, corruption, 3, imgs, 77), 10)
            alone = cuda_ms(lambda: pc.corrupt_batch(x01, corruption, 3, generator=gen), 10)
            print(f"[time] online step {corruption}/3 (corrupt + forward, bf16), "
                  f"pre-staged B={MAIN_BATCH}: {step:.3f} ms, "
                  f"{MAIN_BATCH / step * 1e3:.1f} img/s; the corruption alone "
                  f"{alone:.3f} ms | {card}")

            def fused_step():
                torch.stack([online_logits(clf, corruption, s, imgs, s)
                             for s in SEVERITIES]).cpu()

            fused_step()
            torch.cuda.synchronize()
            t = time.time()
            for _ in range(3):
                fused_step()
            fused_ms[corruption] = (time.time() - t) / 3 * 1e3
            print(f"[time] fused online step, {corruption} x {len(SEVERITIES)} "
                  f"severities + one fetch, pre-staged B={MAIN_BATCH}: "
                  f"{fused_ms[corruption]:.2f} ms/batch, "
                  f"{MAIN_BATCH * len(SEVERITIES) / fused_ms[corruption] * 1e3:.1f} "
                  f"img/s | {card}")

    solver_rate = main["n_img"] / main["wall"]
    loader = build_dataloader(main_config(MAIN_BATCH).data, "test")
    t = time.time()
    for _ in loader:
        pass
    load_s = time.time() - t
    n_batches = -(-MAIN_LIMIT // MAIN_BATCH)
    # one pass over the clean set per corruption, all severities per batch
    step_share = n_batches * sum(fused_ms.values()) / 1e3 / main["wall"]
    load_share = load_s * len(MAIN_CORRUPTIONS) / main["wall"]
    if step_share >= 0.5:
        label = "device-bound"
    elif load_share >= 0.5:
        label = "host-bound: FakeDataset's PIL decode and resize set the pace"
    else:
        label = ("host-bound: result-file JSON, the evaluator and first-call "
                 "set-up take the rest")
    print(f"[time] solver end to end: {main['n_img']} corrupted images in "
          f"{main['wall']:.2f}s = {solver_rate:.1f} img/s; pre-staged steps "
          f"{step_share:.0%} of the run, loader alone {load_s:.2f}s per pass = "
          f"{load_share:.0%} ({label}) | {card}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        from robustart_torch.ops import noise as k1
    except ImportError as exc:
        print(f"chip_smoke: robustart_torch is not beside {__file__}: {exc}",
              file=sys.stderr)
        return 2

    try:
        card = card_line()
        print(f"[device] {card}")
        print(f"[device] torch {torch.__version__} CUDA {torch.version.cuda} "
              f"python {sys.version.split()[0]} cards={torch.cuda.device_count()}")
        check(not torch.backends.cuda.matmul.allow_tf32,
              "float32 matmuls run in TF32: the blurs must be full float32")
        phase_build()
        k1_res = phase_k1(k1, card)
        new = phase_new_kernels(card)
        main_run = phase_main_path(card)
        phase_reference_check(card)
        times = time_kernels(card, k1_res, new, hbm_rate(torch.cuda.get_device_name(0)))
        time_path(card, main_run)
    except Failed as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(RESULTS, ignore_errors=True)

    errs = {"fused_noise_normalize": k1_res["max_abs_err"], **new["max_abs_err"]}
    print(json.dumps({"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": main_run["launches"][name],
            "max_abs_err": errs[name],
            **times[name],
        }
        for name, (source, replaces) in KERNELS.items()
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
