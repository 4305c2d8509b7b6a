#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (robustart_torch) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failed check exits non-zero before the last line):

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions;
2. build the fused noise kernel K1 (csrc/fused_noise.cu, sm_90a) and hold
   it against its plain PyTorch version on the card: B=64 at 224², every
   noise mode × {normalized bf16, normalized f32, centered_u8 int8}, the
   noise statistics and the seed/image streams; then at the main path's
   shape;
3. the main path at full width: ``MultiEvalSolver`` online ImageNet-C on
   the fake backend, resnet50_official at 224² in bf16 with random weights
   from the seed, batch 128, gaussian_noise and shot_noise at severities
   1-5, with K1's launches counted; then the online chain on the card
   against the same chain on the CPU at a small input;
4. times, with the card's name and power limit beside each: K1 per launch
   against its bound, ResNet-50 forward alone (bf16, f32), the whole online
   step per batch on a pre-staged batch, the solver's own img/s;
5. one JSON line describing every kernel of the path;
6. the last line: ``{"ok": true, "device": {...}}``.

Exits non-zero without a result where ``torch.cuda.is_available()`` is
false, and where the ``robustart_torch`` package is not beside this file.
"""

from __future__ import annotations

import json
import os
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
MAIN_CORRUPTIONS = ["gaussian_noise", "shot_noise"]
SEVERITIES = [1, 2, 3, 4, 5]
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
# device-memory rate of each card (NVIDIA data sheets), bytes/s
HBM_BYTES_PER_S = {
    "H100 80GB HBM3": 3.35e12,  # SXM
    "H100 PCIe": 2.0e12,
    "H100 NVL": 3.9e12,
    "H200": 4.8e12,
}
FP32_FLOPS_PER_S = 67e12  # H100 SXM, outside the tensor cores
# K1's float32 work per element (gaussian): 2 uniforms (2 each), log, sqrt,
# cos (1 each), 4 multiplies/adds, clip (2), floor, 3 normalize steps
K1_FLOPS_PER_ELEMENT = 19


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


def phase_kernel(k1, card: str) -> dict:
    """Phase 2: build K1 and hold it against its plain version."""
    t = time.time()
    k1.build_kernel()
    print(f"[build] fused_noise.cu built/loaded for sm_90a in {time.time() - t:.1f}s")
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


def phase_main_path(k1, card: str) -> dict:
    """Phase 3: the ImageNet-C solver, online, at full width."""
    from robustart_torch.solvers import MultiEvalSolver

    shutil.rmtree(RESULTS, ignore_errors=True)
    solver = MultiEvalSolver(main_config(MAIN_BATCH))  # device: cuda by default
    solver.build_model(seed=0)
    k1.fused_noise_normalize.launches = 0
    t0 = time.time()
    summary = solver.evaluate()
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = k1.fused_noise_normalize.launches
    n_batches = -(-MAIN_LIMIT // MAIN_BATCH)
    print(f"[main] K1 launches in the solver run: {launches} "
          f"(expected {n_batches} batches x {len(SEVERITIES)} gaussian severities)")
    check(launches == n_batches * len(SEVERITIES), "K1 launch count off the main path")
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


def phase_reference_check(card: str) -> None:
    """Phase 3b: the online chain on the card against the same chain on the
    CPU (plain K1, CPU convolutions) at a small input, float32."""
    from robustart_torch.models import create_classifier
    from robustart_torch.noise.corruptions import shot_noise, uint8_roundtrip
    from robustart_torch.solvers.multi_eval_solver import online_logits

    gpu = create_classifier("resnet50_official", seed=1, device="cuda")
    cpu = create_classifier("resnet50_official", seed=1, device="cpu")
    imgs = torch.from_numpy(
        np.random.default_rng(5).integers(0, 256, (2, IMG, IMG, 3), np.uint8)
    )
    with torch.inference_mode():
        for noise in ("gaussian_noise", "impulse_noise"):
            a = online_logits(gpu, noise, 3, imgs.cuda(), 4242).cpu()
            b = online_logits(cpu, noise, 3, imgs, 4242)
            err = float((a - b).abs().max()) / float(b.abs().max())
            print(f"[check] {noise} chain, card vs CPU: rel max|dlogit|={err:.2e}")
            check(err <= 1e-3 and torch.equal(a.argmax(-1), b.argmax(-1)),
                  f"{noise} chain disagrees with the CPU reference ({err})")
        u = torch.rand(imgs.shape, generator=torch.Generator().manual_seed(0))
        x01 = imgs.float() / 255.0
        a = gpu(uint8_roundtrip(shot_noise(x01.cuda(), 3, uniform=u.cuda()))).cpu()
        b = cpu(uint8_roundtrip(shot_noise(x01, 3, uniform=u)))
        err = float((a - b).abs().max()) / float(b.abs().max())
        print(f"[check] shot_noise chain (injected uniforms), card vs CPU: "
              f"rel max|dlogit|={err:.2e}")
        check(err <= 1e-3, f"shot_noise chain disagrees with the CPU reference ({err})")


def phase_times(k1, card: str, kernel: dict, main: dict) -> dict:
    """Phase 4: device times, each printed beside the card."""
    from robustart_torch.data import build_dataloader
    from robustart_torch.models import create_classifier
    from robustart_torch.noise.corruptions import shot_noise, uint8_roundtrip
    from robustart_torch.solvers.multi_eval_solver import online_logits

    name = torch.cuda.get_device_name(0)
    rate = hbm_rate(name)

    def k1_times(x, kw, iters):
        ms = cuda_ms(lambda: k1.fused_noise_normalize(x, 5, **kw), iters)
        elems = x.numel()
        out_bytes = torch.empty((), dtype=kw["out_dtype"]).element_size()
        bytes_ms = elems * (1 + out_bytes) / rate * 1e3
        ops_ms = elems * K1_FLOPS_PER_ELEMENT / FP32_FLOPS_PER_S * 1e3
        return ms, max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"

    res = {}
    x, kw = kernel["input"], kernel["kw"]
    ms, bound, by = k1_times(x, kw, 200)
    plain = cuda_ms(lambda: k1.fused_noise_normalize_reference(x, 5, **kw), 5, warmup=1)
    res.update(ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by)
    print(f"[time] K1 B={x.shape[0]} {IMG}^2 bf16: {ms:.4f} ms/launch, plain "
          f"{plain:.3f} ms, bound {bound:.4f} ms ({by}), {bound / ms:.1%} of bound "
          f"| {card}")
    x256 = torch.randint(0, 256, (256, IMG, IMG, 3), dtype=torch.uint8, device="cuda")
    ms256, bound256, by256 = k1_times(x256, kw, 200)
    print(f"[time] K1 B=256 {IMG}^2 bf16: {ms256:.4f} ms/launch, bound "
          f"{bound256:.4f} ms ({by256}) | {card}")
    del x256

    imgs = torch.randint(0, 256, (MAIN_BATCH, IMG, IMG, 3), dtype=torch.uint8,
                         device="cuda")
    for dtype in (torch.bfloat16, torch.float32):
        clf = create_classifier("resnet50_official", seed=0, device="cuda", dtype=dtype)
        xn = torch.randn((MAIN_BATCH, IMG, IMG, 3), device="cuda").to(dtype)
        with torch.inference_mode():
            fwd = cuda_ms(lambda: clf.forward_normalized(xn), 20)
        print(f"[time] ResNet-50 forward alone, {dtype}, B={MAIN_BATCH}: {fwd:.3f} ms, "
              f"{MAIN_BATCH / fwd * 1e3:.1f} img/s | {card}")
        res[f"forward_ms_{dtype}"] = fwd
    clf = main["solver"].classifier
    with torch.inference_mode():
        for corruption in MAIN_CORRUPTIONS:
            step = cuda_ms(lambda: online_logits(clf, corruption, 3, imgs, 77), 20)
            print(f"[time] online step {corruption} (corrupt + forward, bf16), pre-staged "
                  f"B={MAIN_BATCH}: {step:.3f} ms, {MAIN_BATCH / step * 1e3:.1f} img/s "
                  f"| {card}")
        gen = torch.Generator(device="cuda").manual_seed(0)
        x01 = imgs.float() / 255.0
        shot = cuda_ms(lambda: uint8_roundtrip(shot_noise(x01, 3, generator=gen)), 10)
        print(f"[time] exact shot_noise corruption alone (plain torch), B={MAIN_BATCH}: "
              f"{shot:.3f} ms | {card}")

        fused_ms = {}
        for corruption in MAIN_CORRUPTIONS:
            def fused_step():
                torch.stack([online_logits(clf, corruption, s, imgs, s)
                             for s in SEVERITIES]).cpu()

            fused_step()
            torch.cuda.synchronize()
            t = time.time()
            for _ in range(5):
                fused_step()
            fused_ms[corruption] = (time.time() - t) / 5 * 1e3
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
    return res


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
        kernel = phase_kernel(k1, card)
        main_run = phase_main_path(k1, card)
        phase_reference_check(card)
        times = phase_times(k1, card, kernel, main_run)
    except Failed as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(RESULTS, ignore_errors=True)

    print(json.dumps({"kernels": [{
        "name": "fused_noise_normalize",
        "route": "cuda",
        "source": "robustart_torch/csrc/fused_noise.cu",
        "replaces": "robustart_tpu/ops/pallas_noise.py:141",
        "launches": main_run["launches"],
        "max_abs_err": kernel["max_abs_err"],
        "ms": times["ms"],
        "plain_ms": times["plain_ms"],
        "bound_ms": times["bound_ms"],
        "bound_by": times["bound_by"],
        "library_ms": None,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
