#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (robustart_torch) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failed check exits non-zero before the last line):

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions;
2. build the ten kernel sources of ``robustart_torch/csrc/`` for sm_90a,
   one nvcc each, all at once (``robustart_torch.ops.build``), and print
   the registers (``nvcc -Xptxas -v``) and shared memory of the attention
   core's and the fused product's kernels, of the dense block's three
   bf16 kernels (the BN1-ReLU pass, the product's relu(acc·g2 + b2) form,
   the 3×3) and of the token-mixing MLP's (the statistics pass and the
   fused wgmma kernel at each compiled token width, which must not spill);
3. each kernel against its plain PyTorch version on the card: K1 (fused
   noise) at B=64 and B=128, 224², every noise mode × {normalized bf16,
   normalized f32, centered_u8 int8}, its noise statistics and streams; K2
   (warp), K3 (motion taps, C = 3 and C = 1), K4 (glass shuffle) and K5
   (chamfer) at the main path's shape (B=128, 224²) and at 3×56×40; K6
   (window block) and K7 (MLP) at ViT-B's shape (128 images of 197 tokens,
   C = 768) and K8 (attention) at DeiT-Tiny's (128, 197, 3 heads of 64),
   each also at 3 images of 50 tokens, C = 192, in bf16 and f32; K9 (window
   attention) at Swin-T's stage-0 shape (8192 windows of 49 tokens, 3 heads
   of 32) with and without the shift mask, K6 in its Swin form (bias and
   mask, head width 32) at Swin-B's stage-0 shape (8192 × 49 × 128), K11
   (depthwise 7×7 + LN) at ConvNeXt-B's first and last stages
   (128×56×56×128, 128×7×7×1024), K7 in its ConvNeXt form (gamma and
   shortcut, 401,408 × 128, hidden 512), K10 (token-mixing MLP) at
   Mixer-B/16's shape (128 × 196 × 768, hidden 384, LN prologue and raw-x
   residual) and Mixer-L/16's (128 × 196 × 1024, hidden 512), and at
   ragged shapes (3 images of 49 tokens at C 20, 50 at C 96 with hidden
   40, 256 at C 96), and K12 (dense block) at DenseNet-121's four blocks (128 ×
   56² × 64 with 6 layers, 28² × 128 with 12, 14² × 256 with 24, 7² × 512
   with 16; bf16: three launches a layer), each also at 3 images, in bf16
   and f32; and, checked only,
   K8 at CLIP-L/14's 257 tokens (128 × 257 × 16 heads of 64) and at
   ViT-B/16's 577 tokens at 384 px (2 images), and K7 with CLIP's
   quick_gelu (3 × 257 × 1024);
4. the main paths at full width, each with every kernel's launches counted
   from zero and held against the count the code implies: ``MultiEvalSolver``
   online ImageNet-C on the fake backend with random weights from the seed,
   batch 128, 256 images, severities 1-5: resnet50_official in bf16 on two
   noise and eight blur, weather and digital corruptions; vit_base (ViT-B/16)
   in bf16 on gaussian_noise, shot_noise, glass_blur and elastic_transform;
   deit_tiny_b16_224, swin_base, swin_tiny, convnext_base, mixer_b16_224
   and densenet121 in bf16 on gaussian_noise; then each corruption's chain
   on the card against the same chain on the CPU at a small input, the
   random draws injected, for ResNet-50, ViT-B and DeiT-Tiny, and the
   gaussian_noise chain of Swin-T, ConvNeXt-B, Mixer-B/16 and DenseNet-121
   with their bias tables, layer-scale and BatchNorms drawn at a scale that
   reaches the logits, DenseNet-121's in bf16 (its three launches a
   layer) against the CPU's fused forward on the same K1 batch, and
   Mixer-B/16's in bf16 (K10's two launches on the packed weights)
   against the CPU's bf16 forward on the same K1 batch;
5. times, with the card's name and power limit beside each: each kernel
   against its plain version, its bound and the one PyTorch call that
   computes the same function where there is one (CUDA events over many
   calls, and in bf16 the device time of one call from torch.profiler,
   which leaves out the host's gaps between launches); beside K6's and
   K7's, each of their products against ``torch.matmul`` on the bare bf16
   product of the same shapes, beside K10's, its two launches (the
   statistics pass and the fused kernel) one by one and ``torch.matmul``'s
   two batched products of the same shapes without LN or activation, and
   beside K12's, cuDNN's bare bf16 1×1 and 3×3 convolutions of each
   block's widest layer (the yardsticks are never used by the port);
   ResNet-50, ViT-B, Swin-B, Swin-T, ConvNeXt-B, Mixer-B/16 and
   DenseNet-121 forwards alone
   (bf16, f32), the last five broken down by kernel, DenseNet-121's also
   in device time (``torch.profiler``) beside its CUDA-event time; each
   corruption's online step on a pre-staged batch; the solvers' own img/s;
6. one JSON line describing every kernel of the paths, the card's line, and
   the last line: ``{"ok": true, "device": {...}}``.

Exits non-zero without a result where ``torch.cuda.is_available()`` is
false, and where the ``robustart_torch`` package is not beside this file.
"""

from __future__ import annotations

import json
import math
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
VIT_CORRUPTIONS = ["gaussian_noise", "shot_noise", "glass_blur", "elastic_transform"]
DEIT_CORRUPTIONS = ["gaussian_noise"]
# the runs on gaussian_noise alone: K1 feeds the model, every block's kernels run
GAUSSIAN_MODELS = ["swin_base", "swin_tiny", "convnext_base", "mixer_b16_224", "densenet121"]
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
BF16_FLOPS_PER_S = 989e12  # H100 SXM, dense bf16 tensor cores
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
    # K6 is three launches: two of linear_fused.cu around one of attention_core.cu
    "window_block": ("robustart_torch/csrc/linear_fused.cu",
                     "robustart_tpu/ops/pallas_attention.py:628"),
    "mlp": ("robustart_torch/csrc/linear_fused.cu", "robustart_tpu/ops/pallas_mlp.py:200"),
    "mha": ("robustart_torch/csrc/attention_core.cu",
            "robustart_tpu/ops/pallas_attention.py:52"),
    "window_mha": ("robustart_torch/csrc/attention_core.cu",
                   "robustart_tpu/ops/pallas_attention.py:203"),
    "dwconv_ln": ("robustart_torch/csrc/dwconv_ln.cu",
                  "robustart_tpu/ops/pallas_convnext.py:84"),
    "token_mlp": ("robustart_torch/csrc/token_mlp.cu", "robustart_tpu/ops/pallas_mlp.py:461"),
    "dense_block": ("robustart_torch/csrc/dense_block.cu",
                    "robustart_tpu/ops/pallas_densenet.py:141"),
}
# why a kernel's library column is empty, where no one PyTorch call computes it
NO_LIBRARY = {
    "token_mlp": "no single torch call: LN over C, then an MLP over the token axis",
    "dense_block": "no single torch call: a chain of folded BN, 1x1, BN, 3x3 per layer",
}
MODEL_KERNELS = ("window_block", "mlp", "mha", "window_mha", "dwconv_ln", "token_mlp",
                 "dense_block")
SOURCES = {"window_block": ["robustart_torch/csrc/linear_fused.cu",
                            "robustart_torch/csrc/attention_core.cu"],
           "dense_block": ["robustart_torch/csrc/dense_block.cu",
                           "robustart_torch/csrc/linear_fused.cu"]}
# each model's kernel launches per forward in bf16, by the JAX package's
# block_kernel_head_groups rule: ViT-B (C = 768, 12 heads) takes K6 in every
# block, DeiT-Tiny (C = 192) K8; Swin-B takes K6 in all 24 blocks, Swin-T
# K9 in its 4 blocks at C = 96 and 192 and K6 in the other 8; every
# transformer block K7; ConvNeXt-B K11 and K7 in each of its 36 blocks;
# Mixer-B/16 K10 and K7 in each of its 12 blocks; DenseNet-121 one K12 call
# per dense block (4), three launches per layer (3 × (6 + 12 + 24 + 16)):
# the BN1-ReLU pass, the 1×1 product and the 3×3
PER_FORWARD = {
    "vit_base": {"window_block": 12, "mlp": 12},
    "deit_tiny_b16_224": {"mha": 12, "mlp": 12},
    "swin_base": {"window_block": 24, "mlp": 24},
    "swin_tiny": {"window_mha": 4, "window_block": 8, "mlp": 12},
    "convnext_base": {"dwconv_ln": 36, "mlp": 36},
    "mixer_b16_224": {"token_mlp": 12, "mlp": 12},
    "densenet121": {"dense_block": 174},
}
# K12's calls (one per dense block) per forward
DENSE_CALLS_PER_FORWARD = {"densenet121": 4}
# the kernels each solver run must launch: its model's and its corruptions'
PATH_KERNELS = {
    "resnet50_official": {"fused_noise_normalize", "warp_bilinear", "motion_taps",
                          "glass_shuffle", "chamfer"},
    "vit_base": {"fused_noise_normalize", "warp_bilinear", "glass_shuffle", "window_block",
                 "mlp"},
    "deit_tiny_b16_224": {"fused_noise_normalize", "mha", "mlp"},
    "swin_base": {"fused_noise_normalize", "window_block", "mlp"},
    "swin_tiny": {"fused_noise_normalize", "window_mha", "window_block", "mlp"},
    "convnext_base": {"fused_noise_normalize", "dwconv_ln", "mlp"},
    "mixer_b16_224": {"fused_noise_normalize", "token_mlp", "mlp"},
    "densenet121": {"fused_noise_normalize", "dense_block"},
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


def device_ms(fn, iters: int = 10) -> float | None:
    """Device time of one ``fn()`` (every kernel and memset it launches),
    from ``torch.profiler`` over ``iters`` calls after one warm-up: the time
    the card is busy, without the host's gaps between launches that
    :func:`cuda_ms` counts where a call's host work outlasts its kernels.
    None where the trace holds no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if getattr(e, "device_type", None) == DeviceType.CUDA)
    return total / 1e3 / iters if total else None


def levels(out: torch.Tensor) -> torch.Tensor:
    """uint8 levels of a K1 output (exact for f32 and int8)."""
    if out.dtype == torch.int8:
        return out.to(torch.int32) + 128
    mean = torch.tensor(MEAN, device=out.device)
    std = torch.tensor(STD, device=out.device)
    return torch.round((out.float() * std + mean) * 255.0).to(torch.int32)


def kernel_name(mangled: str) -> str:
    """``name<template args>`` of a mangled CUDA kernel name."""
    import re

    end = mangled.find("_kernel") + len("_kernel")
    if end < len("_kernel"):
        return mangled
    for start in range(end - len("_kernel"), 0, -1):
        j = start
        while j > 0 and mangled[j - 1].isdigit():
            j -= 1
        if any(int(mangled[i:start]) == end - start for i in range(j, start)):
            args = re.findall(r"L[ib](\d+)E", mangled[end:])
            return mangled[start:end] + (f"<{', '.join(args)}>" if args else "")
    return mangled


def ptxas_usage(log: str) -> list[str]:
    """``kernel<args>: N registers`` (and spills) of each entry function in
    an nvcc ``-Xptxas -v`` log."""
    import re

    out, name = [], None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            name = kernel_name(entry.group(1))
        spill = re.search(r"(\d+) bytes spill stores", line)
        if spill and int(spill.group(1)) and name:
            name += f" ({spill.group(1)} bytes spilled)"
        used = re.search(r"Used (\d+) registers", line)
        if used and name:
            out.append(f"{name}: {used.group(1)} registers")
            name = None
    return out


def phase_build() -> None:
    """Phase 2: build every kernel from the checkout's sources, in parallel;
    print ptxas's registers of the redesigned kernels (attention_core.cu,
    linear_fused.cu, dense_block.cu, token_mlp.cu) and the shared memory
    their launches take; fail where token_mlp.cu's bf16 kernels spill."""
    import ctypes

    from robustart_torch.ops import build

    t = time.time()
    built = build.build()
    print(f"[build] {len(built)} of {len(build.KERNELS)} kernels built for sm_90a "
          f"({', '.join(built)}), one nvcc each in parallel, in {time.time() - t:.1f}s")
    regs, smem = ctypes.c_int(), ctypes.c_int()
    for name in ("attention_core", "linear_fused"):
        usage = "; ".join(ptxas_usage(build.build_log(name)))
        print(f"[build] {name}.cu, nvcc -Xptxas -v: {usage}")
        lib = build.library(name)
        forms = ([(f"{'bf16' if dt else 'f32'} D={dp}", (dp, dt, 0)) for dp in (32, 64, 128)
                  for dt in (1, 0)] if name == "attention_core"
                 else [("bf16 GEMM", (1,)), ("f32", (0,))])
        for label, args in forms:
            fn = getattr(lib, f"{name}_resources")
            err = fn(*args, ctypes.byref(regs), ctypes.byref(smem))
            check(err == 0, f"{name}_resources{args} failed with cudaError {err}")
            print(f"[build] {name} {label}: {regs.value} registers a thread, "
                  f"{smem.value} bytes of shared memory a block")
    # K12's three bf16 kernels: the pass and the 3x3 (dense_block.cu), the
    # product's relu(acc·g2 + b2) form (linear_fused.cu's GEMM, act code 5)
    usage = "; ".join(ptxas_usage(build.build_log("dense_block")))
    print(f"[build] dense_block.cu, nvcc -Xptxas -v: {usage}")
    lib = build.library("dense_block")
    for label, which in (("bf16 BN1-ReLU pass", 0), ("bf16 3x3 at mid 128", 1), ("f32 layer", 2)):
        err = lib.dense_block_resources(which, ctypes.byref(regs), ctypes.byref(smem))
        check(err == 0, f"dense_block_resources({which}) failed with cudaError {err}")
        print(f"[build] dense_block {label}: {regs.value} registers a thread, "
              f"{smem.value} bytes of shared memory a block")
    form = [u for u in ptxas_usage(build.build_log("linear_fused"))
            if u.startswith("gemm_bf16_kernel<5>")]
    check(len(form) == 1, "no gemm_bf16_kernel<5> (K12's product form) in linear_fused's log")
    err = build.library("linear_fused").linear_fused_resources(1, ctypes.byref(regs),
                                                               ctypes.byref(smem))
    check(err == 0, f"linear_fused_resources(1) failed with cudaError {err}")
    print(f"[build] dense_block bf16 1x1 product: {form[0]}, {smem.value} bytes of shared "
          f"memory a block")
    # K10's bf16 kernels: the statistics pass and the fused kernel at each
    # compiled token width; the fused kernel holds yT in registers and must
    # not spill
    usage = ptxas_usage(build.build_log("token_mlp"))
    print(f"[build] token_mlp.cu, nvcc -Xptxas -v: {'; '.join(usage)}")
    spilled = [u for u in usage if "spilled" in u and "bf16" in u]
    check(not spilled, f"token_mlp.cu's bf16 kernels spill: {spilled}")
    lib = build.library("token_mlp")
    for which, label in enumerate(("bf16 statistics pass", "bf16 fused Tp 64",
                                   "bf16 fused Tp 128", "bf16 fused Tp 208",
                                   "bf16 fused Tp 256", "f32 kernel")):
        err = lib.token_mlp_resources(which, ctypes.byref(regs), ctypes.byref(smem))
        check(err == 0, f"token_mlp_resources({which}) failed with cudaError {err}")
        print(f"[build] token_mlp {label}: {regs.value} registers a thread, "
              f"{smem.value} bytes of shared memory a block")


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


def arr(gen, *shape, s=1.0):
    return torch.randn(shape, device="cuda", generator=gen) * s


def block_inputs(b: int, n: int, c: int, heads: int, dtype, gen, nw: int = 0,
                 masked: bool = True) -> dict:
    """Inputs of K6, K7, K8 and K9 at one shape: activations of unit scale,
    LN parameters near identity, weights of std 1/√fan_in, small f32
    biases, the hidden width F = 4C. ``nw`` > 0 makes Swin's: b windows of
    49 tokens, a bias (H, 49, 49) of std 0.5, LN eps 1e-5, q/k/v as the
    views of a packed product and, where ``masked``, the real shift mask of
    ``nw`` window positions (a 56² or 14² stage)."""
    from robustart_torch.models.swin import shift_attn_mask

    d, f = c // heads, 4 * c
    w = [arr(gen, c, c, s=c ** -0.5).to(dtype) for _ in range(4)]
    bias = [arr(gen, c, s=0.05) for _ in range(4)]
    inp = {
        "x": arr(gen, b, n, c).to(dtype),
        "ln": (arr(gen, c, s=0.2) + 1.0, arr(gen, c, s=0.1)), "eps": 1e-6,
        "w": w, "b": bias, "w_qkv": torch.cat(w[:3]), "b_qkv": torch.cat(bias[:3]),
        "w1": arr(gen, f, c, s=c ** -0.5).to(dtype), "b1": arr(gen, f, s=0.05),
        "w2": arr(gen, c, f, s=f ** -0.5).to(dtype), "b2": arr(gen, c, s=0.05),
        "qkv": [arr(gen, b, n, heads, d).to(dtype) for _ in range(3)],
        "heads": heads, "rel_bias": None, "mask": None, "nw": 1,
    }
    if nw:
        packed = arr(gen, b, n, 3, heads, d).to(dtype)
        inp.update(eps=1e-5, rel_bias=arr(gen, heads, n, n, s=0.5),
                   qkv=[packed[:, :, 0], packed[:, :, 1], packed[:, :, 2]])
        if masked:
            side = 7 * math.isqrt(nw)
            inp.update(nw=nw, mask=torch.from_numpy(shift_attn_mask(side, side, 7, 3)).cuda())
    return inp


def swin_inputs(imgs: int, nw: int, heads: int, c: int, dtype, gen, masked: bool = True):
    return block_inputs(imgs * nw, 49, c, heads, dtype, gen, nw, masked)


def convnext_inputs(b: int, h: int, w: int, c: int, dtype, gen) -> dict:
    """Inputs of K11 (x NHWC, w (C, 1, 7, 7) of std 1/7, b and beta of std
    0.1) and of K7's ConvNeXt form on the same x (a shortcut of x's shape
    and type, F = 4C); gamma in [0.5, 1.5) for both."""
    f = 4 * c
    return {"x": arr(gen, b, h, w, c).to(dtype), "shortcut": arr(gen, b, h, w, c).to(dtype),
            "w": arr(gen, c, 1, 7, 7, s=1 / 7), "b": arr(gen, c, s=0.1),
            "beta": arr(gen, c, s=0.1), "gamma": torch.rand(c, device="cuda", generator=gen) + 0.5,
            "w1": arr(gen, f, c, s=c ** -0.5).to(dtype), "b1": arr(gen, f, s=0.05),
            "w2": arr(gen, c, f, s=f ** -0.5).to(dtype), "b2": arr(gen, c, s=0.05)}


def mixer_inputs(b: int, t: int, c: int, h: int, dtype, gen) -> dict:
    """Inputs of K10 in the Mixer's form: x (B, T, C) of unit scale, LN
    parameters near identity, W1 (H, T) and W2 (T, H) of std 1/√fan_in,
    small f32 biases."""
    return {"x": arr(gen, b, t, c).to(dtype), "ln": (arr(gen, c, s=0.2) + 1.0, arr(gen, c, s=0.1)),
            "w1": arr(gen, h, t, s=t ** -0.5).to(dtype), "b1": arr(gen, h, s=0.05),
            "w2": arr(gen, t, h, s=h ** -0.5).to(dtype), "b2": arr(gen, t, s=0.05)}


def dense_inputs(b: int, hw: int, c0: int, layers: int, dtype, gen) -> dict:
    """Inputs of K12 for one DenseNet-121 block (growth 32, mid 128): x
    (B, hw, hw, c0) of unit scale, folded BN scales in [0.5, 1.5) and shifts
    of std 0.1, W1 of std 1/√(the block's widest input), W2 of std
    1/√(9·mid)."""
    g, mid = 32, 128
    s = sum(c0 + li * g for li in range(layers))
    return {"x": arr(gen, b, hw, hw, c0).to(dtype),
            "params": (torch.rand((1, s), device="cuda", generator=gen) + 0.5,
                       arr(gen, 1, s, s=0.1),
                       arr(gen, s, mid, s=(c0 + (layers - 1) * g) ** -0.5).to(dtype),
                       torch.rand((layers, mid), device="cuda", generator=gen) + 0.5,
                       arr(gen, layers, mid, s=0.1),
                       arr(gen, layers * 9 * mid, g, s=(9 * mid) ** -0.5).to(dtype)),
            "kw": {"c0": c0, "growth": g, "n_layers": layers, "mid": mid}}


# K6-K12 against their plain versions: (form, label, timed, inputs, shape).
# A form is a kernel as one family calls it (FORM_KERNEL); each form's first
# timed row is the shape of its numbers in the kernels line. Timed rows are
# the paths' shapes; the others (3 images, no mask) are checked only.
CASES = [
    ("window_block", "ViT-B", True, block_inputs, (MAIN_BATCH, 197, 768, 12)),
    ("window_block", "3x50x192", False, block_inputs, (3, 50, 192, 3)),
    ("mlp", "ViT-B", True, block_inputs, (MAIN_BATCH, 197, 768, 12)),
    ("mlp", "3x50x192", False, block_inputs, (3, 50, 192, 3)),
    ("mha", "DeiT-Tiny", True, block_inputs, (MAIN_BATCH, 197, 192, 3)),
    ("mha", "3x50x192", False, block_inputs, (3, 50, 192, 3)),
    ("mha", "CLIP-L/14 257 tokens", False, block_inputs, (MAIN_BATCH, 257, 1024, 16)),
    ("mha", "ViT-B/16 at 384 px, 577 tokens", False, block_inputs, (2, 577, 768, 12)),
    ("mlp_quick_gelu", "CLIP-L/14 form 3x257x1024", False, block_inputs, (3, 257, 1024, 16)),
    ("window_mha", "Swin-T stage 0", True, swin_inputs, (MAIN_BATCH, 64, 3, 96)),
    ("window_mha", "Swin-T stage 0 unmasked", False, swin_inputs,
     (MAIN_BATCH, 64, 3, 96, False)),
    ("window_mha", "3 images", False, swin_inputs, (3, 4, 3, 96)),
    ("window_mha", "3 images unmasked", False, swin_inputs, (3, 4, 3, 96, False)),
    ("window_block_swin", "Swin-B stage 0", True, swin_inputs, (MAIN_BATCH, 64, 4, 128)),
    ("window_block_swin", "3 images", False, swin_inputs, (3, 4, 4, 128)),
    ("dwconv_ln", "ConvNeXt-B stage 0", True, convnext_inputs, (MAIN_BATCH, 56, 56, 128)),
    ("dwconv_ln", "ConvNeXt-B stage 3", True, convnext_inputs, (MAIN_BATCH, 7, 7, 1024)),
    ("dwconv_ln", "3x13x11x96", False, convnext_inputs, (3, 13, 11, 96)),
    ("mlp_convnext", "ConvNeXt-B stage 0", True, convnext_inputs, (MAIN_BATCH, 56, 56, 128)),
    ("mlp_convnext", "3x13x11x96", False, convnext_inputs, (3, 13, 11, 96)),
    ("token_mlp", "Mixer-B/16", True, mixer_inputs, (MAIN_BATCH, 196, 768, 384)),
    ("token_mlp", "3 images", False, mixer_inputs, (3, 196, 768, 384)),
    ("token_mlp", "Mixer-L/16", True, mixer_inputs, (MAIN_BATCH, 196, 1024, 512)),
    ("token_mlp", "3x49x20 hidden 40", False, mixer_inputs, (3, 49, 20, 40)),
    ("token_mlp", "3x50x96 hidden 40", False, mixer_inputs, (3, 50, 96, 40)),
    ("token_mlp", "3x256x96 hidden 384", False, mixer_inputs, (3, 256, 96, 384)),
    ("dense_block", "DenseNet-121 block 1", True, dense_inputs, (MAIN_BATCH, 56, 64, 6)),
    ("dense_block", "DenseNet-121 block 2", True, dense_inputs, (MAIN_BATCH, 28, 128, 12)),
    ("dense_block", "DenseNet-121 block 3", True, dense_inputs, (MAIN_BATCH, 14, 256, 24)),
    ("dense_block", "DenseNet-121 block 4", True, dense_inputs, (MAIN_BATCH, 7, 512, 16)),
    ("dense_block", "3 images block 1", False, dense_inputs, (3, 56, 64, 6)),
    ("dense_block", "3 images block 2", False, dense_inputs, (3, 28, 128, 12)),
    ("dense_block", "3 images block 3", False, dense_inputs, (3, 14, 256, 24)),
    ("dense_block", "3 images block 4", False, dense_inputs, (3, 7, 512, 16)),
]
FORM_KERNEL = {"window_block_swin": "window_block", "mlp_convnext": "mlp"}
# the models whose blocks call each of those forms (Swin's K7 is ViT's form)
FORM_MODELS = {"window_block_swin": ("swin_base", "swin_tiny"),
               "mlp_convnext": ("convnext_base",)}


def calls(form: str, inp: dict) -> tuple:
    """(kernel call, plain call) of one form on its inputs. K6 is called as
    the models call it, on the packed q/k/v weights; its plain version takes
    them one by one."""
    from robustart_torch.ops import attention, convnext, densenet, mlp

    x = inp["x"]
    if form == "token_mlp":
        # in bf16 on W1 and W2 packed once, as the model packs them
        args = (x, inp["w1"], inp["b1"], inp["w2"], inp["b2"])
        kw = {"ln": inp["ln"], "ln_eps": 1e-6, "residual_input": True}
        packed = (mlp.pack_token_weights(inp["w1"], inp["w2"])
                  if x.dtype == torch.bfloat16 else None)
        return (lambda: mlp.token_mlp(*args, **kw, packed=packed),
                lambda: mlp.token_mlp_reference(*args, **kw))
    if form == "dense_block":
        # W1's and W2's transposes packed once, as the model packs them
        args, kw = (x, *inp["params"]), inp["kw"]
        shape = {k: kw[k] for k in ("growth", "n_layers", "mid")}
        transposes = ({"w1t": densenet.pack_w1t(inp["params"][2], c0=kw["c0"], **shape),
                       "w2t": densenet.pack_w2t(inp["params"][5], **shape)}
                      if x.dtype == torch.bfloat16 else {})
        return (lambda: densenet.dense_block(*args, **kw, **transposes),
                lambda: densenet.dense_block_reference(*args, **kw))
    if form == "dwconv_ln":
        args = (x, inp["w"], inp["b"], inp["gamma"], inp["beta"])
        return lambda: convnext.dwconv_ln(*args), lambda: convnext.dwconv_ln_reference(*args)
    if form in ("mlp", "mlp_convnext", "mlp_quick_gelu"):
        args = (x, inp["w1"], inp["b1"], inp["w2"], inp["b2"])
        kw = ({"gamma": inp["gamma"], "residual": inp["shortcut"]} if form == "mlp_convnext"
              else {"ln": inp["ln"], "ln_eps": inp["eps"], "residual": x})
        if form == "mlp_quick_gelu":
            kw["act"] = "quick_gelu"
        return lambda: mlp.mlp(*args, **kw), lambda: mlp.mlp_reference(*args, **kw)
    if form == "mha":
        return lambda: attention.mha(*inp["qkv"]), lambda: attention.mha_reference(*inp["qkv"])
    bias, mask, nw = inp["rel_bias"], inp["mask"], {"num_windows": inp["nw"]}
    if form == "window_mha":
        args = (*inp["qkv"], bias, mask)
        return (lambda: attention.window_mha(*args, **nw),
                lambda: attention.window_mha_reference(*args, **nw))
    (lns, lnb), w, bb = inp["ln"], inp["w"], inp["b"]
    kw = {"num_heads": inp["heads"], "eps": inp["eps"], **nw}
    packed = (x, lns, lnb, inp["w_qkv"], inp["b_qkv"], w[3], bb[3], bias, mask)
    split = (x, lns, lnb, w[0], bb[0], w[1], bb[1], w[2], bb[2], w[3], bb[3], bias, mask)
    return (lambda: attention.window_block_qkv(*packed, **kw),
            lambda: attention.window_block_reference(*split, **kw))


def agree(name: str, got: torch.Tensor, ref: torch.Tensor, gen) -> float:
    """Hold a K6-K12 output to its plain version. f32: max|Δ| ≤ 1e-5·max|ref|,
    the order of the sums. bf16: max|Δ| within one bf16 ulp of max|ref|
    (each output rounds once; a sum in another order may round the other
    way), and the argmax of a random 10-class head on each image's mean
    output the same on every image whose top-2 gap in the plain version
    exceeds 1% of the largest logit (an ulp-level change can flip a closer
    tie, and among 128 images one usually is that close)."""
    exact32 = ref.dtype == torch.float32
    got, ref = got.float(), ref.float()
    top = float(ref.abs().max())
    err = float((got - ref).abs().max())
    if exact32:
        check(err <= 1e-5 * top, f"{name}: max|d| {err:.3e} > 1e-5 of {top:.3e}")
        return err
    ulp = 2.0 ** (math.floor(math.log2(top)) - 7)
    check(err <= ulp, f"{name}: max|d| {err:.3e} > one bf16 ulp {ulp:.3e} of {top:.3e}")
    b, n = ref.shape[:2]
    feats_g, feats_r = got.reshape(b, n, -1).mean(1), ref.reshape(b, n, -1).mean(1)
    head = torch.randn((feats_g.shape[1], 10), device="cuda", generator=gen)
    lg, lr = feats_g @ head, feats_r @ head
    top2 = lr.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 1e-2 * float(lr.abs().max())
    same = lg.argmax(-1) == lr.argmax(-1)
    check(bool(same[clear].all()), f"{name}: downstream argmax differs")
    print(f"[{name}] downstream argmax: {int(same.sum())} of {b} images equal; all "
          f"{int(clear.sum())} with a clear top-2 gap equal")
    return err


def phase_block_kernels(card: str) -> dict:
    """Phase 3, K6-K12: every row of CASES against its plain version, in
    bf16 and f32; K6 also through the entry that takes the q/k/v weights one
    by one, which must give the packed entry's bits. Returns each timed
    row's inputs and its bf16 error."""
    from robustart_torch.ops import attention

    gen = torch.Generator(device="cuda").manual_seed(2)
    errs, timed = {}, {}
    for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        for form, label, is_timed, make, shape in CASES:
            inp = make(*shape[:4], dtype, gen, *shape[4:])
            kernel, plain = calls(form, inp)
            got = kernel()
            ref = plain()
            torch.cuda.synchronize()
            name = f"{form} {label} {tag}"
            err = agree(name, got, ref, gen)
            if FORM_KERNEL.get(form, form) == "window_block":
                (lns, lnb), w, bb = inp["ln"], inp["w"], inp["b"]
                split = attention.window_block(
                    inp["x"], lns, lnb, w[0], bb[0], w[1], bb[1], w[2], bb[2], w[3], bb[3],
                    inp["rel_bias"], inp["mask"], num_heads=inp["heads"],
                    num_windows=inp["nw"], eps=inp["eps"])
                check(torch.equal(split, got), f"{name}: the split and packed entries differ")
            print(f"[{name}] shape {tuple(got.shape)}: max_abs_err={err:.3e} "
                  f"max|ref|={float(ref.float().abs().max()):.3e}")
            if is_timed:
                timed[(form, label, tag)] = inp
                if tag == "bf16":
                    errs.setdefault(form, err)
            del got, ref
    return {"max_abs_err": errs, "inputs": timed}


def valid_taps(n: int, k: int = 7) -> int:
    """Taps of a k-wide zero-padded window that land inside a line of n
    pixels, summed over the line."""
    r = k // 2
    return sum(min(i + r, n - 1) - max(i - r, 0) + 1 for i in range(n))


def work(form: str, inp: dict) -> tuple[float, float, float]:
    """(FLOPs of the products at the type's peak, other f32 instructions,
    bytes) of one call of a form: products at 2 FLOP a multiply-add, on the
    bf16 tensor cores or as f32 FMAs; each input read once and each output
    written once."""
    x = inp["x"]
    isz = x.element_size()
    c = x.shape[-1]
    m = x.numel() // c
    if form == "token_mlp":
        # the two products over T and H (the LN and GELU not counted, as for
        # K7); x in (also the residual), y out, the weights, the LN
        # parameters and biases
        b, t, _ = x.shape
        h = inp["w1"].shape[0]
        return 4 * b * c * t * h, 0, 2 * x.numel() * isz + 2 * t * h * isz + (h + t + 2 * c) * 4
    if form == "dense_block":
        # per layer: the 1×1 (c → mid) and the 3×3 (9·mid → g) products, and
        # the folded BN1 (mul, add, max on each input element) and BN2 (on
        # each bottleneck element); x in once, the block's output out once
        kw = inp["kw"]
        g, mid, n = kw["growth"], kw["mid"], kw["n_layers"]
        cs = [c + li * g for li in range(n)]
        flops = sum(2 * m * ci * mid + 2 * m * 9 * mid * g for ci in cs)
        other = sum(3 * m * ci + 3 * m * mid for ci in cs)
        out_c = c + n * g
        weights = (sum(cs) * mid + n * 9 * mid * g) * isz + (2 * sum(cs) + 2 * n * mid) * 4
        return flops, other, m * (c + out_c) * isz + weights
    if form == "dwconv_ln":
        b, h, w, _ = x.shape
        # one FMA per tap inside the image, the conv bias the accumulator's
        # start; the LN about 5 an element (the sum, the subtraction, the
        # squares' FMA, the scale, the affine FMA)
        return (2 * b * valid_taps(h) * valid_taps(w) * c, 5 * x.numel(),
                2 * x.numel() * isz + (49 + 3) * c * 4)
    if form in ("mlp", "mlp_convnext"):
        f = inp["w1"].shape[0]
        # ViT's form: x (also the residual) in, LN parameters; ConvNeXt's: a
        # separate shortcut in, gamma
        act, params = (2, 3 * c) if form == "mlp" else (3, 2 * c)
        return 4 * m * c * f, 0, (act * m * c + 2 * c * f) * isz + (f + params) * 4
    planes = sum(t.numel() * 4 for t in (inp["rel_bias"], inp["mask"]) if t is not None)
    q = inp["qkv"][0]
    bq, nq, hq, dq = q.shape
    core = 4 * bq * hq * nq * nq * dq
    if form in ("mha", "window_mha"):
        return core, 0, 4 * q.numel() * isz + planes
    # window_block: LN, q/k/v and proj products, attention core, residual
    return (8 * m * c * c + core, 0,
            (2 * m * c + 4 * c * c) * isz + 6 * c * 4 + planes)


def dense_design_bytes(inp: dict) -> float:
    """Bytes K12's bf16 three-launch design moves through device memory in
    one call: per layer 2·M·(3c + 2.1·mid + g), the pass's read and write of
    c channels, the product's read of a1 and write of t2, the 3×3's read of
    t2 with its halo (about 1.1×) and the g new channels. Its floor is this
    over the memory rate (the function's own bound stays ``work``'s)."""
    x, kw = inp["x"], inp["kw"]
    m, c0 = x.numel() // x.shape[-1], x.shape[-1]
    g, mid = kw["growth"], kw["mid"]
    return sum(2 * m * (3 * (c0 + li * g) + 2.1 * mid + g) for li in range(kw["n_layers"]))


def cudnn_dense_yardstick(inp: dict, card: str) -> dict:
    """cuDNN's bare bf16 1×1 (c → mid) and 3×3 (mid → g) convolutions of a
    block's widest layer, channels_last, via ``F.conv2d``: the products
    alone, never used by the port and no library call of the block (which
    has none). Returns {conv1x1_ms, conv3x3_ms}."""
    import torch.nn.functional as F

    x, kw = inp["x"], inp["kw"]
    b, h, w, c0 = x.shape
    c = c0 + (kw["n_layers"] - 1) * kw["growth"]
    mid, g = kw["mid"], kw["growth"]
    cl = torch.channels_last
    a = torch.randn((b, c, h, w), device="cuda").to(torch.bfloat16).to(memory_format=cl)
    w1 = torch.randn((mid, c, 1, 1), device="cuda").to(torch.bfloat16).to(memory_format=cl)
    t = torch.randn((b, mid, h, w), device="cuda").to(torch.bfloat16).to(memory_format=cl)
    w2 = torch.randn((g, mid, 3, 3), device="cuda").to(torch.bfloat16).to(memory_format=cl)
    one = cuda_ms(lambda: F.conv2d(a, w1), 20)
    three = cuda_ms(lambda: F.conv2d(t, w2, padding=1), 20)
    print(f"[time] dense_block cuDNN yardstick at the block's widest layer (c {c}, "
          f"{b}x{h}x{w}): bare bf16 1x1 conv {one:.4f} ms, bare bf16 3x3 conv {three:.4f} ms, "
          f"channels_last, F.conv2d (the products alone, never used by the port, not a "
          f"library call of K12) | {card}")
    return {"conv1x1_ms": one, "conv3x3_ms": three}


def token_parts(inp: dict, card: str, rate: float) -> dict:
    """K10's bf16 call one launch at a time on the same inputs: the
    statistics pass (its bound: x read once, the statistics written once)
    and the fused kernel (the function's bound), each by CUDA events and by
    torch.profiler's device time; and ``torch.matmul``'s two batched bf16
    products of the same shapes (x̂ᵀ·W1ᵀ, then W2·aᵀ), no LN or activation,
    a yardstick never used by the port. Returns the numbers."""
    from robustart_torch.ops import mlp

    x, (ln_w, ln_b) = inp["x"], inp["ln"]
    b, t, c = x.shape
    h = inp["w1"].shape[0]
    packed = mlp.pack_token_weights(inp["w1"], inp["w2"])
    plan = mlp.token_plan(b, t, c, h)
    ln = (ln_w.float().contiguous(), ln_b.float().contiguous())
    stats = mlp.token_stats(x, 1e-6)
    b1, b2 = inp["b1"].float().contiguous(), inp["b2"].float().contiguous()
    parts = {"stats": (lambda: mlp.token_stats(x, 1e-6),
                       (x.numel() * x.element_size() + b * t * 8) / rate * 1e3),
             "fused": (lambda: mlp.token_fused(x, packed, b1, b2, plan, h, x, ln, stats),
                       work("token_mlp", inp)[0] / BF16_FLOPS_PER_S * 1e3)}
    out = {}
    for name, (fn, bnd) in parts.items():
        ms = cuda_ms(fn, 20, warmup=3)
        dev = device_ms(fn)
        out[f"{name}_ms"], out[f"{name}_device_ms"], out[f"{name}_bound_ms"] = ms, dev, bnd
        print(f"[time] token_mlp {tuple(x.shape)} hidden {h}, {name} launch alone: {ms:.4f} ms "
              f"(device {_ms(dev)}), bound {bnd:.4f} ms | {card}")
    xt, w1t = x.transpose(1, 2), inp["w1"].t()
    a = torch.randn((b, h, c), device="cuda").to(x.dtype)
    yard = cuda_ms(lambda: (torch.matmul(xt, w1t), torch.matmul(inp["w2"], a)), 20, warmup=3)
    out["cublas_products_ms"] = yard
    print(f"[time] token_mlp {tuple(x.shape)} hidden {h}: torch.matmul's two batched bf16 "
          f"products of the same shapes (no LN or activation; never used by the port) "
          f"{yard:.4f} ms | {card}")
    return out


def library_call(form: str, inp: dict, plain, tag: str):
    """The one PyTorch call that computes a form, checked against its plain
    version, or None: ``scaled_dot_product_attention`` for K8, and for K9
    with the bias and mask as one additive float mask."""
    import torch.nn.functional as F

    if form not in ("mha", "window_mha"):
        return None
    q, k, v = (t.transpose(1, 2).contiguous() for t in inp["qkv"])
    am = None
    if form == "window_mha":
        imgs = q.shape[0] // inp["nw"]
        am = (inp["rel_bias"][None] + inp["mask"][:, None]).to(q.dtype).repeat(imgs, 1, 1, 1)
    out = F.scaled_dot_product_attention(q, k, v, attn_mask=am).transpose(1, 2)
    err = float((out.float() - plain().float()).abs().max())
    print(f"[time] {form} library check: scaled_dot_product_attention vs plain {tag} "
          f"max|d|={err:.3e}")
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=am)


def product_yardstick(form: str, inp: dict, card: str) -> dict:
    """K6's and K7's products one by one in bf16: each ``linear_fused``
    launch of the form (with its prologue and epilogue) beside
    ``torch.matmul`` on the bare product of the same shapes, which is the
    product alone, never used by the port and no library call of the fused
    function. Returns {product: {ms, tflops, matmul_ms, matmul_tflops}}."""
    from robustart_torch.ops.linear import linear_fused

    x = inp["x"]
    c = x.shape[-1]
    x2 = x.reshape(-1, c)
    m = x2.shape[0]
    dev = x.device
    if FORM_KERNEL.get(form, form) == "mlp":
        f = inp["w1"].shape[0]
        h = torch.randn((m, f), device=dev).to(x.dtype)
        fc1_kw = ({"ln": inp["ln"], "eps": inp["eps"]} if form == "mlp" else {})
        fc2_kw = ({"residual": x2} if form == "mlp"
                  else {"gamma": inp["gamma"], "residual": inp["shortcut"].reshape(m, c)})
        products = {
            "fc1": (lambda: linear_fused(x2, inp["w1"], inp["b1"], act="gelu", **fc1_kw),
                    lambda: torch.matmul(x2, inp["w1"].t()), 2 * m * c * f),
            "fc1 without the LN pass": (
                lambda: linear_fused(x2, inp["w1"], inp["b1"], act="gelu"),
                lambda: torch.matmul(x2, inp["w1"].t()), 2 * m * c * f),
            "fc2": (lambda: linear_fused(h, inp["w2"], inp["b2"], **fc2_kw),
                    lambda: torch.matmul(h, inp["w2"].t()), 2 * m * c * f),
        }
        if form != "mlp":
            del products["fc1 without the LN pass"]
    else:
        lns, lnb = inp["ln"]
        wp, bp = inp["w"][3], inp["b"][3]
        products = {
            "q/k/v": (lambda: linear_fused(x2, inp["w_qkv"], inp["b_qkv"], ln=(lns, lnb),
                                           eps=inp["eps"]),
                      lambda: torch.matmul(x2, inp["w_qkv"].t()), 6 * m * c * c),
            "proj": (lambda: linear_fused(x2, wp, bp, residual=x2),
                     lambda: torch.matmul(x2, wp.t()), 2 * m * c * c),
        }
    out = {}
    for name, (ours, bare, flops) in products.items():
        ms = cuda_ms(ours, 20, warmup=3)
        mm = cuda_ms(bare, 20, warmup=3)
        out[name] = {"ms": ms, "tflops": flops / ms / 1e9, "matmul_ms": mm,
                     "matmul_tflops": flops / mm / 1e9}
        print(f"[time] {form} {name} product {tuple(x2.shape)}: linear_fused.cu {ms:.4f} ms "
              f"= {flops / ms / 1e9:.1f} TFLOP/s; torch.matmul on the bare bf16 product "
              f"(the product alone, never used by the port) {mm:.4f} ms = "
              f"{flops / mm / 1e9:.1f} TFLOP/s; {mm / ms:.0%} of its rate | {card}")
    return out


def _ms(v) -> str:
    return "not measured" if v is None else f"{v:.4f} ms"


def time_block_kernels(card: str, blk: dict, rate: float) -> dict:
    """Phase 5, K6-K12: each timed row of CASES in bf16 (the paths' type)
    and f32, against its plain version, its bound and the library call.
    Returns each form's bf16 numbers at its first timed row, and those of
    its other timed rows under ``shapes``."""
    res = {}
    for (form, label, tag), inp in blk["inputs"].items():
        kernel, plain = calls(form, inp)
        ms = cuda_ms(kernel, 20 if tag == "bf16" else 5, warmup=2)
        plain_ms = cuda_ms(plain, 3, warmup=1)
        flops, other, nbytes = work(form, inp)
        peak = BF16_FLOPS_PER_S if tag == "bf16" and form != "dwconv_ln" else FP32_FLOPS_PER_S
        b_ms, o_ms = nbytes / rate * 1e3, (flops / peak + other / FP32_OPS_PER_S) * 1e3
        bnd, by = max(b_ms, o_ms), "bytes" if b_ms >= o_ms else "operations"
        lib_fn = library_call(form, inp, plain, tag)
        lib = cuda_ms(lib_fn, 20) if lib_fn is not None else None
        dev = device_ms(kernel) if tag == "bf16" else None
        lib_dev = device_ms(lib_fn) if tag == "bf16" and lib_fn is not None else None
        lib_s = (f"library {lib:.4f} ms (device {_ms(lib_dev)})" if lib is not None
                 else f"library none ({NO_LIBRARY.get(form, 'no single torch call')})")
        per = ""
        if form == "dense_block":
            n = inp["kw"]["n_layers"] * (3 if tag == "bf16" else 1)
            per = f" ({ms / n:.4f} ms a launch, {n} launches)"
            if tag == "bf16":
                floor = dense_design_bytes(inp) / rate * 1e3
                per += f", the three-launch design's byte floor {floor:.4f} ms"
        print(f"[time] {form} {label} {tag} {tuple(inp['x'].shape)}: {ms:.4f} ms{per} "
              f"(device {_ms(dev)}), plain "
              f"{plain_ms:.3f} ms, bound {bnd:.4f} ms ({by}; {(flops + other) / 1e9:.2f} "
              f"GFLOP, {nbytes / 1e6:.1f} MB), {bnd / ms:.1%} of bound, "
              f"{(flops + other) / ms / 1e9:.1f} TFLOP/s, {lib_s} | {card}")
        if tag == "bf16":
            row = dict(shape=f"{label} {'x'.join(map(str, inp['x'].shape))} bf16", ms=ms,
                       plain_ms=plain_ms, bound_ms=bnd, bound_by=by, library_ms=lib,
                       device_ms=dev, library_device_ms=lib_dev,
                       tflops=(flops + other) / ms / 1e9)
            if FORM_KERNEL.get(form, form) in ("window_block", "mlp"):
                row["products"] = product_yardstick(form, inp, card)
            if form == "token_mlp":
                row.update(token_parts(inp, card, rate))
            if form == "dense_block":
                row["ms_per_launch"] = ms / (3 * inp["kw"]["n_layers"])
                row["design_floor_ms"] = dense_design_bytes(inp) / rate * 1e3
                row["cudnn_products"] = cudnn_dense_yardstick(inp, card)
            if form not in res:
                res[form] = row
            else:
                res[form].setdefault("shapes", []).append(row)
    return res


def expected_launches(n_batches: int, corruptions: list, model: str) -> dict:
    """Each kernel's launches in one solver run, from the code: one launch
    per call per batch and severity; K4 one per glass pass, K5 one per
    round; per forward, the model's kernels as PER_FORWARD states them (the
    split of the JAX rule, not read from the model under test)."""
    from robustart_torch.noise.corruptions import GLASS_SEVERITY, SPATTER_SEVERITY
    from robustart_torch.solvers.multi_eval_solver import FUSED_NOISE

    per = n_batches * len(SEVERITIES)  # forwards of one corruption
    water = [s for s in SEVERITIES if SPATTER_SEVERITY[s - 1][5] == 0]
    forwards = per * len(corruptions)
    model_kernels = PER_FORWARD.get(model, {})
    return {
        "fused_noise_normalize": per * sum(c in FUSED_NOISE for c in corruptions),
        "warp_bilinear": per * 2 * ("elastic_transform" in corruptions),  # two warps
        "motion_taps": per * sum(c in ("motion_blur", "snow") for c in corruptions),
        "glass_shuffle": n_batches * sum(GLASS_SEVERITY[s - 1][2] for s in SEVERITIES)
        * ("glass_blur" in corruptions),
        "chamfer": n_batches * len(water) * 12 * ("spatter" in corruptions),
        **{name: forwards * model_kernels.get(name, 0) for name in MODEL_KERNELS},
    }


def wrappers() -> dict:
    from robustart_torch.ops import attention, convnext, densenet, mlp, motion, noise, warp

    return {"fused_noise_normalize": noise.fused_noise_normalize,
            "warp_bilinear": warp.warp_bilinear, "motion_taps": motion.motion_taps,
            "glass_shuffle": motion.glass_shuffle, "chamfer": motion.chamfer,
            "window_block": attention.window_block, "mlp": mlp.mlp, "mha": attention.mha,
            "window_mha": attention.window_mha, "dwconv_ln": convnext.dwconv_ln,
            "token_mlp": mlp.token_mlp, "dense_block": densenet.dense_block}


def main_config(batch_size: int, model: str = "resnet50_official",
                corruptions: list = MAIN_CORRUPTIONS, limit: int = MAIN_LIMIT):
    from robustart_torch.core.config import Config

    return Config({
        "model": {"type": model, "dtype": "bf16"},
        "seed": 0,
        "data": {
            "read_from": "fake", "fake_size": limit, "batch_size": batch_size,
            "num_workers": 8, "input_size": IMG, "test_resize": 256,
            "test": {
                "imagenet_c_online": True,
                "corruptions": corruptions, "severities": SEVERITIES,
                "limit_samples": limit,
                "transforms": {"type": "JUSTNORM"},
                "evaluator": {"type": "imagenetc", "kwargs": {"topk": [1, 5]}},
            },
        },
        "saver": {"results_dir": str(RESULTS)},
    })


def phase_main_path(card: str, model: str = "resnet50_official",
                    corruptions: list = MAIN_CORRUPTIONS) -> dict:
    """Phase 4: the ImageNet-C solver, online, at full width, every count
    set to 0 just before the run and read just after."""
    from robustart_torch.solvers import MultiEvalSolver

    shutil.rmtree(RESULTS, ignore_errors=True)
    solver = MultiEvalSolver(main_config(MAIN_BATCH, model, corruptions))  # cuda by default
    solver.build_model(seed=0)
    dense_block = wrappers()["dense_block"]
    for fn in wrappers().values():
        fn.launches = 0
    dense_block.calls = 0
    t0 = time.time()
    summary = solver.evaluate()
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {name: fn.launches for name, fn in wrappers().items()}
    n_batches = -(-MAIN_LIMIT // MAIN_BATCH)
    want = expected_launches(n_batches, corruptions, model)
    calls = dense_block.calls
    want_calls = n_batches * len(SEVERITIES) * len(corruptions) * DENSE_CALLS_PER_FORWARD.get(
        model, 0)
    print(f"[main {model}] dense_block calls in the solver run: {calls} (expected {want_calls})")
    check(calls == want_calls, f"dense_block: {calls} calls on the {model} path, "
          f"expected {want_calls}")
    for name, n in launches.items():
        print(f"[main {model}] {name} launches in the solver run: {n} "
              f"(expected {want[name]})")
        check(n == want[name], f"{name}: {n} launches on the {model} path, "
              f"expected {want[name]}")
        check(n > 0 or name not in PATH_KERNELS[model],
              f"{name} was not launched on the {model} path")
    for corruption in corruptions:
        for s in SEVERITIES:
            path = RESULTS / corruption / str(s) / "results.txt.all"
            lines = path.read_text().splitlines()
            check(len(lines) == MAIN_LIMIT, f"{path}: {len(lines)} lines")
            scores = np.array([json.loads(line)["score"] for line in lines])
            check(scores.shape == (MAIN_LIMIT, 1000) and np.isfinite(scores).all(),
                  f"{path}: logits not finite or of the wrong shape")
            metric = json.loads((RESULTS / corruption / str(s) / "metric").read_text())
            print(f"[main {model}] {corruption}/{s}: top1={metric['top1']:.2f} "
                  f"top5={metric['top5']:.2f} ({len(lines)} lines)")
    mce = summary["mCE"]
    check(mce is not None and np.isfinite(mce), f"mCE not finite: {mce}")
    print(f"[main {model}] mCE={mce:.4f} "
          f"top1_per_corruption={summary['top1_per_corruption']}")
    n_img = MAIN_LIMIT * len(SEVERITIES) * len(corruptions)
    return {"launches": launches, "dense_block_calls": calls, "wall": wall, "n_img": n_img,
            "solver": solver}


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


def phase_vit_reference_check(card: str) -> None:
    """Phase 4b for the transformers: the ViT-B and DeiT-Tiny chains on the
    card against the same chains on the CPU (plain kernels, CPU BLAS) in
    float32 on two images: gaussian_noise through K1 (the same seed gives
    both the same noise) and elastic_transform with its draws injected.
    Relative max|Δlogit| ≤ 1e-3 and the same argmax."""
    from robustart_torch.models import create_classifier
    from robustart_torch.noise import corruptions as pc
    from robustart_torch.solvers.multi_eval_solver import online_logits

    imgs = torch.from_numpy(
        np.random.default_rng(6).integers(0, 256, (2, IMG, IMG, 3), np.uint8)
    )
    x01 = pc.to_unit(imgs)
    draws = injected_draws("elastic_transform", 3, *imgs.shape[:3])
    elastic = pc.CORRUPTIONS["elastic_transform"]
    for model in ("vit_base", "deit_tiny_b16_224"):
        gpu = create_classifier(model, seed=1, device="cuda")
        cpu = create_classifier(model, seed=1, device="cpu")
        with torch.inference_mode():
            chains = {
                "gaussian_noise": (online_logits(gpu, "gaussian_noise", 3, imgs.cuda(), 4242),
                                   online_logits(cpu, "gaussian_noise", 3, imgs, 4242)),
                "elastic_transform": (
                    gpu(pc.uint8_roundtrip(elastic(x01.cuda(), 3, **{
                        k: v.cuda() for k, v in draws.items()}))),
                    cpu(pc.uint8_roundtrip(elastic(x01, 3, **draws)))),
            }
        for name, (a, b) in chains.items():
            a = a.cpu()
            err = float((a - b).abs().max()) / float(b.abs().max())
            print(f"[check {model}] {name}/3 chain f32, card vs CPU: rel max|dlogit|={err:.2e}")
            check(err <= 1e-3 and torch.equal(a.argmax(-1), b.argmax(-1)),
                  f"{model} {name} chain disagrees with the CPU reference ({err})")


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


def phase_model_reference_check(card: str) -> None:
    """Phase 4b for Swin, ConvNeXt, Mixer and DenseNet: the gaussian_noise
    chain of Swin-T (K9, K6 with bias and mask, K7), ConvNeXt-B (K11, K7
    with gamma and shortcut), Mixer-B/16 (K10, K7) and DenseNet-121 (K12 on
    the card, the concat forward on the CPU) on the card against the same
    chain on the CPU, float32, two images, the bias tables, layer-scale and
    BatchNorms drawn at a scale that reaches the logits (``probe_init``).
    Relative max|Δlogit| ≤ 1e-3 and the same argmax."""
    from robustart_torch.models import create_classifier
    from robustart_torch.solvers.multi_eval_solver import online_logits

    imgs = torch.from_numpy(
        np.random.default_rng(7).integers(0, 256, (2, IMG, IMG, 3), np.uint8)
    )
    for model in ("swin_tiny", "convnext_base", "mixer_b16_224", "densenet121"):
        gpu = create_classifier(model, seed=1, device="cuda", probe_init=True)
        cpu = create_classifier(model, seed=1, device="cpu", probe_init=True)
        with torch.inference_mode():
            a = online_logits(gpu, "gaussian_noise", 3, imgs.cuda(), 4242).cpu()
            b = online_logits(cpu, "gaussian_noise", 3, imgs, 4242)
        err = float((a - b).abs().max()) / float(b.abs().max())
        print(f"[check {model}] gaussian_noise/3 chain f32, probe init, card vs CPU: "
              f"rel max|dlogit|={err:.2e} (max|logit| {float(b.abs().max()):.3e})")
        check(err <= 1e-3 and torch.equal(a.argmax(-1), b.argmax(-1)),
              f"{model} gaussian_noise chain disagrees with the CPU reference ({err})")


def phase_densenet_bf16_check(card: str) -> None:
    """Phase 4b for K12's bf16 path: DenseNet-121 in bf16 (probe init, two
    images) on the card, every dense block through the three launches a
    layer, against the CPU's fused forward (K12's plain version) on the same
    gaussian_noise/3 batch from K1. The same argmax on every image whose
    top-2 gap exceeds 1% of max|logit| (as ``agree`` holds a kernel), and
    relative max|Δlogit| ≤ 0.1: the two sum in other orders and round at
    the same places, over 58 layers."""
    from robustart_torch.models import create_classifier
    from robustart_torch.noise.corruptions import NOISE_SEVERITY
    from robustart_torch.ops.noise import fused_noise_normalize

    imgs = torch.from_numpy(
        np.random.default_rng(7).integers(0, 256, (2, IMG, IMG, 3), np.uint8)).cuda()
    kw = dict(seed=1, probe_init=True, dtype=torch.bfloat16)
    gpu = create_classifier("densenet121", device="cuda", **kw)
    cpu = create_classifier("densenet121", device="cpu", **kw)
    with torch.inference_mode():
        x = fused_noise_normalize(imgs, 4242, noise="gaussian_noise",
                                  sigma=NOISE_SEVERITY["gaussian_noise"][2], mean=gpu.mean,
                                  std=gpu.std, out_dtype=torch.bfloat16, output="normalized")
        a = gpu.forward_normalized(x).cpu()
        b = cpu.model.fused_forward(x.cpu())
    top = float(b.abs().max())
    err = float((a - b).abs().max()) / top
    top2 = b.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 1e-2 * top
    same = a.argmax(-1) == b.argmax(-1)
    print(f"[check densenet121] gaussian_noise/3 bf16, probe init, card (K12 three launches a "
          f"layer) vs the CPU's fused forward: rel max|dlogit|={err:.2e} (max|logit| "
          f"{top:.3e}); argmax equal on {int(same.sum())} of 2 images, all {int(clear.sum())} "
          f"with a clear top-2 gap | {card}")
    check(err <= 0.1 and bool(same[clear].all()),
          f"densenet121 bf16 chain disagrees with the CPU's fused forward ({err})")


def phase_mixer_bf16_check(card: str) -> None:
    """Phase 4b for K10's bf16 path: Mixer-B/16 in bf16 (probe init, two
    images) on the card, every block's K10 through its statistics pass and
    the fused kernel on the weights the model packs once, against the
    CPU's bf16 forward (K10's and K7's plain versions) on the same
    gaussian_noise/3 batch from K1. The same argmax on every image whose
    top-2 gap exceeds 1% of max|logit| (as ``agree`` holds a kernel), and
    relative max|Δlogit| ≤ 0.1: the two sum in other orders and round at
    the same places, over 12 blocks."""
    from robustart_torch.models import create_classifier
    from robustart_torch.noise.corruptions import NOISE_SEVERITY
    from robustart_torch.ops.noise import fused_noise_normalize

    imgs = torch.from_numpy(
        np.random.default_rng(7).integers(0, 256, (2, IMG, IMG, 3), np.uint8)).cuda()
    kw = dict(seed=1, probe_init=True, dtype=torch.bfloat16)
    gpu = create_classifier("mixer_b16_224", device="cuda", **kw)
    cpu = create_classifier("mixer_b16_224", device="cpu", **kw)
    with torch.inference_mode():
        x = fused_noise_normalize(imgs, 4242, noise="gaussian_noise",
                                  sigma=NOISE_SEVERITY["gaussian_noise"][2], mean=gpu.mean,
                                  std=gpu.std, out_dtype=torch.bfloat16, output="normalized")
        a = gpu.forward_normalized(x).cpu()
        b = cpu.forward_normalized(x.cpu())
    top = float(b.abs().max())
    err = float((a - b).abs().max()) / top
    top2 = b.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 1e-2 * top
    same = a.argmax(-1) == b.argmax(-1)
    print(f"[check mixer_b16_224] gaussian_noise/3 bf16, probe init, card (K10's two launches "
          f"on the packed weights, K7) vs the CPU's bf16 forward: rel max|dlogit|={err:.2e} "
          f"(max|logit| {top:.3e}); argmax equal on {int(same.sum())} of 2 images, all "
          f"{int(clear.sum())} with a clear top-2 gap | {card}")
    check(err <= 0.1 and bool(same[clear].all()),
          f"mixer_b16_224 bf16 chain disagrees with the CPU's bf16 forward ({err})")


def device_breakdown(fn) -> list[tuple[str, float]]:
    """Device time of each kernel (by name) in one call of ``fn``, from
    ``torch.profiler``: [(name, ms)] largest first, or [] where the trace
    holds no device time."""
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out: dict[str, float] = {}
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        name = re.sub(r"^void |\(anonymous namespace\)::|at::native::|\(.*$", "", e.key)
        out[name] = out.get(name, 0.0) + e.self_device_time_total / 1e3
    return sorted(out.items(), key=lambda kv: -kv[1])


def time_gaussian_path(card: str, runs: dict) -> None:
    """Phase 5, the Swin, ConvNeXt, Mixer and DenseNet paths: each forward
    alone in bf16 and f32; in bf16 each kernel's share of one forward's
    device time (``torch.profiler``); the solvers end to end."""
    from robustart_torch.models import create_classifier

    with torch.inference_mode():
        for model in GAUSSIAN_MODELS:
            for dtype, iters in ((torch.bfloat16, 10), (torch.float32, 3)):
                # built outside inference mode, as the solver builds it: a
                # DenseNet caches its packed blocks on its parameters' versions
                with torch.inference_mode(False):
                    clf = create_classifier(model, seed=0, device="cuda", dtype=dtype)
                xn = torch.randn((MAIN_BATCH, IMG, IMG, 3), device="cuda").to(dtype)
                fwd = cuda_ms(lambda: clf.forward_normalized(xn), iters, warmup=2)
                print(f"[time] {model} forward alone, {dtype}, B={MAIN_BATCH}: {fwd:.3f} ms, "
                      f"{MAIN_BATCH / fwd * 1e3:.1f} img/s | {card}")
                if dtype == torch.bfloat16 and model == "densenet121":
                    dev = device_ms(lambda: clf.forward_normalized(xn), iters=5)
                    verdict = ("host-bound: the host's launches outlast the kernels"
                               if dev is not None and fwd > 1.1 * dev else
                               "not host-bound" if dev is not None else "not measured")
                    print(f"[time] {model} bf16 forward, B={MAIN_BATCH}: {fwd:.3f} ms of CUDA-event "
                          f"time, {_ms(dev)} of device time (torch.profiler): {verdict} | "
                          f"{card}")
                if dtype == torch.bfloat16:
                    device_breakdown(lambda: clf.forward_normalized(xn))  # the tracer's start-up
                    parts = device_breakdown(lambda: clf.forward_normalized(xn))
                    total = sum(ms for _, ms in parts)
                    top = "; ".join(f"{n} {ms:.3f} ms ({ms / total:.0%})" for n, ms in parts[:6])
                    print(f"[time] {model} bf16 forward by kernel (torch.profiler): "
                          + (f"{total:.3f} ms of device time in {len(parts)} kernels, "
                             f"{total / fwd:.0%} of the {fwd:.3f} ms forward: {top} | {card}"
                             if parts else "no device time in the trace: not measured"))
                del clf, xn
    for model, run in runs.items():
        print(f"[time] solver end to end, {model}: {run['n_img']} corrupted images in "
              f"{run['wall']:.2f}s = {run['n_img'] / run['wall']:.1f} img/s | {card}")


def time_vit_path(card: str, vit_run: dict, deit_run: dict) -> None:
    """Phase 5, the transformer path: ViT-B forward alone, each corruption's
    pre-staged online step, the solvers end to end."""
    from robustart_torch.models import create_classifier
    from robustart_torch.solvers.multi_eval_solver import online_logits

    imgs = torch.randint(0, 256, (MAIN_BATCH, IMG, IMG, 3), dtype=torch.uint8,
                         device="cuda")
    with torch.inference_mode():
        for dtype, iters in ((torch.bfloat16, 10), (torch.float32, 3)):
            clf = create_classifier("vit_base", seed=0, device="cuda", dtype=dtype)
            xn = torch.randn((MAIN_BATCH, IMG, IMG, 3), device="cuda").to(dtype)
            fwd = cuda_ms(lambda: clf.forward_normalized(xn), iters, warmup=2)
            print(f"[time] ViT-B/16 forward alone, {dtype}, B={MAIN_BATCH}: {fwd:.3f} ms, "
                  f"{MAIN_BATCH / fwd * 1e3:.1f} img/s | {card}")
            del clf
        clf = vit_run["solver"].classifier
        for corruption in VIT_CORRUPTIONS:
            step = cuda_ms(lambda: online_logits(clf, corruption, 3, imgs, 77), 5, warmup=1)
            print(f"[time] ViT-B online step {corruption}/3 (corrupt + forward, bf16), "
                  f"pre-staged B={MAIN_BATCH}: {step:.3f} ms, "
                  f"{MAIN_BATCH / step * 1e3:.1f} img/s | {card}")
    for model, run in (("vit_base", vit_run), ("deit_tiny_b16_224", deit_run)):
        print(f"[time] solver end to end, {model}: {run['n_img']} corrupted images in "
              f"{run['wall']:.2f}s = {run['n_img'] / run['wall']:.1f} img/s | {card}")


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
        blk = phase_block_kernels(card)
        main_run = phase_main_path(card)
        vit_run = phase_main_path(card, "vit_base", VIT_CORRUPTIONS)
        deit_run = phase_main_path(card, "deit_tiny_b16_224", DEIT_CORRUPTIONS)
        gaussian_runs = {m: phase_main_path(card, m, ["gaussian_noise"]) for m in GAUSSIAN_MODELS}
        phase_reference_check(card)
        phase_vit_reference_check(card)
        phase_model_reference_check(card)
        phase_densenet_bf16_check(card)
        phase_mixer_bf16_check(card)
        rate = hbm_rate(torch.cuda.get_device_name(0))
        times = time_kernels(card, k1_res, new, rate)
        times.update(time_block_kernels(card, blk, rate))
        time_path(card, main_run)
        time_vit_path(card, vit_run, deit_run)
        time_gaussian_path(card, gaussian_runs)
    except Failed as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(RESULTS, ignore_errors=True)

    errs = {"fused_noise_normalize": k1_res["max_abs_err"], **new["max_abs_err"],
            **blk["max_abs_err"]}
    # each kernel's launches in its own paths' runs: K1-K5 on ResNet-50, the
    # model kernels summed over the transformer and ConvNeXt runs, and by model
    launches = dict(main_run["launches"])
    model_runs = {"vit_base": vit_run, "deit_tiny_b16_224": deit_run, **gaussian_runs}
    by_model = {name: {m: run["launches"][name] for m, run in model_runs.items()
                       if run["launches"][name]}
                for name in MODEL_KERNELS}
    for name, counts in by_model.items():
        launches[name] = sum(counts.values())

    def forms(name):
        """K6's and K7's other forms, each at its own shape with its own launches."""
        return [{"form": form, "launches": sum(model_runs[m]["launches"][name]
                                               for m in FORM_MODELS[form]),
                 "max_abs_err": errs[form], **times[form]}
                for form, kernel in FORM_KERNEL.items() if kernel == name]

    print(json.dumps({"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": errs[name],
            **times[name],
            **({"sources": SOURCES[name]} if name in SOURCES else {}),
            **({"launches_by_model": by_model[name]} if name in by_model else {}),
            **({"forms": forms(name)} if name in FORM_KERNEL.values() else {}),
            **({"library_note": NO_LIBRARY[name]} if name in NO_LIBRARY else {}),
            **({"calls": sum(run["dense_block_calls"] for run in model_runs.values())}
               if name == "dense_block" else {}),
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
