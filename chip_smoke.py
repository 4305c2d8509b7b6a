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
   the 3×3), of the token-mixing MLP's (the statistics pass and the
   fused wgmma kernel at each compiled token width) and of K11's bf16 and
   f32 kernels (none of these three sources' kernels may spill);
3. each kernel against its plain PyTorch version on the card: K1 (fused
   noise) at B=64 and B=128, 224², every noise mode × {normalized bf16,
   normalized f32, centered_u8 int8}, its noise statistics and streams; K2
   (warp), K3 (motion taps, C = 3 and C = 1), K4 (glass shuffle) and K5
   (chamfer) at the main path's shape (B=128, 224²) and at 3×56×40, K2
   also on elastic_transform's own coordinates (both warps, severities 1-5,
   at 128 × 224²), at C = 1 and on a far-overhang input, K3 also on every
   severity's taps of motion_blur and snow at 128 × 224² (all 32 bank
   angles), at 8 × 8 and on far offsets (its gathering route), bitwise, K5
   also at 1 round and at 57×41, 384² (a cluster of 8 blocks), 1000×64 (a
   cluster of 4) and 512² (past a cluster's shared memory: a launch a
   round), each call's launches held to ``chamfer_plan``'s; K6
   (window block) and K7 (MLP) at ViT-B's shape (128 images of 197 tokens,
   C = 768) and K8 (attention) at DeiT-Tiny's (128, 197, 3 heads of 64),
   each also at 3 images of 50 tokens, C = 192, in bf16 and f32; K9 (window
   attention) at Swin-T's stage-0 shape (8192 windows of 49 tokens, 3 heads
   of 32) with and without the shift mask, K6 in its Swin form (bias and
   mask, head width 32) at Swin-B's stage-0 shape (8192 × 49 × 128), K11
   (depthwise 7×7 + LN) at ConvNeXt-B's four stages (128×56×56×128,
   128×28×28×256, 128×14×14×512, 128×7×7×1024; the last with the channels
   split over a cluster) and at 3×13×11×96 and 3×9×15×1024 (H and W that
   divide neither its band nor its patch; three column tiles), each
   launch's plan printed, K7 in its ConvNeXt form (gamma and
   shortcut, 401,408 × 128, hidden 512), K10 (token-mixing MLP) at
   Mixer-B/16's shape (128 × 196 × 768, hidden 384, LN prologue and raw-x
   residual), Mixer-L/16's (128 × 196 × 1024, hidden 512) and Mixer-B/16's
   at 384 px (128 × 576 × 768: the route over the product), and at
   ragged shapes (3 images of 49 tokens at C 20, 50 at C 96 with hidden
   40, 256 at C 96, 324 at C 96 with hidden 40), and K12 (dense block) at
   DenseNet-121's four blocks (128 ×
   56² × 64 with 6 layers, 28² × 128 with 12, 14² × 256 with 24, 7² × 512
   with 16; bf16: three launches a layer), each also at 3 images, in bf16
   and f32; and, checked only,
   K8 at CLIP-L/14's 257 tokens (128 × 257 × 16 heads of 64) and at
   ViT-B/16's 577 tokens at 384 px (2 images), and K7 with CLIP's
   quick_gelu (3 × 257 × 1024);
4. the main paths at full width, each with every kernel's launches counted
   from zero and held against the count the code implies: ``MultiEvalSolver``
   online ImageNet-C on the fake backend with random weights from the seed,
   batch 128, 256 images, severities 1-5: resnet50_official in bf16 on all
   19 corruptions (an mCE over exactly the 15 standard ones, frost named
   not comparable; fog, frost, brightness, contrast, pixelate,
   jpeg_compression and saturate are plain torch and launch no
   kernel); vit_base (ViT-B/16)
   in bf16 on gaussian_noise, shot_noise, glass_blur and elastic_transform;
   deit_tiny_b16_224, swin_base, swin_tiny, convnext_base, mixer_b16_224
   and densenet121 in bf16 on gaussian_noise; then each corruption's chain
   on the card against the same chain on the CPU at a small input, the
   random draws injected (``fractal=`` for fog, ``idx=``, ``ys=``, ``xs=``
   for frost; jpeg_compression's image held bitwise), for ResNet-50, ViT-B
   and DeiT-Tiny, and the
   gaussian_noise chain of Swin-T, ConvNeXt-B, Mixer-B/16 and DenseNet-121
   with their bias tables, layer-scale and BatchNorms drawn at a scale that
   reaches the logits, DenseNet-121's in bf16 (its three launches a
   layer) against the CPU's fused forward on the same K1 batch, and
   Mixer-B/16's and ConvNeXt-B's in bf16 (K10's two launches on the packed
   weights; K11 and K7), and Mixer-B/16's at 384 px (K10 over the product)
   against the CPU's bf16 forward on the same K1 batch; then the int8 path
   (``model.quantize: int8``): ``conv_i8``'s int32 accumulators bitwise at
   every convolution shape of ResNet-50 and ResNeXt-50, the int8 forwards
   of ResNet-50 (also fed K1's ``centered_u8`` output), ViT-B/16 (K8) and
   Swin-T (K9) on the card against the same forwards on the CPU, and the
   solver with ``model.quantize: int8`` on resnet50_official
   (gaussian_noise and glass_blur), vit_base and swin_tiny (gaussian_noise,
   ``quantize_force``), launches counted as above and no launch of the
   float forward's bf16 product;
5. times, with the card's name and power limit beside each: each kernel
   (K2 on each input it is checked on; its kernels-line figures are
   elastic_transform's two warps at severity 3, a launch's share)
   against its plain version, its bound and the one PyTorch call that
   computes the same function where there is one (CUDA events over many
   calls, and in bf16 and for K5 the device time of one call from
   torch.profiler, which leaves out the host's gaps between launches);
   beside K6's and
   K7's, each of their products against ``torch.matmul`` on the bare bf16
   product of the same shapes, beside K10's, its launches one by one (the
   statistics pass and the fused kernel; at 576 tokens the LN pass, fc1
   and fc2) and ``torch.matmul``'s two batched products of the same shapes
   without LN or activation,
   beside K12's, cuDNN's bare bf16 1×1 and 3×3 convolutions of each
   block's widest layer, and beside K11's at stages 0 and 2, cuDNN's
   depthwise convolution and ``F.layer_norm`` on channels_last bf16 (the
   yardsticks are never used by the port);
   ResNet-50, ViT-B, Swin-B, Swin-T, ConvNeXt-B, Mixer-B/16 and
   DenseNet-121 forwards alone
   (bf16, f32), the last five broken down by kernel, DenseNet-121's also
   in device time (``torch.profiler``) beside its CUDA-event time, K11's
   device time summed over one ConvNeXt-B forward; each
   corruption's online step on a pre-staged batch and the corruption alone
   (the seven plain-torch ones also by ``torch.profiler``'s device time of
   one call); the solvers' own img/s;
   K1 also in its ``centered_u8`` mode; the int8 ResNet-50, ViT-B and
   Swin-T forwards beside their bf16 ones, the int8 ResNet-50's device
   time by part (im2col and other copies, ``torch._int_mm``, the f32
   epilogues), the int8 solvers' img/s;
6. one JSON line describing every kernel of the paths, the card's line, and
   the last line: ``{"ok": true, "device": {...}}``.

Exits non-zero without a result where ``torch.cuda.is_available()`` is
false, and where the ``robustart_torch`` package is not beside this file.
"""

from __future__ import annotations

import contextlib
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
# K1's issue slots an element in gaussian_noise's mode (bf16 out, vector
# path): its SASS's main path over the 4 elements of a thread, slow paths
# out of line or skipped (scripts/count_k1_sass.py; 566 instructions: Philox
# rounds, logf, cosf, sqrtf, __fdiv_rn, the requantize and the bf16 store),
# each at least one of the card's 33.5 T lane-instruction slots a second
K1_ISSUE_PER_ELEMENT = 141.5
# and in the int8 path's mode (centered_u8: int8 out), counted the same way
# (scripts/count_k1_sass.py --out int8: 460 instructions, no normalize and
# a one-byte store)
K1_ISSUE_PER_ELEMENT_I8 = 115.0
# K5's f32 instructions a pixel and round: the plain version's 16 adds, 16
# mins and the cap's min; and the least known, 3 adds (rounding x + w is
# monotone in x, so a weight class adds once to its least neighbour) and 12
# mins (the pair minima of rows i±1 and i±2 shared along a row)
K5_PLAIN_OPS = 33
K5_LEAST_OPS = 15
# K5's checks beyond the path's shape, at 1 and 12 rounds: odd H and W, 384²
# (a cluster of 8), 512² (past a cluster's shared memory: the round route)
# and 1000×64 (a cluster of 4, bands of 250 rows)
CHAMFER_SHAPES = [(2, 57, 41), (2, 384, 384), (2, 512, 512), (1, 1000, 64)]
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
    "motion_taps": "no single torch call: replicate padding, then a depthwise conv2d of "
                   "groups B*C with a dense 29x21 kernel at severity 5 (29x the taps)",
    "token_mlp": "no single torch call: LN over C, then an MLP over the token axis",
    "dense_block": "no single torch call: a chain of folded BN, 1x1, BN, 3x3 per layer",
    "dwconv_ln": "no single torch call: a depthwise 7x7 convolution, then LN over C",
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
# the int8 runs (model.quantize: int8; ViT and Swin under quantize_force):
# ResNet-50 on gaussian_noise (K1's centered_u8 straight into the int8 stem)
# and glass_blur (K4, then the uint8 grid); ViT-B and Swin-T on
# gaussian_noise. Each calibrates on its first corruption's first
# INT8_CALIB_BATCHES batches at the highest severity.
INT8_RUNS = {"resnet50_official": ["gaussian_noise", "glass_blur"],
             "vit_base": ["gaussian_noise"], "swin_tiny": ["gaussian_noise"]}
INT8_CALIB_BATCHES = 2
# each int8 model's kernel launches per forward: K8 in every ViT-B block,
# K9 in every Swin-T block (the int8 path has no K6 or K7: its products are
# int8 GEMMs, its LN, GELU and residuals torch's)
INT8_PER_FORWARD = {"resnet50_official": {}, "vit_base": {"mha": 12},
                    "swin_tiny": {"window_mha": 12}}
# the int8 transformers' logits, card against CPU: relative max|Δ| bound.
# Every bf16 step rounds at the same place on both, but K8's and K9's bf16
# outputs differ from their plain versions' by an ulp here and there, and
# each requantize after a bf16 tensor turns such an ulp into a level; the
# flips grow through 12 blocks (to 40% of values, within 4 levels, at
# ViT-B's last sites). On ViT-B the gap (3.3e-2 to 4.1e-2 over three
# weight and calibration draws: this check's and scripts/probe_torch_int8.py's)
# is of the size of the int8 path's own error against the float32 forward on
# the same input (4.0-4.3e-2), so ViT-B is held to 5e-2; Swin-T (0.8e-2 to
# 1.2e-2) to 2e-2
INT8_REL_BOUND = {"vit_base": 5e-2, "swin_tiny": 2e-2}
INT8_PATH_KERNELS = {"resnet50_official": {"fused_noise_normalize", "glass_shuffle"},
                     "vit_base": {"fused_noise_normalize", "mha"},
                     "swin_tiny": {"fused_noise_normalize", "window_mha"}}
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


def device_profile(fn, iters: int = 10) -> tuple[float | None, float]:
    """Device time of one ``fn()`` (every kernel and memset it launches) and
    the number of those device operations a call, from ``torch.profiler``
    over ``iters`` calls after one warm-up: the time the card is busy,
    without the host's gaps between launches that :func:`cuda_ms` counts
    where a call's host work outlasts its kernels. The time is None where
    the trace holds no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    ops = [e for e in prof.key_averages()
           if getattr(e, "device_type", None) == DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in ops)
    return (total / 1e3 / iters if total else None), sum(e.count for e in ops) / iters


def device_ms(fn, iters: int = 10) -> float | None:
    """The device time of :func:`device_profile`."""
    return device_profile(fn, iters)[0]


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
    linear_fused.cu, dense_block.cu, token_mlp.cu, dwconv_ln.cu) and the
    shared memory their launches take; fail where token_mlp.cu's bf16
    kernels or K11's spill."""
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
    # K11's kernel (<1> bf16, <0> f32): its 98 weights and the 2 × 7 patch's
    # 28 accumulators a thread sit in registers and must not spill; the
    # shared memory of a launch is its plan's, printed beside each CASES row
    usage = ptxas_usage(build.build_log("dwconv_ln"))
    print(f"[build] dwconv_ln.cu, nvcc -Xptxas -v: {'; '.join(usage)}")
    check(len(usage) == 2, f"dwconv_ln.cu: expected two kernels in the ptxas log, got {usage}")
    spilled = [u for u in usage if "spilled" in u]
    check(not spilled, f"dwconv_ln.cu's kernels spill: {spilled}")


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
    shape and at an odd size; K5 also at :data:`CHAMFER_SHAPES` and 1 round,
    each call's launches held to its plan's (``chamfer_plan``); K2 also on
    :func:`warp_inputs`, K3 also on :func:`motion_inputs`. All four are
    bitwise (K2 and K3 round every step as their plain versions do, with no
    FMA)."""
    from robustart_torch.ops import motion, warp

    gen = torch.Generator(device="cuda").manual_seed(1)
    errs = {}
    main = None
    for b, h, w in ((MAIN_BATCH, IMG, IMG), ODD):
        inp = kernel_inputs(b, h, w, gen)
        pairs = [
            ("warp_bilinear", warp.warp_bilinear, warp.warp_bilinear_reference,
             (inp["img"], inp["cy"], inp["cx"]), 0.0),
            ("motion_taps", motion.motion_taps, motion.motion_taps_reference,
             (inp["img"], *inp["taps"][3]), 0.0),
            ("motion_taps C=1", motion.motion_taps, motion.motion_taps_reference,
             (inp["img1"], *inp["taps"][1]), 0.0),
            ("glass_shuffle", motion.glass_shuffle, motion.glass_shuffle_reference,
             (inp["img"], inp["code"], 4), 0.0),
            ("chamfer", motion.chamfer, motion.chamfer_reference,
             (inp["dist0"], 20.0, 12), 0.0),
        ]
        for name, kernel, plain, args, atol in pairs:
            before = motion.chamfer.launches
            got = kernel(*args)
            ref = plain(*args)
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            bitwise = torch.equal(got, ref)
            label = ", i.i.d. ±30 px coordinates" if name == "warp_bilinear" else ""
            print(f"[{name} B={b} {h}x{w}{label}] max_abs_err={err:.3e} bitwise={bitwise}")
            check(err <= atol and (atol > 0 or bitwise),
                  f"{name} at {b}x{h}x{w} disagrees with its plain version ({err})")
            if name == "chamfer":
                chamfer_launches(motion, (b, h, w), 12, motion.chamfer.launches - before)
            if (b, h, w) == (MAIN_BATCH, IMG, IMG):
                errs[name] = err
        if main is None:
            main = inp
    for shape in CHAMFER_SHAPES + [(MAIN_BATCH, IMG, IMG), ODD]:
        dist0 = torch.where(torch.rand(shape, device="cuda", generator=gen) < 0.005, 0.0, 20.0)
        for iters in (1, 12):
            if shape in ((MAIN_BATCH, IMG, IMG), ODD) and iters == 12:
                continue  # checked above
            before = motion.chamfer.launches
            got = motion.chamfer(dist0, 20.0, iters)
            ref = motion.chamfer_reference(dist0, 20.0, iters)
            torch.cuda.synchronize()
            check(torch.equal(got, ref), f"chamfer at {shape}, {iters} rounds, disagrees with "
                  f"its plain version ({float((got - ref).abs().max())})")
            chamfer_launches(motion, shape, iters, motion.chamfer.launches - before)
    return {"max_abs_err": errs, "inputs": main, "warp": warp_inputs(gen, main),
            "motion": motion_inputs(gen)}


def motion_inputs(gen) -> dict:
    """Phase 3, K3 on the taps the main path gives it: every severity of
    motion_blur (C = 3) and snow (C = 1) at 128 × 224², image n at bank
    angle n mod 32 (all 32, four times), through ``motion_blur_bank`` as
    the corruptions call it; then each corruption's severity-5 taps at
    3 × 56 × 40 and 8 × 8, and far offsets (up to ±60 px, 21 taps) whose
    boxes exceed the budget, so that the kernel's gathering route runs.
    Each bitwise against the plain version, one launch a call. Returns the
    path's inputs by name: (image, dy, dx, wt, reach)."""
    from robustart_torch.noise.corruptions import (
        MOTION_BANK,
        MOTION_SEVERITY,
        SNOW_BANK,
        SNOW_SEVERITY,
    )
    from robustart_torch.ops import motion

    taps = ([(f"motion_blur severity {s + 1}", 3, float(r), float(g), MOTION_BANK)
             for s, (r, g) in enumerate(MOTION_SEVERITY)]
            + [(f"snow severity {s + 1}", 1, float(c[4]), float(c[5]), SNOW_BANK)
               for s, c in enumerate(SNOW_SEVERITY)])
    inputs, checks = {}, []
    for name, c, radius, sigma, bank in taps:
        idx = torch.arange(MAIN_BATCH, device="cuda") % len(bank)
        img = torch.rand((MAIN_BATCH, IMG, IMG, c), device="cuda", generator=gen)
        rows = motion.tap_rows(idx, radius, sigma, bank)
        reach = motion.tap_spans(radius, sigma, bank)
        inputs[name] = (img, *rows, reach)
        checks.append((f"{name}, T={rows[0].shape[1]}", img, rows, reach,
                       lambda img=img, idx=idx, k=(radius, sigma, bank):
                       motion.motion_blur_bank(img, idx, *k)))
        if "severity 5" in name:
            for b, h, w in (ODD, (32, 8, 8)):
                small = torch.rand((b, h, w, c), device="cuda", generator=gen)
                sidx = torch.arange(b, device="cuda") % len(bank)
                checks.append((f"{name} at {b}x{h}x{w}", small,
                               motion.tap_rows(sidx, radius, sigma, bank), reach,
                               lambda small=small, sidx=sidx, k=(radius, sigma, bank):
                               motion.motion_blur_bank(small, sidx, *k)))
            far = torch.randint(-60, 61, (2, 8, 21), device="cuda", generator=gen)
            far = far.to(torch.int32)
            far_rows = (far[0].contiguous(), far[1].contiguous(),
                        torch.rand((8, 21), device="cuda", generator=gen))
            far_img = torch.rand((8, 100, 90, c), device="cuda", generator=gen)
            checks.append((f"far offsets (±60 px, the gathering route), C={c}", far_img,
                           far_rows, None, lambda far_img=far_img, far_rows=far_rows:
                           motion.motion_taps(far_img, *far_rows)))
    for name, img, rows, reach, run in checks:
        before = motion.motion_taps.launches
        got = run()
        launched = motion.motion_taps.launches - before
        torch.cuda.synchronize()
        bitwise = torch.equal(got, motion.motion_taps_reference(img, *rows))
        b, h, w, c = img.shape
        plan = motion.motion_plan(b, h, w, c, reach)
        print(f"[motion_taps {b}x{h}x{w} C={c}, {name}] bitwise={bitwise}, {launched} launch, "
              f"box budget {plan['box_bytes']} B")
        check(bitwise, f"motion_taps on {name} disagrees with its plain version")
        check(launched == 1, f"motion_taps on {name}: {launched} launches, not 1")
    return inputs


def warp_inputs(gen, main: dict) -> dict:
    """Phase 3, K2 on the coordinates the main path gives it: both warps of
    elastic_transform at 128 × 224², severities 1-5, from a fixed seed
    (the second warp's image is the first's output), then C = 1 on the
    severity-3 field warp and a far-overhang input (i.i.d. over three
    periods each side: reflections of reflections), each bitwise against
    the plain version, one launch a call. Returns the inputs by name."""
    from robustart_torch.noise.corruptions import elastic_coords
    from robustart_torch.ops import warp

    x = torch.rand((MAIN_BATCH, IMG, IMG, 3), device="cuda", generator=gen)
    inputs = {}
    for s in SEVERITIES:
        first, second = elastic_coords(x, s, generator=gen)
        x_aff = warp.warp_bilinear_reference(x, *first)
        inputs[f"elastic severity {s} warp 1"] = (x, *first)
        inputs[f"elastic severity {s} warp 2"] = (x_aff, *second)
    img, cy, cx = inputs["elastic severity 3 warp 2"]
    inputs["elastic severity 3 warp 2, C=1"] = (img[..., :1].contiguous(), cy, cx)
    far = [torch.rand(cy.shape, device="cuda", generator=gen) * 12 * n - 6 * n
           for n in (IMG, IMG)]
    inputs["far overhang"] = (main["img"], *far)
    for name, (img, cy, cx) in inputs.items():
        before = warp.warp_bilinear.launches
        got = warp.warp_bilinear(img, cy, cx)
        launched = warp.warp_bilinear.launches - before
        torch.cuda.synchronize()
        bitwise = torch.equal(got, warp.warp_bilinear_reference(img, cy, cx))
        print(f"[warp_bilinear B={img.shape[0]} {IMG}x{IMG}, {name}] bitwise={bitwise}, "
              f"{launched} launch")
        check(bitwise, f"warp_bilinear on {name} disagrees with its plain version")
        check(launched == 1, f"warp_bilinear on {name}: {launched} launches, not 1")
    return inputs


def chamfer_launches(motion, shape: tuple, iters: int, launched: int) -> None:
    """Print K5's plan at a shape and hold one call's launches to it."""
    plan = motion.chamfer_plan(*shape, iters)
    print(f"[chamfer {'x'.join(map(str, shape))}, {iters} rounds] bitwise, {launched} launches, "
          f"plan {plan}")
    check(launched == plan["launches"], f"chamfer at {shape}: {launched} launches, its plan "
          f"says {plan['launches']}")


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
    ("dwconv_ln", "ConvNeXt-B stage 1", True, convnext_inputs, (MAIN_BATCH, 28, 28, 256)),
    ("dwconv_ln", "ConvNeXt-B stage 2", True, convnext_inputs, (MAIN_BATCH, 14, 14, 512)),
    ("dwconv_ln", "ConvNeXt-B stage 3", True, convnext_inputs, (MAIN_BATCH, 7, 7, 1024)),
    ("dwconv_ln", "3x13x11x96", False, convnext_inputs, (3, 13, 11, 96)),
    ("dwconv_ln", "3x9x15x1024", False, convnext_inputs, (3, 9, 15, 1024)),
    ("mlp_convnext", "ConvNeXt-B stage 0", True, convnext_inputs, (MAIN_BATCH, 56, 56, 128)),
    ("mlp_convnext", "3x13x11x96", False, convnext_inputs, (3, 13, 11, 96)),
    ("token_mlp", "Mixer-B/16", True, mixer_inputs, (MAIN_BATCH, 196, 768, 384)),
    ("token_mlp", "3 images", False, mixer_inputs, (3, 196, 768, 384)),
    ("token_mlp", "Mixer-L/16", True, mixer_inputs, (MAIN_BATCH, 196, 1024, 512)),
    ("token_mlp", "3x49x20 hidden 40", False, mixer_inputs, (3, 49, 20, 40)),
    ("token_mlp", "3x50x96 hidden 40", False, mixer_inputs, (3, 50, 96, 40)),
    ("token_mlp", "3x256x96 hidden 384", False, mixer_inputs, (3, 256, 96, 384)),
    ("token_mlp", "Mixer-B/16 at 384 px", True, mixer_inputs, (MAIN_BATCH, 576, 768, 384)),
    ("token_mlp", "3x324x96 hidden 40", False, mixer_inputs, (3, 324, 96, 40)),
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
            plan = ""
            if form == "dwconv_ln":
                from robustart_torch.ops.convnext import dwconv_plan

                p = dwconv_plan(*inp["x"].shape, dtype)
                plan = (f" plan: cluster {p['cluster']}, {p['threads']} threads, "
                        f"{p['groups']} column groups, {p['tiles']} tiles, band {p['band']}, "
                        f"ring {p['ring']}, {p['smem']} bytes of shared memory, grid {p['grid']}")
            print(f"[{name}] shape {tuple(got.shape)}: max_abs_err={err:.3e} "
                  f"max|ref|={float(ref.float().abs().max()):.3e}{plan}")
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


def form_bound(form: str, inp: dict, tag: str, rate: float) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the least time of one call of a form,
    the larger of its bytes over the memory rate and its products at the
    type's peak (K11's f32 FMAs at the f32 rate) plus its other f32
    instructions."""
    flops, other, nbytes = work(form, inp)
    peak = BF16_FLOPS_PER_S if tag == "bf16" and form != "dwconv_ln" else FP32_FLOPS_PER_S
    b_ms, o_ms = nbytes / rate * 1e3, (flops / peak + other / FP32_OPS_PER_S) * 1e3
    return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")


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


def dwconv_yardstick(inp: dict, card: str) -> float:
    """cuDNN's depthwise 7×7 ``F.conv2d(groups=C)`` with its bias on
    channels_last bf16, then ``F.layer_norm`` over C in bf16, on K11's
    inputs: two library calls, never used by the port and no library call
    of K11 (which has none). Returns their ms."""
    import torch.nn.functional as F

    x = inp["x"].to(torch.bfloat16)
    c = x.shape[-1]
    xc = x.permute(0, 3, 1, 2)  # NCHW view of NHWC memory: channels_last
    w = inp["w"].to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    b, gamma, beta = (inp[k].to(torch.bfloat16) for k in ("b", "gamma", "beta"))

    def yard():
        y = F.conv2d(xc, w, b, padding=3, groups=c).permute(0, 2, 3, 1)
        return F.layer_norm(y, (c,), gamma, beta, 1e-6)

    ms = cuda_ms(yard, 20, warmup=3)
    print(f"[time] dwconv_ln yardstick {tuple(x.shape)}: cuDNN depthwise F.conv2d(groups=C) + "
          f"F.layer_norm, bf16 channels_last, {ms:.4f} ms (two library calls, never used by the "
          f"port, not a library call of K11) | {card}")
    return ms


def token_parts(inp: dict, card: str, rate: float) -> dict:
    """K10's bf16 call one launch at a time on the same inputs, each by CUDA
    events and by torch.profiler's device time: on the fused route (T ≤
    256) the statistics pass (its bound: x read once, the statistics
    written once) and the fused kernel (the function's bound); on the route
    over the product the LN pass (x read and written once), fc1 and fc2
    (each its products at the bf16 peak), on their padded, transposed
    inputs. And ``torch.matmul``'s two batched bf16 products of the same
    shapes (x̂ᵀ·W1ᵀ, then W2·aᵀ), no LN or activation, a yardstick never
    used by the port. Returns the numbers."""
    from robustart_torch.ops import linear, mlp

    x, (ln_w, ln_b) = inp["x"], inp["ln"]
    b, t, c = x.shape
    h = inp["w1"].shape[0]
    packed = mlp.pack_token_weights(inp["w1"], inp["w2"])
    plan = mlp.token_plan(b, t, c, h)
    ln = (ln_w.float().contiguous(), ln_b.float().contiguous())
    b1, b2 = inp["b1"].float().contiguous(), inp["b2"].float().contiguous()
    if plan["route"] == "product":
        tp, hp, rows = plan["tp"], plan["hp"], plan["rows"]
        pad = torch.nn.functional.pad
        x_tok = pad(x.transpose(1, 2), (0, tp - t)).reshape(rows, tp).contiguous()
        hidden = torch.randn((rows, hp), device="cuda").to(x.dtype)
        b1p, b2p = pad(b1, (0, hp - h)), pad(b2, (0, tp - t))
        x2 = x.reshape(b * t, c)
        parts = {"LN pass": (lambda: linear.layer_norm(x2, *ln, 1e-6),
                             2 * x.numel() * x.element_size() / rate * 1e3),
                 "fc1": (lambda: linear.linear_fused(x_tok, packed[0], b1p, act="gelu"),
                         2 * rows * tp * hp / BF16_FLOPS_PER_S * 1e3),
                 "fc2": (lambda: linear.linear_fused(hidden, packed[1], b2p, residual=x_tok),
                         2 * rows * tp * hp / BF16_FLOPS_PER_S * 1e3)}
    else:
        stats = mlp.token_stats(x, 1e-6)
        parts = {"stats": (lambda: mlp.token_stats(x, 1e-6),
                           (x.numel() * x.element_size() + b * t * 8) / rate * 1e3),
                 "fused": (lambda: mlp.token_fused(x, packed, b1, b2, plan, h, x, ln, stats),
                           work("token_mlp", inp)[0] / BF16_FLOPS_PER_S * 1e3)}
    out = {"plan_route": plan["route"]}
    for name, (fn, bnd) in parts.items():
        ms = cuda_ms(fn, 20, warmup=3)
        dev = device_ms(fn)
        key = name.replace(" ", "_")
        out[f"{key}_ms"], out[f"{key}_device_ms"], out[f"{key}_bound_ms"] = ms, dev, bnd
        print(f"[time] token_mlp {tuple(x.shape)} hidden {h} ({plan['route']} route), {name} "
              f"launch alone: {ms:.4f} ms (device {_ms(dev)}), bound {bnd:.4f} ms | {card}")
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
        bnd, by = form_bound(form, inp, tag, rate)
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
            if form == "dwconv_ln" and inp["x"].shape[1] in (56, 14):  # stages 0 and 2
                row["yardstick_ms"] = dwconv_yardstick(inp, card)
            if form == "dense_block":
                row["ms_per_launch"] = ms / (3 * inp["kw"]["n_layers"])
                row["design_floor_ms"] = dense_design_bytes(inp) / rate * 1e3
                row["cudnn_products"] = cudnn_dense_yardstick(inp, card)
            if form not in res:
                res[form] = row
            else:
                res[form].setdefault("shapes", []).append(row)
    return res


def corruption_launches(corruption: str, severity: int) -> dict:
    """Each corruption kernel's launches on one batch at one severity, from
    the code: K1 one for the noise family, K2 two (elastic's two warps), K3
    one, K4 one per glass pass, K5 its plan's (``chamfer_plan``: one a call
    at 224²) at spatter's water severities; none for the blurs made of
    banded products and for the rest, which are plain torch."""
    from robustart_torch.noise.corruptions import GLASS_SEVERITY, SPATTER_SEVERITY
    from robustart_torch.ops.motion import chamfer_plan
    from robustart_torch.solvers.multi_eval_solver import FUSED_NOISE

    water = corruption == "spatter" and SPATTER_SEVERITY[severity - 1][5] == 0
    return {"fused_noise_normalize": int(corruption in FUSED_NOISE),
            "warp_bilinear": 2 * (corruption == "elastic_transform"),
            "motion_taps": int(corruption in ("motion_blur", "snow")),
            "glass_shuffle": GLASS_SEVERITY[severity - 1][2] * (corruption == "glass_blur"),
            "chamfer": chamfer_plan(MAIN_BATCH, IMG, IMG, 12)["launches"] * water}


def main_corruptions() -> list:
    """The ResNet-50 run's corruptions: all of the port's registry, in its
    order (``noise/corruptions.py::CORRUPTION_ORDER``)."""
    from robustart_torch.noise.corruptions import CORRUPTION_ORDER

    return list(CORRUPTION_ORDER)


def plain_corruptions() -> list:
    """The corruptions that launch no kernel at any severity
    (:func:`corruption_launches`): plain torch, as in the JAX package."""
    return [c for c in main_corruptions()
            if not any(any(corruption_launches(c, s).values()) for s in SEVERITIES)]


def expected_launches(n_batches: int, corruptions: list, model: str,
                      int8: bool = False) -> dict:
    """Each kernel's launches in one solver run, from the code: the
    corruptions' (:func:`corruption_launches`) on every batch and severity,
    in an int8 run also on the calibration batches (the first corruption
    at the highest severity); per forward, the model's kernels as
    PER_FORWARD (INT8_PER_FORWARD) states them (the split of the JAX rule,
    not read from the model under test)."""
    cells = [(c, s) for c in corruptions for s in SEVERITIES] * n_batches
    calib = [(corruptions[0], max(SEVERITIES))] * min(INT8_CALIB_BATCHES, n_batches) * int8
    want = dict.fromkeys(KERNELS, 0)
    for c, s in cells + calib:
        for name, n in corruption_launches(c, s).items():
            want[name] += n
    per_forward = (INT8_PER_FORWARD if int8 else PER_FORWARD).get(model, {})
    for name in MODEL_KERNELS:
        want[name] = len(cells) * per_forward.get(name, 0)
    return want


def wrappers() -> dict:
    from robustart_torch.ops import attention, convnext, densenet, mlp, motion, noise, warp

    return {"fused_noise_normalize": noise.fused_noise_normalize,
            "warp_bilinear": warp.warp_bilinear, "motion_taps": motion.motion_taps,
            "glass_shuffle": motion.glass_shuffle, "chamfer": motion.chamfer,
            "window_block": attention.window_block, "mlp": mlp.mlp, "mha": attention.mha,
            "window_mha": attention.window_mha, "dwconv_ln": convnext.dwconv_ln,
            "token_mlp": mlp.token_mlp, "dense_block": densenet.dense_block}


def main_config(batch_size: int, model: str = "resnet50_official",
                corruptions: list | None = None, limit: int = MAIN_LIMIT,
                int8: bool = False):
    from robustart_torch.core.config import Config

    corruptions = corruptions or main_corruptions()
    quantize = {"quantize": "int8", "quantize_force": True,
                "quantize_calib_batches": INT8_CALIB_BATCHES} if int8 else {}
    return Config({
        "model": {"type": model, "dtype": "bf16", **quantize},
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
                    corruptions: list | None = None, int8: bool = False) -> dict:
    """Phase 4: the ImageNet-C solver, online, at full width, every count
    set to 0 just before the run and read just after. ``int8``: with
    ``model.quantize: int8``, which must launch no product of
    ``linear_fused.cu`` (``gemm_bf16_kernel``: the float forward's)."""
    from robustart_torch.models.quantize import Int8Model
    from robustart_torch.ops import linear
    from robustart_torch.solvers import MultiEvalSolver

    corruptions = corruptions or main_corruptions()
    tag = f"{model}@int8" if int8 else model
    shutil.rmtree(RESULTS, ignore_errors=True)
    solver = MultiEvalSolver(main_config(MAIN_BATCH, model, corruptions,
                                         int8=int8))  # cuda by default
    solver.build_model(seed=0)
    dense_block = wrappers()["dense_block"]
    for fn in wrappers().values():
        fn.launches = 0
    dense_block.calls = 0
    linear.linear_fused.launches = 0
    t0 = time.time()
    summary = solver.evaluate()
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {name: fn.launches for name, fn in wrappers().items()}
    n_batches = -(-MAIN_LIMIT // MAIN_BATCH)
    want = expected_launches(n_batches, corruptions, model, int8)
    calls = dense_block.calls
    want_calls = n_batches * len(SEVERITIES) * len(corruptions) * DENSE_CALLS_PER_FORWARD.get(
        model, 0) * (not int8)
    print(f"[main {tag}] dense_block calls in the solver run: {calls} (expected {want_calls})")
    check(calls == want_calls, f"dense_block: {calls} calls on the {tag} path, "
          f"expected {want_calls}")
    for name, n in launches.items():
        print(f"[main {tag}] {name} launches in the solver run: {n} "
              f"(expected {want[name]})")
        check(n == want[name], f"{name}: {n} launches on the {tag} path, "
              f"expected {want[name]}")
        check(n > 0 or name not in (INT8_PATH_KERNELS if int8 else PATH_KERNELS)[model],
              f"{name} was not launched on the {tag} path")
    if int8:
        gemm = linear.linear_fused.launches
        print(f"[main {tag}] int8 classifier {type(solver.quantized).__name__}; "
              f"linear_fused.cu products (gemm_bf16_kernel) launched: {gemm} (expected 0)")
        check(isinstance(solver.quantized, Int8Model), f"{tag}: no int8 classifier was built")
        check(gemm == 0, f"{tag}: the float forward's bf16 product ran {gemm} times")
    for corruption in corruptions:
        for s in SEVERITIES:
            path = RESULTS / corruption / str(s) / "results.txt.all"
            lines = path.read_text().splitlines()
            check(len(lines) == MAIN_LIMIT, f"{path}: {len(lines)} lines")
            scores = np.array([json.loads(line)["score"] for line in lines])
            check(scores.shape == (MAIN_LIMIT, 1000) and np.isfinite(scores).all(),
                  f"{path}: logits not finite or of the wrong shape")
            metric = json.loads((RESULTS / corruption / str(s) / "metric").read_text())
            print(f"[main {tag}] {corruption}/{s}: top1={metric['top1']:.2f} "
                  f"top5={metric['top5']:.2f} ({len(lines)} lines)")
    from robustart_torch.metrics import mean_corruption_error
    from robustart_torch.solvers.multi_eval_solver import STANDARD_CORRUPTIONS

    mce = summary["mCE"]
    top1 = summary["top1_per_corruption"]
    standard = [c for c in STANDARD_CORRUPTIONS if c in corruptions]
    check(list(top1) == corruptions, f"{tag}: top-1s of {list(top1)}, ran {corruptions}")
    check(mce is not None and np.isfinite(mce)
          and mce == mean_corruption_error({c: top1[c] for c in standard}),
          f"{tag}: mCE {mce} is not the mCE over {standard}")
    check(summary["non_comparable"] == (
        {"frost": "procedural-texture substitute for missing assets"}
        if "frost" in corruptions else {}),
        f"{tag}: non_comparable {summary['non_comparable']}")
    print(f"[main {tag}] mCE={mce:.4f} over {len(standard)} standard corruptions; "
          f"non_comparable={summary['non_comparable']}; top1_per_corruption={top1}")
    n_img = MAIN_LIMIT * len(SEVERITIES) * len(corruptions)
    return {"launches": launches, "dense_block_calls": calls, "wall": wall, "n_img": n_img,
            "solver": solver}


def injected_draws(name: str, severity: int, b: int, h: int, w: int) -> dict:
    """A random draw for ``name``, made on the CPU from a seed, in the form
    the corruptions take injected."""
    from robustart_torch.noise import corruptions as pc

    g = torch.Generator().manual_seed(severity)
    if name == "shot_noise":
        return {"uniform": torch.rand((b, h, w, 3), generator=g)}
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
    if name == "fog":
        decay = pc.FOG_SEVERITY[severity - 1][1]
        return {"fractal": pc.plasma_draws(b, pc.fog_mapsize(h, w), decay, g)}
    if name == "frost":
        return dict(zip(("idx", "ys", "xs"), pc.frost_draws(b, h, w, g)))
    return {}


def to_cuda(draw):
    """A draw of :func:`injected_draws` (tensors, or fog's list of tuples)
    on the card."""
    if isinstance(draw, (list, tuple)):
        return type(draw)(to_cuda(d) for d in draw)
    return draw.cuda()


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
        x01 = pc.to_unit(imgs)
        for name in dict.fromkeys(NEW_CORRUPTIONS + plain_corruptions()):
            for severity in (3, 5):
                draws = injected_draws(name, severity, *imgs.shape[:3])
                fn = pc.CORRUPTIONS[name]
                ca = fn(x01.cuda(), severity, **{k: to_cuda(v) for k, v in draws.items()})
                cb = fn(x01, severity, **draws)
                if name == "jpeg_compression":  # int32 throughout: bitwise
                    check(torch.equal(ca.cpu(), cb),
                          f"{name}/{severity}: the card's image differs from the CPU's")
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


def int8_conv_shapes(model) -> set:
    """(H, Cin, k, stride, padding, groups, Cout) of every convolution of a
    port ResNet at 224² (square inputs): the stem on its border-padded
    230² input (VALID), then each block's, the downsamples included."""
    from robustart_torch.models.quantize import _resnet_spec

    blocks, _ = _resnet_spec(model)
    shapes = {(IMG + 6, 3, 7, 2, 0, 1, 64)}

    def add(h, c):
        conv = model.get_submodule(c.name)
        shapes.add((h, conv.in_channels, c.k, c.stride, c.pad, c.groups, conv.out_channels))

    h = IMG // 4
    for blk in blocks:
        if blk.downsample is not None:
            add(h, blk.downsample)
        for c in blk.convs:
            add(h, c)
            h = (h + 2 * c.pad - c.k) // c.stride + 1
    return shapes


@contextlib.contextmanager
def recorded_requantize(module, seen: list):
    """Append every output of ``module.requantize`` (an int8 model
    module's requantize sites, in the forward's order) to ``seen``."""
    inner = module.requantize

    def requantize(*args):
        seen.append(inner(*args))
        return seen[-1]

    module.requantize = requantize
    try:
        yield seen
    finally:
        module.requantize = inner


def int8_agree(tag: str, got: torch.Tensor, ref: torch.Tensor, rel_max: float,
               cos_min: float | None, card: str) -> float:
    """Logits of an int8 forward on the card against the CPU's: relative
    max|Δ| ≤ ``rel_max`` and, with ``cos_min``, cosine ≥ it per image;
    else the same argmax. Returns the relative max|Δ|."""
    got = got.cpu()
    rel = float((got - ref).abs().max()) / float(ref.abs().max())
    cos = float(((got * ref).sum(-1) / (got.norm(dim=-1) * ref.norm(dim=-1))).min())
    same = bool(torch.equal(got.argmax(-1), ref.argmax(-1)))
    print(f"[int8 check] {tag}, card vs CPU: rel max|dlogit|={rel:.3e} (max|logit| "
          f"{float(ref.abs().max()):.3e}), min cosine {cos:.6f}, argmax equal {same} | {card}")
    check(rel <= rel_max, f"{tag}: rel max|dlogit| {rel} > {rel_max}")
    if cos_min is None:
        check(same, f"{tag}: argmax differs between the card and the CPU")
    else:
        check(cos >= cos_min, f"{tag}: cosine {cos} < {cos_min}")
    return rel


def phase_int8_checks(card: str) -> dict:
    """Phase 3/4, the int8 path: on the card against the same path on the
    CPU, with the same quantized parameters (quantized on the card, then
    copied) and the same int8 input, two images:

    - ``conv_i8``'s int32 accumulators bitwise at every convolution shape
      of ResNet-50 and ResNeXt-50 (the stem's K 147 padded to 152, the
      strided 1×1s, the 32-group 3×3s on their block-diagonal weights);
    - ResNet-50's int8 logits within rel 1e-3 of max|logit|, the same
      argmax, on a random int8 grid and on K1's ``centered_u8`` output
      (gaussian_noise/3, one launch) fed straight to the stem;
    - ViT-B/16 (K8 in each of 12 blocks) and Swin-T (K9 in each of 12
      blocks, bias tables at a scale that reaches the logits): the first
      block's requantized LN output equal but at 1e-3 of values, its
      requantized attention output (K8's or K9's bf16 output against its
      plain version's) within one level at ≥ 95% equal; the logits'
      cosine ≥ 0.999 and rel max|Δ| within ``INT8_REL_BOUND``; the
      launches counted and no launch of ``linear_fused.cu``'s product.

    Returns the int8 classifiers on the card, by model, for phase 5."""
    from robustart_torch.models import create_classifier, quantize_swin, quantize_vit, resnet
    from robustart_torch.models.quantize import quantize_classifier
    from robustart_torch.ops import attention, linear, noise, quant
    from robustart_torch.solvers.multi_eval_solver import corrupted_grid

    gen = torch.Generator(device="cuda").manual_seed(3)

    def int8(*shape, lo=-128):
        return torch.randint(lo, 128, shape, dtype=torch.int8, device="cuda", generator=gen)

    with torch.inference_mode():
        n = 0
        for name, build in (("ResNet-50", resnet.resnet50), ("ResNeXt-50", resnet.resnext50_32x4d)):
            shapes = sorted(int8_conv_shapes(build()))
            for h, cin, k, stride, pad, groups, cout in shapes:
                x, w = int8(2, h, h, cin), int8(k, k, cin // groups, cout, lo=-127)
                got = quant.conv_i8(x, w, stride, pad, groups)
                ref = quant.conv_i8(x.cpu(), w.cpu(), stride, pad, groups)
                check(torch.equal(got.cpu(), ref), f"conv_i8 on the card differs from the "
                      f"CPU's at {name}'s {(h, cin, k, stride, pad, groups, cout)}")
            n += len(shapes)
            print(f"[int8 check] conv_i8 int32 accumulators bitwise, card (torch._int_mm) vs "
                  f"CPU, at {name}'s {len(shapes)} convolution shapes (B=2): "
                  + ", ".join(f"{h}²x{cin} k{k}/s{stride} g{groups}->{cout}"
                              for h, cin, k, stride, pad, groups, cout in shapes))

        calib = torch.randint(0, 256, (16, IMG, IMG, 3), dtype=torch.uint8, device="cuda",
                              generator=gen).cpu().numpy()
        x = int8(2, IMG, IMG, 3)
        out = {}
        clf = create_classifier("resnet50_official", seed=1, device="cuda")
        q = quantize_classifier(clf, calib, calib_batch_size=8)
        qc = q.to("cpu")
        int8_agree("ResNet-50 int8, random int8 grid", q(x), qc(x.cpu()), 1e-3, None, card)
        imgs = torch.randint(0, 256, (2, IMG, IMG, 3), dtype=torch.uint8, device="cuda",
                             generator=gen)
        before = noise.fused_noise_normalize.launches
        grid = corrupted_grid("gaussian_noise", 3, imgs, 4242)
        check(noise.fused_noise_normalize.launches - before == 1, "K1 did not launch once")
        cpu_grid = corrupted_grid("gaussian_noise", 3, imgs.cpu(), 4242)
        differ = float((grid.cpu() != cpu_grid).float().mean())
        print(f"[int8 check] K1 centered_u8 gaussian_noise/3, card vs its plain version on "
              f"the CPU: {differ:.3e} of levels differ")
        check(differ <= 1e-4, f"K1 centered_u8: {differ} of levels differ")
        int8_agree("K1 centered_u8 -> ResNet-50 int8 chain (the card's K1 batch)", q(grid),
                   qc(grid.cpu()), 1e-3, None, card)
        out["resnet50_official"] = q
        del clf

        for model, module, quantize, kernel in (
                ("vit_base", quantize_vit, quantize_vit.quantize_vit, attention.mha),
                ("swin_tiny", quantize_swin, quantize_swin.quantize_swin, attention.window_mha)):
            clf = create_classifier(model, seed=1, device="cuda", probe_init=True)
            q = quantize(clf, calib, calib_batch_size=8)
            qc = q.to("cpu")
            before, gemm = kernel.launches, linear.linear_fused.launches
            sites = {"card": [], "cpu": []}
            with recorded_requantize(module, sites["card"]):
                got = q(x)
            with recorded_requantize(module, sites["cpu"]):
                ref = qc(x.cpu())
            for i, what in enumerate(("LN output", f"attention output ({kernel.__name__})")):
                a, b = sites["card"][i].cpu().int(), sites["cpu"][i].int()
                flips, most = float((a != b).float().mean()), int((a - b).abs().max())
                print(f"[int8 check] {model} int8, block 0's requantized {what}, card vs CPU: "
                      f"{flips:.3e} of values differ, by at most {most} level(s)")
                check(most <= 1 and flips <= (1e-3 if i == 0 else 5e-2),
                      f"{model} int8: block 0's {what} differs at {flips} of values, by {most}")
            launched = kernel.launches - before
            want = INT8_PER_FORWARD[model][kernel.__name__]
            print(f"[int8 check] {model} int8 forward: {kernel.__name__} launches {launched} "
                  f"(expected {want}), linear_fused products "
                  f"{linear.linear_fused.launches - gemm} (expected 0)")
            check(launched == want, f"{model} int8: {launched} {kernel.__name__} launches")
            check(linear.linear_fused.launches == gemm, f"{model} int8 ran a bf16 product")
            int8_agree(f"{model} int8 ({kernel.__name__} on the card, its plain version on the "
                       f"CPU)", got, ref, INT8_REL_BOUND[model], 0.999, card)
            out[model] = q
            del clf
    return out


def time_int8(card: str, quantized: dict, runs: dict) -> None:
    """Phase 5, the int8 path: each int8 forward at B=128 beside the bf16
    forward of the same model in the same run (CUDA events; the int8 one
    also in device time), the int8 ResNet-50 forward's device time by
    kernel and by part (``torch.profiler``: im2col and the other copies,
    ``torch._int_mm``'s cuBLASLt GEMMs, the f32 dequant/requant epilogues),
    and each int8 solver run's img/s."""
    from robustart_torch.models import create_classifier

    xi = torch.randint(-128, 128, (MAIN_BATCH, IMG, IMG, 3), dtype=torch.int8, device="cuda")
    xn = torch.randn((MAIN_BATCH, IMG, IMG, 3), device="cuda").to(torch.bfloat16)
    with torch.inference_mode():
        for model, q in quantized.items():
            bf16 = create_classifier(model, seed=0, device="cuda", dtype=torch.bfloat16)
            t_bf = cuda_ms(lambda: bf16.forward_normalized(xn), 10, warmup=2)
            t_i8 = cuda_ms(lambda: q(xi), 10, warmup=2)
            dev = device_ms(lambda: q(xi), iters=3)
            print(f"[time] {model} forward alone, B={MAIN_BATCH}: int8 {t_i8:.3f} ms "
                  f"({MAIN_BATCH / t_i8 * 1e3:.1f} img/s; device {_ms(dev)}), bf16 {t_bf:.3f} ms "
                  f"({MAIN_BATCH / t_bf * 1e3:.1f} img/s): int8/bf16 {t_i8 / t_bf:.2f}x | {card}")
            del bf16
        q = quantized["resnet50_official"]
        device_breakdown(lambda: q(xi))  # the tracer's start-up
        parts = device_breakdown(lambda: q(xi))
        total = sum(ms for _, ms in parts)
        groups: dict[str, float] = {}
        for name, ms in parts:
            low = name.lower()
            part = ("torch._int_mm (cuBLASLt int8 GEMM)"
                    if any(k in low for k in ("gemm", "cutlass", "xmma", "igemm")) else
                    "copies (im2col, strided slices, padding)"
                    if any(k in low for k in ("copy", "cat", "pad", "fill")) else
                    "reductions (max-pool, mean)" if "reduce" in low else
                    "elementwise (f32 dequant, bias, relu, round/clamp, casts)")
            groups[part] = groups.get(part, 0.0) + ms
        if parts:
            print(f"[time] resnet50_official int8 forward by part (torch.profiler), "
                  f"B={MAIN_BATCH}: {total:.3f} ms of device time in {len(parts)} kernels: "
                  + "; ".join(f"{k} {v:.3f} ms ({v / total:.0%})" for k, v in
                              sorted(groups.items(), key=lambda kv: -kv[1])) + f" | {card}")
            print("[time] resnet50_official int8 forward, largest kernels: "
                  + "; ".join(f"{n} {ms:.3f} ms ({ms / total:.0%})" for n, ms in parts[:8])
                  + f" | {card}")
        else:
            print("[time] resnet50_official int8 forward by part: no device time in the "
                  "trace: not measured")
    for model, run in runs.items():
        print(f"[time] solver end to end, {model}@int8 ({', '.join(INT8_RUNS[model])}): "
              f"{run['n_img']} corrupted images in {run['wall']:.2f}s = "
              f"{run['n_img'] / run['wall']:.1f} img/s | {card}")


def time_kernels(card: str, k1_res: dict, new: dict, rate: float) -> dict:
    """Phase 5, kernels: each against its plain version, its bound and the
    library call, at the main path's shape; K2 on each of its inputs
    (:func:`time_warp`)."""
    from robustart_torch.ops import motion

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
    dev = device_ms(lambda: k1.fused_noise_normalize(x, 5, **kw))
    # uint8 in, bf16 out; the issue slots of K1_ISSUE_PER_ELEMENT
    bnd, by = bound(x.numel() * (1 + 2), x.numel() * K1_ISSUE_PER_ELEMENT)
    line(f"K1 fused_noise_normalize B={x.shape[0]} bf16", ms, plain, bnd, by,
         note=f" (device {_ms(dev)}; bytes alone bound it at "
              f"{x.numel() * 3 / rate * 1e3:.4f} ms)")
    res["fused_noise_normalize"] = dict(ms=ms, device_ms=dev, plain_ms=plain, bound_ms=bnd,
                                        bound_by=by, library_ms=None,
                                        issue_per_element=K1_ISSUE_PER_ELEMENT)
    # K1 in the int8 path's mode: uint8 in, the centered int8 grid out
    kc = dict(kw, out_dtype=torch.int8, output="centered_u8")
    ms = cuda_ms(lambda: k1.fused_noise_normalize(x, 5, **kc), 200)
    plain = cuda_ms(lambda: k1.fused_noise_normalize_reference(x, 5, **kc), 5, warmup=1)
    dev = device_ms(lambda: k1.fused_noise_normalize(x, 5, **kc))
    bnd, by = bound(x.numel() * 2, x.numel() * K1_ISSUE_PER_ELEMENT_I8)
    line(f"K1 fused_noise_normalize B={x.shape[0]} centered_u8 (int8 out)", ms, plain, bnd, by,
         note=f" (device {_ms(dev)}; bytes alone bound it at "
              f"{x.numel() * 2 / rate * 1e3:.4f} ms)")
    res["fused_noise_normalize"]["forms"] = [dict(
        form="centered_u8", ms=ms, device_ms=dev, plain_ms=plain, bound_ms=bnd, bound_by=by,
        library_ms=None, issue_per_element=K1_ISSUE_PER_ELEMENT_I8)]

    inp = new["inputs"]
    img, b, h, w, c = inp["img"], *inp["img"].shape
    res["warp_bilinear"] = time_warp(new["warp"], inp, bound, line)

    res["motion_taps"] = time_motion(new["motion"], bound, line)

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

    # K5, a call of 12 rounds in the launches of its plan: the map read once
    # and written once; the least known instructions a pixel a round
    # (K5_LEAST_OPS), and beside them the plain version's (K5_PLAIN_OPS)
    dist0 = inp["dist0"]
    plan = motion.chamfer_plan(*dist0.shape, 12)
    before = motion.chamfer.launches
    motion.chamfer(dist0, 20.0, 12)
    a_call = motion.chamfer.launches - before
    ms = cuda_ms(lambda: motion.chamfer(dist0, 20.0, 12), 50)
    dev = device_ms(lambda: motion.chamfer(dist0, 20.0, 12))
    plain = cuda_ms(lambda: motion.chamfer_reference(dist0, 20.0, 12), 3, warmup=1)
    bnd, by = bound(dist0.numel() * 4 * 2, dist0.numel() * 12 * K5_LEAST_OPS)
    plain_ops, _ = bound(dist0.numel() * 4 * 2, dist0.numel() * 12 * K5_PLAIN_OPS)
    line(f"K5 chamfer B={b} {h}^2, a call of 12 rounds", ms, plain, bnd, by,
         note=f" ({plan['route']} route, {a_call} launch(es) a call, cluster "
              f"{plan.get('cluster')}; device {_ms(dev)}; the plain version's 33 instructions a "
              f"pixel-round bound it at {plain_ops:.4f} ms, {plain_ops / ms:.1%})")
    res["chamfer"] = dict(ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by, library_ms=None,
                          device_ms=dev, plan_route=plan["route"], launches_a_call=a_call)
    return res


def time_motion(inputs: dict, bound, line) -> dict:
    """Phase 5, K3 at each distinct tap count of the path (motion_blur T =
    11, 16, 21 at severities 1, 3, 5; snow T = 11, 13 at severities 1, 5),
    on :func:`motion_inputs`' inputs, against its plain version and its
    bound: the image in and out and the tap rows in (bytes); a multiply and
    an add a tap (with weight) and channel (operations). No one PyTorch call
    computes it (``NO_LIBRARY``). Returns motion_blur severity 5's numbers
    (C = 3, the headline), with snow severity 5's under ``c1`` and every
    timed severity's under ``taps``."""
    from robustart_torch.ops import motion

    rows = []
    for name in ("motion_blur severity 1", "motion_blur severity 3", "motion_blur severity 5",
                 "snow severity 1", "snow severity 5"):
        img, dy, dx, wt, reach = inputs[name]
        b, h, w, c = img.shape
        ms = cuda_ms(lambda: motion.motion_taps(img, dy, dx, wt, reach=reach), 100)
        dev = device_ms(lambda: motion.motion_taps(img, dy, dx, wt, reach=reach))
        plain = cuda_ms(lambda: motion.motion_taps_reference(img, dy, dx, wt), 3, warmup=1)
        taps = int((wt != 0).sum())  # with weight, over the batch
        bnd, by = bound(img.numel() * 4 * 2 + dy.numel() * 12, taps * h * w * c * 2)
        line(f"K3 motion_taps B={b} {h}^2 C={c}, {name}, T={dy.shape[1]}", ms, plain, bnd, by,
             note=f" (device {_ms(dev)}, {bnd / (dev or ms):.1%} of bound by device)")
        rows.append(dict(input=name, taps=dy.shape[1], c=c, ms=ms, device_ms=dev,
                         plain_ms=plain, bound_ms=bnd, bound_by=by))
    head = rows[2]
    return dict(input=head["input"], ms=head["ms"], device_ms=head["device_ms"],
                plain_ms=head["plain_ms"], bound_ms=head["bound_ms"], bound_by=head["bound_by"],
                library_ms=None, c1=rows[4], taps=rows)


def time_warp(inputs: dict, inp: dict, bound, line) -> dict:
    """Phase 5, K2 on each input it is checked on: elastic_transform's two
    warps at severity 3 (the main path's: the pair timed together, a
    launch's share reported), each of them, the i.i.d. ±30 px input, the
    far-overhang input, C = 1 and 3 × 56 × 40; each
    against its plain version, its bound and ``grid_sample``. Returns the
    severity-3 pair's numbers, with every input's under ``inputs``."""
    import torch.nn.functional as F

    from robustart_torch.ops import warp

    def bound_of(img):
        # image in, two coordinate maps in, image out; 2 floors and 4
        # subtractions a pixel, 6 multiplies and 3 adds a channel
        n_pix = img.numel() // img.shape[-1]
        return bound(img.numel() * 4 * 2 + n_pix * 4 * 2, n_pix * (6 + 9 * img.shape[-1]))

    def library(img, cy, cx):
        # scipy's 'reflect' is grid_sample's reflection with align_corners=False
        h, w = img.shape[1:3]
        nchw = img.permute(0, 3, 1, 2).contiguous()
        grid = torch.stack([(2 * cx + 1) / w - 1, (2 * cy + 1) / h - 1], dim=-1)

        def lib_call():
            return F.grid_sample(nchw, grid, mode="bilinear", padding_mode="reflection",
                                 align_corners=False)

        err = float((lib_call().permute(0, 2, 3, 1)
                     - warp.warp_bilinear_reference(img, cy, cx)).abs().max())
        return lib_call, err

    timed = {
        "elastic severity 3 warp 1": inputs["elastic severity 3 warp 1"],
        "elastic severity 3 warp 2": inputs["elastic severity 3 warp 2"],
        "i.i.d. ±30 px": (inp["img"], inp["cy"], inp["cx"]),
        "far overhang": inputs["far overhang"],
        "elastic severity 3 warp 2, C=1": inputs["elastic severity 3 warp 2, C=1"],
    }
    odd = kernel_inputs(*ODD, torch.Generator(device="cuda").manual_seed(2))
    timed[f"{'x'.join(map(str, ODD))} i.i.d. ±30 px"] = (odd["img"], odd["cy"], odd["cx"])
    rows = []
    for name, args in timed.items():
        ms = cuda_ms(lambda: warp.warp_bilinear(*args), 100)
        dev = device_ms(lambda: warp.warp_bilinear(*args))
        plain = cuda_ms(lambda: warp.warp_bilinear_reference(*args), 5, warmup=1)
        bnd, by = bound_of(args[0])
        lib_fn, lib_err = library(*args)
        lib = cuda_ms(lib_fn, 100) if lib_err <= 1e-4 else None
        line(f"K2 warp_bilinear {'x'.join(map(str, args[0].shape))}, {name}", ms, plain, bnd,
             by, lib, note=f" (device {_ms(dev)}; grid_sample vs plain max|d| {lib_err:.3e})")
        rows.append(dict(input=name, ms=ms, device_ms=dev, plain_ms=plain, bound_ms=bnd,
                         bound_by=by, library_ms=lib))
    # the main path's call: elastic's two warps at severity 3, back to back
    pair = [timed["elastic severity 3 warp 1"], timed["elastic severity 3 warp 2"]]
    libs = [library(*args) for args in pair]
    ms = cuda_ms(lambda: [warp.warp_bilinear(*args) for args in pair], 100) / 2
    dev = device_ms(lambda: [warp.warp_bilinear(*args) for args in pair])
    plain = cuda_ms(lambda: [warp.warp_bilinear_reference(*args) for args in pair], 5,
                    warmup=1) / 2
    lib = (cuda_ms(lambda: [fn() for fn, _ in libs], 100) / 2
           if all(err <= 1e-4 for _, err in libs) else None)
    bnd, by = bound_of(pair[0][0])
    line("K2 warp_bilinear, elastic severity 3, both warps, a launch", ms, plain, bnd, by, lib,
         note=f" (device {_ms(dev / 2 if dev else None)} a launch)")
    return dict(input="elastic_transform severity 3, both warps, a launch's share", ms=ms,
                device_ms=dev / 2 if dev else None, plain_ms=plain, bound_ms=bnd, bound_by=by,
                library_ms=lib, inputs=rows)


def time_path(card: str, main: dict) -> None:
    """Phase 5, the path: forward alone, each corruption's pre-staged online
    step and the corruption alone (severity 3), the fused steps, the solver
    end to end."""
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
        plain = plain_corruptions()
        for corruption in main_corruptions():
            def corrupt():
                return pc.corrupt_batch(x01, corruption, 3, generator=gen)

            step = cuda_ms(lambda: online_logits(clf, corruption, 3, imgs, 77), 10)
            alone = cuda_ms(corrupt, 10)
            # the plain-torch ones' device time and device operations a
            # call: launch-bound where the time is short of the events'
            dev = ""
            if corruption in plain:
                dev_ms, n_ops = device_profile(corrupt, 5)
                dev = f", dev {_ms(dev_ms)} in {n_ops:g} device ops a call"
            print(f"[time] online step {corruption}/3 (corrupt + forward, bf16), "
                  f"pre-staged B={MAIN_BATCH}: {step:.3f} ms, "
                  f"{MAIN_BATCH / step * 1e3:.1f} img/s; the corruption alone "
                  f"{alone:.4f} ms{dev}, {alone / step:.0%} of the step | {card}")

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
    load_share = load_s * len(fused_ms) / main["wall"]
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


# the bf16 chains held against the CPU: (model, image size, what the card
# runs, the CPU's reference forward, that forward on a CPU classifier and a
# batch)
BF16_CHAINS = [
    ("densenet121", IMG, "K12 three launches a layer",
     "the CPU's fused forward (K12's plain version)", lambda cpu, x: cpu.model.fused_forward(x)),
    ("mixer_b16_224", IMG, "K10's two launches on the packed weights, K7",
     "the CPU's bf16 forward (K10's and K7's plain versions)",
     lambda cpu, x: cpu.forward_normalized(x)),
    ("mixer_b16_224", 384, "K10's route over the product at 576 tokens (the LN pass, fc1, fc2), "
     "K7", "the CPU's bf16 forward (K10's and K7's plain versions)",
     lambda cpu, x: cpu.forward_normalized(x)),
    ("convnext_base", IMG, "K11, with stage 3's channels over a cluster of two blocks, and K7",
     "the CPU's bf16 forward (K11's and K7's plain versions)",
     lambda cpu, x: cpu.forward_normalized(x)),
]


def phase_bf16_chain_checks(card: str) -> None:
    """Phase 4b for the bf16 paths of K12, K10 and K11: DenseNet-121,
    Mixer-B/16 (at 224 px and, K10 over the product, at 384) and ConvNeXt-B
    in bf16 (probe init, two images) on the card against the CPU's reference
    forward (``BF16_CHAINS``) on the same gaussian_noise/3 batch from K1.
    The same argmax on every image whose top-2 gap exceeds 1% of max|logit|
    (as ``agree`` holds a kernel), and relative max|Δlogit| ≤ 0.1: the two
    round to bf16 at the same places and sum in other orders, and a one-ulp
    difference in a layer's output (2⁻⁸ relative) carries down 58 layers, 12
    blocks and 36 blocks. The 384-px Mixer must take K10's route over the
    product in each of its 12 blocks (3 launches each)."""
    from robustart_torch.models import create_classifier
    from robustart_torch.noise.corruptions import NOISE_SEVERITY
    from robustart_torch.ops import mlp
    from robustart_torch.ops.noise import fused_noise_normalize

    kw = dict(seed=1, probe_init=True, dtype=torch.bfloat16)
    for model, size, path, ref_name, reference in BF16_CHAINS:
        imgs = torch.from_numpy(
            np.random.default_rng(7).integers(0, 256, (2, size, size, 3), np.uint8)).cuda()
        gpu = create_classifier(model, device="cuda", input_size=size, **kw)
        cpu = create_classifier(model, device="cpu", input_size=size, **kw)
        with torch.inference_mode():
            x = fused_noise_normalize(imgs, 4242, noise="gaussian_noise",
                                      sigma=NOISE_SEVERITY["gaussian_noise"][2], mean=gpu.mean,
                                      std=gpu.std, out_dtype=torch.bfloat16, output="normalized")
            before = mlp.token_mlp.product_launches
            a = gpu.forward_normalized(x).cpu()
            issued = mlp.token_mlp.product_launches - before
            b = reference(cpu, x.cpu())
        want = 3 * 12 if model == "mixer_b16_224" and size > IMG else 0
        check(issued == want, f"{model} at {size} px: {issued} launches of K10's route over the "
              f"product, expected {want}")
        top = float(b.abs().max())
        err = float((a - b).abs().max()) / top
        top2 = b.topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > 1e-2 * top
        same = a.argmax(-1) == b.argmax(-1)
        print(f"[check {model} {size} px] gaussian_noise/3 bf16, probe init, card ({path}) vs "
              f"{ref_name}: "
              f"rel max|dlogit|={err:.2e} (max|logit| {top:.3e}); argmax equal on "
              f"{int(same.sum())} of 2 images, all {int(clear.sum())} with a clear top-2 gap | "
              f"{card}")
        check(err <= 0.1 and bool(same[clear].all()),
              f"{model} bf16 chain disagrees with {ref_name} ({err})")
        del gpu, cpu


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


def time_gaussian_path(card: str, runs: dict) -> dict:
    """Phase 5, the Swin, ConvNeXt, Mixer and DenseNet paths: each forward
    alone in bf16 and f32; in bf16 each kernel's share of one forward's
    device time (``torch.profiler``); the solvers end to end. Returns K11's
    device time summed over one ConvNeXt-B bf16 forward and the forward's
    CUDA-event time."""
    from robustart_torch.models import create_classifier

    out = {}
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
                    if model == "convnext_base":
                        k11 = [ms for n, ms in parts if n.startswith("dwconv_ln")]
                        out = {"forward_device_ms": sum(k11) if k11 else None,
                               "forward_launches": PER_FORWARD[model]["dwconv_ln"],
                               "convnext_forward_ms": fwd}
                        print(f"[time] dwconv_ln over one convnext_base bf16 forward "
                              f"(torch.profiler, {PER_FORWARD[model]['dwconv_ln']} launches): "
                              + (f"{sum(k11):.3f} ms of device time, {sum(k11) / fwd:.0%} of "
                                 f"the {fwd:.3f} ms forward" if k11 else "not measured")
                              + f" | {card}")
                del clf, xn
    for model, run in runs.items():
        print(f"[time] solver end to end, {model}: {run['n_img']} corrupted images in "
              f"{run['wall']:.2f}s = {run['n_img'] / run['wall']:.1f} img/s | {card}")
    return out


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
        phase_bf16_chain_checks(card)
        int8_models = phase_int8_checks(card)
        int8_runs = {m: phase_main_path(card, m, c, int8=True) for m, c in INT8_RUNS.items()}
        rate = hbm_rate(torch.cuda.get_device_name(0))
        times = time_kernels(card, k1_res, new, rate)
        times.update(time_block_kernels(card, blk, rate))
        time_path(card, main_run)
        time_vit_path(card, vit_run, deit_run)
        times["dwconv_ln"].update(time_gaussian_path(card, gaussian_runs))
        time_int8(card, int8_models, int8_runs)
    except Failed as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(RESULTS, ignore_errors=True)

    errs = {"fused_noise_normalize": k1_res["max_abs_err"], **new["max_abs_err"],
            **blk["max_abs_err"]}
    # each kernel's launches in its own paths' runs: K1-K5 on ResNet-50, the
    # model kernels summed over the model runs; every kernel's by model
    launches = dict(main_run["launches"])
    model_runs = {"vit_base": vit_run, "deit_tiny_b16_224": deit_run, **gaussian_runs}
    runs = {"resnet50_official": main_run, **model_runs,
            **{f"{m}@int8": run for m, run in int8_runs.items()}}
    by_model = {name: {m: run["launches"][name] for m, run in runs.items()
                       if run["launches"][name]}
                for name in KERNELS}
    for name in MODEL_KERNELS:
        launches[name] = sum(by_model[name].values())

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
            "launches_by_model": by_model[name],
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
