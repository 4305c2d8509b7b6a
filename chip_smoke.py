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
   and f32; K6 in CLIP-L/14's form (128 × 257 × 1024, 16 heads of 64, no
   bias, LN eps 1e-5; also 3 images; held bitwise to the same call with
   the JAX module's zero (H, 1, 1) bias) and in Swin-B-384's (stage 0, 32
   images × 64 windows of 144 tokens, C = 128, bias and the shift mask at
   window 12; also 3 images), K7 with CLIP's quick_gelu at 128 × 257 ×
   1024 (hidden 4096; also 3 images); and, checked only, K8 at CLIP-L/14's
   257 tokens (128 × 257 × 16 heads of 64) and at ViT-B/16's 577 tokens at
   384 px (2 images);
4. the main paths at full width, each with every kernel's launches counted
   from zero and held against the count the code implies: ``MultiEvalSolver``
   online ImageNet-C on the fake backend with random weights from the seed,
   batch 128, 128 images, severities 1-5: resnet50_official in bf16 on all
   19 corruptions (an mCE over exactly the 15 standard ones, frost named
   not comparable; fog, frost, brightness, contrast, pixelate,
   jpeg_compression and saturate are plain torch and launch no
   kernel); vit_base (ViT-B/16)
   in bf16 on gaussian_noise, shot_noise, glass_blur and elastic_transform;
   deit_tiny_b16_224, swin_base, swin_tiny, convnext_base, mixer_b16_224
   and densenet121 in bf16 on gaussian_noise; clip_vit_l_14 (K6 and K7 in
   its 24 blocks) and convnextv2_base (K11 in its 36) at B=128 and
   swin_base_384 at B=32 and 384² in bf16 on gaussian_noise, with each
   run's peak device memory; then each corruption's chain
   on the card against the same chain on the CPU at a small input, the
   random draws injected (``fractal=`` for fog, ``idx=``, ``ys=``, ``xs=``
   for frost; jpeg_compression's image held bitwise), for ResNet-50, ViT-B
   and DeiT-Tiny, and the
   gaussian_noise chain of Swin-T, ConvNeXt-B, Mixer-B/16, DenseNet-121,
   CLIP-L/14 (its zero-shot head built on the card by
   ``compute_zero_shot_weights`` from a random ViT-L/14 text tower and
   pre-tokenized ids, four columns held to the CPU's), ConvNeXt-V2 and
   Swin-B at 384 px,
   with their bias tables, layer-scale, GRN and BatchNorms drawn at a scale that
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
   ``quantize_force``) and convnext_base (gaussian_noise: K1's
   ``centered_u8`` into the int8 stem, then K11 in each of 36 blocks),
   launches counted as above and no launch of the float forward's bf16
   product; then (4c) the int8 forwards of the other families at 224²,
   B=128 (``INT8_ZOO``): card against CPU on two images, the grouped
   convolutions' route bitwise against the block-diagonal product at each
   of their shapes, K11's 36 launches a ConvNeXt forward each held to its
   plain version, each int8 forward timed beside its bf16 forward;
5. times, with the card's name and power limit beside each (and each
   phase's seconds, ``[phase]`` lines): each kernel
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
   ResNet-50, ViT-B, Swin-B, Swin-T, ConvNeXt-B, Mixer-B/16,
   DenseNet-121, CLIP-L/14, ConvNeXt-V2 and Swin-B-384 forwards alone
   (bf16, f32; with their peak device memory), the last eight broken down by kernel, DenseNet-121's also
   in device time (``torch.profiler``) beside its CUDA-event time, K11's
   device time summed over one ConvNeXt-B forward; each
   corruption's online step on a pre-staged batch and the corruption alone
   (the seven plain-torch ones also by ``torch.profiler``'s device time of
   one call); the solvers' own img/s;
   K1 also in its ``centered_u8`` mode; the int8 ResNet-50, ViT-B and
   Swin-T forwards beside their bf16 ones, the int8 ResNet-50's device
   time by part (im2col and other copies, ``torch._int_mm``, the f32
   epilogues), the int8 solvers' img/s;
6. the adversarial path (``benchmark_eval_adv``): (a) each of K6-K12 at its
   path's shape (K11 also at stage 3, K10 also at 576 tokens, K12 also at
   block 4, K6 and K7 also in CLIP-L/14's forms and K6 in Swin-B-384's),
   bf16 and f32, the gradients for the input and every parameter
   through its wrapper (the kernel forward, the plain version's backward,
   ``ops/plain_grad.py``) against the plain version's own autograd, within
   the forward checks' bounds; (b) the input gradient of the mean
   cross-entropy of ResNet-50, ViT-B/16, Mixer-B/16, DeiT-Tiny, Swin-T,
   ConvNeXt-B, DenseNet-121, CLIP-L/14 and ConvNeXt-V2, f32, two images,
   on the card against the
   CPU (cosine ≥ 0.999, max|Δg| ≤ 1e-2·max|g|); (c) the solver on the fake
   backend, bf16, batch 32, 64 images, 10 classes, for resnet50_official,
   vit_b16_224, mixer_b16_224 and clip_vit_l_14 with fgsm and pgd_linf (20
   steps) at eps 8/255, and the transfer pair convnextv2_base →
   clip_vit_l_14 with fgsm, launches counted from zero and held to one a
   forward, the result files, the AR and every adversarial image's eps box
   checked, each run's peak device memory printed; (d) one PGD step of
   each of the four models (CUDA events; its peak device memory; its
   device time split by ``torch.profiler`` into the hand kernels'
   forwards, the rest of the forward and the plain backward) and the
   solvers' img/s; (e) AutoAttack (``robustart_torch.attacks.autoattack``):
   APGD-CE, APGD-T, FAB-T (3 iterations) and Square (20 queries) in Linf
   on ViT-B/16, f32, two images, on the card against the CPU from one
   injected start and draw set (best losses within rel 1e-3, the same
   argmax, at most 0.5% of image values beyond 1e-6); each stage alone on
   resnet50_official, vit_b16_224, mixer_b16_224 and clip_vit_l_14 in
   bf16, B=32, eps 8/255, labels the clean argmax, budgets cut (10
   iterations, 2 targets, 500 queries): the eps box, APGD's best loss
   against its start, FAB-T's changed samples misclassified within eps,
   each stage against a random-sign perturbation, launches held to the
   forwards counted by a wrapper of the model; ms per APGD and FAB
   iteration and per Square query, forwards, backwards, peak memory and
   the full standard cascade's reckoned time on a robust batch; then the
   solver with ``--attack autoattack_linf`` on vit_b16_224 at its
   defaults and on clip_vit_l_14 with the cut budgets, 64 images: result
   lines, AR, the eps box, launches, img/s and the robust accuracy after
   each stage;
7. the natural-noise benchmarks on the shipped ViT-B/16 configs
   (qkv_bias, bf16, B=64, 224², fake backend): (a) K2 on each warping
   perturbation's last frame at 64 × 224², bitwise; (b) one ImageNet-P
   video (two images, 31 frames, f32) of brightness, rotate and
   gaussian_noise on the card against the CPU, the draws injected (the
   same predictions, logits within rel 1e-3); (c) ``ImgnetPEvalSolver``
   online on the ten default perturbations, 31 frames, 64 videos each,
   launches held to the frames' (K2 one a frame of each warp, K3 snow's,
   K6 and K7 twelve a forward), 31 ints in [0, 1000) a line, the mFR in
   [0, 1]; (d) ``ImgnetAOEvalSolver`` with 256 images a split and a seeded
   200-class subset (200 scores a line, top-1, confidences and AUPR in
   range, launches twelve a forward); (e) K2's time on each warp's
   coordinates beside its bound and ``grid_sample``, each perturbation's
   pre-staged video step, the A and O steps and both solvers' rates with
   the share of their runs in those steps;
8. the float CNN zoo and ImageNet-S, random weights from the seed: (a)
   one forward of each of mobilenet_v2, mobilenet_v3_large_x1_0,
   mobilenet_v3_small_x1_0, efficientnet_b0, efficientnet_b7 (600², B=32),
   regnetx_3200m, regnety_3200m, repvgg_B3 (train and deploy form),
   shufflenet_v2_x2_0, googlenet and bignas_resnet18_1555M, bf16 and f32,
   on two images against the CPU's f32 forward (f32 rel 1e-4 and the same
   argmax, bf16 rel 1e-1; RepVGG's deploy form also against its train form
   on the card, rel 1e-3), then alone at B=128 (ms, img/s, peak memory);
   (b) ``MultiEvalSolver`` online on gaussian_noise for efficientnet_b0 and
   mobilenet_v3_large_x1_0, K1's launches counted as in phase 4; (c)
   ``cls_solver --evaluate`` over an ``eval_list`` of one name a family
   (bf16, ONECROP, 256 images an entry, each at its own input size; img/s
   an entry, no hand-written kernel launched); (d) the fast-IDCT route on
   the card's host (bitwise Pillow's draft-flag RGB decode at 4:4:4,
   different from the accurate decode at 4:2:0) and the ImageNet-S solver on
   resnet50_official bf16, 3 decoders × 11 resize modes on 64 fake JPEGs
   (33 combos), with the host's seconds per image of each decode and resize
   against the device's seconds per batch;
9. training (``cls_solver`` / ``adv_cls_solver_train_pgd(_new)`` on the
   fake backend, STANDARD at 224², B=32, random weights from seed 0, the
   shipped recipes at their published widths: augmentation/resnet50 (SGD,
   label smoothing, mixup 0.2 + cutmix 1.0, EMA; 8 steps),
   pgd_adv_train/resnet50 (3-step PGD at eps 0.01569; 4 steps) and
   new_adv_train/vit_base (AdamW + ``no_wd``, PGD, EMA; 4 steps in f32 and
   4 with ``model.dtype: bf16``), the schedule cut to one epoch): first
   the times (ms a step by CUDA events, img/s, peak memory; the device
   split of the two f32 PGD recipes by torch.profiler: attack, forward,
   backward, optimizer + EMA; the STANDARD loader's host seconds a batch);
   (a) each recipe trained, its losses finite and K6/K7's launches held to
   12 a forward (the train forward and one a PGD step), none on ResNet-50,
   then K6 and K7 in train mode on the ViT-B recipe's first block at its
   start, forward and every parameter's gradient against their plain
   versions, f32 and bf16; (b) one step of each recipe on 4 images, the
   card against the CPU from the same weights, batch and injected draws,
   the CPU training on the card's adversarial batch (ViT-B's f32 one held
   to the CPU's own attack: ≤ 1% of values apart); f32: loss rel 1e-4, each parameter's
   update within 1e-3 of its largest (under AdamW where the gradient
   exceeds 1e-3 of its largest, and the first moment everywhere; on
   ResNet-50 the target printed met or NOT MET and held to 3× the CPU's own
   oneDNN-off gap); bf16: loss rel 3e-2; (c) the augmentation recipe over two
   epochs of two steps, and again recovered from its epoch-0 checkpoint in
   a fresh solver, deterministic algorithms on: steps 3-4 bitwise; (d) that
   checkpoint through ``cls_solver --evaluate`` with its EMA auto-selected,
   256 images;
10. one JSON line describing every kernel of the paths (K6-K12 with their
   gradient checks under ``grad``; K6's and K7's launches include the
   training runs'), the card's line, and the last line:
   ``{"ok": true, "device": {...}}``.

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
MAIN_LIMIT = 128  # images a solver run: one batch of MAIN_BATCH
NEW_CORRUPTIONS = ["defocus_blur", "glass_blur", "motion_blur", "zoom_blur", "snow",
                   "elastic_transform", "gaussian_blur", "spatter"]
SEVERITIES = [1, 2, 3, 4, 5]
VIT_CORRUPTIONS = ["gaussian_noise", "shot_noise", "glass_blur", "elastic_transform"]
DEIT_CORRUPTIONS = ["gaussian_noise"]
# the runs on gaussian_noise alone: K1 feeds the model, every block's kernels run
GAUSSIAN_MODELS = ["swin_base", "swin_tiny", "convnext_base", "mixer_b16_224", "densenet121"]
# the last transformer names on gaussian_noise: (model, image size, batch).
# CLIP-L/14 (K6 in head groups at 257 tokens, K7 with quick_gelu) and
# ConvNeXt-V2 (K11, its MLP unfused) at B = 128; Swin-B at 384 px (window
# 12, K6 with bias and mask at 144 tokens) at B = 32, as its eval configs run
ZOO_RUNS = [("clip_vit_l_14", 224, 128), ("convnextv2_base", 224, 128),
            ("swin_base_384", 384, 32)]
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
# the BN1-ReLU pass, the 1×1 product and the 3×3; CLIP-L/14 (C = 1024, 16
# heads: two head groups in bf16, four in f32) K6 and K7 in each of its 24
# blocks; ConvNeXt-V2 K11 in each of its 36 blocks (its MLP is unfused, no
# K7); Swin-B at 384 px as Swin-B at 224
PER_FORWARD = {
    "vit_base": {"window_block": 12, "mlp": 12},
    "deit_tiny_b16_224": {"mha": 12, "mlp": 12},
    "swin_base": {"window_block": 24, "mlp": 24},
    "swin_tiny": {"window_mha": 4, "window_block": 8, "mlp": 12},
    "convnext_base": {"dwconv_ln": 36, "mlp": 36},
    "mixer_b16_224": {"token_mlp": 12, "mlp": 12},
    "densenet121": {"dense_block": 174},
    "clip_vit_l_14": {"window_block": 24, "mlp": 24},
    "convnextv2_base": {"dwconv_ln": 36},
    "swin_base_384": {"window_block": 24, "mlp": 24},
}
# K12's calls (one per dense block) per forward
DENSE_CALLS_PER_FORWARD = {"densenet121": 4}
# the int8 runs (model.quantize: int8; ViT and Swin under quantize_force):
# ResNet-50 on gaussian_noise (K1's centered_u8 straight into the int8 stem)
# and glass_blur (K4, then the uint8 grid); ViT-B and Swin-T on
# gaussian_noise. Each calibrates on its first corruption's first
# INT8_CALIB_BATCHES batches at the highest severity.
INT8_RUNS = {"resnet50_official": ["gaussian_noise", "glass_blur"],
             "vit_base": ["gaussian_noise"], "swin_tiny": ["gaussian_noise"],
             "convnext_base": ["gaussian_noise"]}
INT8_CALIB_BATCHES = 2
# each int8 model's kernel launches per forward: K8 in every ViT-B block,
# K9 in every Swin-T block, K11 in every ConvNeXt block (the int8 path has
# no K6, K7 or K10: its products are int8 GEMMs, its LN, GELU and residuals
# torch's; and no K12: the int8 DenseNet runs its own convolutions)
INT8_PER_FORWARD = {"resnet50_official": {}, "vit_base": {"mha": 12},
                    "swin_tiny": {"window_mha": 12}, "convnext_base": {"dwconv_ln": 36},
                    "convnextv2_base": {"dwconv_ln": 36}}
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
                     "swin_tiny": {"fused_noise_normalize", "window_mha"},
                     "convnext_base": {"fused_noise_normalize", "dwconv_ln"}}
# phase 4c: the int8 forwards of the other families (the Mixer forced), at
# IMG, B=MAIN_BATCH, random weights from seed 0 (ConvNeXt's layer-scale and
# DenseNet's BatchNorms at a scale that reaches the logits), calibrated on
# INT8_CALIB_BATCHES batches of MAIN_BATCH random uint8 images; RepVGG-B3 in
# its deploy form. Card against CPU on INT8_ZOO_IMAGES images of the same
# int8 input, on the parameters quantized on the card: rel max|Δlogit| ≤
# 1e-3 of max|logit| or cosine ≥ 0.999 on every image, and the same
# argmax (the bounds phase 4 holds the int8 ResNet-50 and transformers to)
INT8_ZOO = ["convnext_base", "convnextv2_base", "mixer_b16_224", "densenet121", "mobilenet_v2",
            "mobilenet_v3_large_x1_0", "efficientnet_b0", "regnetx_3200m", "regnety_3200m",
            "repvgg_B3", "shufflenet_v2_x2_0"]
INT8_ZOO_IMAGES = 2
INT8_ZOO_REL = 1e-3
INT8_ZOO_COS = 0.999
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
    "clip_vit_l_14": {"fused_noise_normalize", "window_block", "mlp"},
    "convnextv2_base": {"fused_noise_normalize", "dwconv_ln"},
    "swin_base_384": {"fused_noise_normalize", "window_block", "mlp"},
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


_held = [0.0]  # GiB allocated at the last reset_peak


def reset_peak() -> None:
    """Start a peak-memory reading, noting the memory held now (the models
    and tensors earlier phases keep)."""
    torch.cuda.reset_peak_memory_stats()
    _held[0] = torch.cuda.memory_allocated() / 2**30


def peak_memory() -> str:
    """The device memory allocated at its peak since :func:`reset_peak`,
    beside what was held then."""
    peak = torch.cuda.max_memory_allocated() / 2**30
    return (f"peak device memory {peak:.2f} GiB, {peak - _held[0]:.2f} above the "
            f"{_held[0]:.2f} held before")


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
                 masked: bool = True, ws: int = 7) -> dict:
    """Inputs of K6, K7, K8 and K9 at one shape: activations of unit scale,
    LN parameters near identity, weights of std 1/√fan_in, small f32
    biases, the hidden width F = 4C. ``nw`` > 0 makes Swin's: b windows of
    n = ws² tokens, a bias (H, n, n) of std 0.5, LN eps 1e-5, q/k/v as the
    views of a packed product and, where ``masked``, the real shift mask of
    ``nw`` window positions at window ``ws``, shift ws // 2 (a 56² or 14²
    stage at ws 7, Swin-B-384's 96² at ws 12)."""
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
            side = ws * math.isqrt(nw)
            mask = shift_attn_mask(side, side, ws, ws // 2)
            inp.update(nw=nw, mask=torch.from_numpy(mask).cuda())
    return inp


def swin_inputs(imgs: int, nw: int, heads: int, c: int, dtype, gen, masked: bool = True):
    return block_inputs(imgs * nw, 49, c, heads, dtype, gen, nw, masked)


def swin384_inputs(imgs: int, nw: int, heads: int, c: int, dtype, gen):
    """Swin-B-384's stage 0: window 12 (144 tokens), shift 6."""
    return block_inputs(imgs * nw, 144, c, heads, dtype, gen, nw, True, ws=12)


def clip_inputs(b: int, n: int, c: int, heads: int, dtype, gen) -> dict:
    """CLIP's blocks: :func:`block_inputs` with LN eps 1e-5 and no relative
    bias (the JAX module's zero bias)."""
    return {**block_inputs(b, n, c, heads, dtype, gen), "eps": 1e-5}


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
    ("window_block_clip", "CLIP-L/14", True, clip_inputs, (MAIN_BATCH, 257, 1024, 16)),
    ("window_block_clip", "3 images", False, clip_inputs, (3, 257, 1024, 16)),
    ("mlp_quick_gelu", "CLIP-L/14", True, clip_inputs, (MAIN_BATCH, 257, 1024, 16)),
    ("mlp_quick_gelu", "CLIP-L/14 form 3x257x1024", False, clip_inputs, (3, 257, 1024, 16)),
    ("window_mha", "Swin-T stage 0", True, swin_inputs, (MAIN_BATCH, 64, 3, 96)),
    ("window_mha", "Swin-T stage 0 unmasked", False, swin_inputs,
     (MAIN_BATCH, 64, 3, 96, False)),
    ("window_mha", "3 images", False, swin_inputs, (3, 4, 3, 96)),
    ("window_mha", "3 images unmasked", False, swin_inputs, (3, 4, 3, 96, False)),
    ("window_block_swin", "Swin-B stage 0", True, swin_inputs, (MAIN_BATCH, 64, 4, 128)),
    ("window_block_swin", "3 images", False, swin_inputs, (3, 4, 4, 128)),
    ("window_block_swin384", "Swin-B-384 stage 0", True, swin384_inputs, (32, 64, 4, 128)),
    ("window_block_swin384", "3 images", False, swin384_inputs, (3, 64, 4, 128)),
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
FORM_KERNEL = {"window_block_swin": "window_block", "mlp_convnext": "mlp",
               "window_block_clip": "window_block", "mlp_quick_gelu": "mlp",
               "window_block_swin384": "window_block"}
# the models whose blocks call each of those forms (Swin's K7 is ViT's form)
FORM_MODELS = {"window_block_swin": ("swin_base", "swin_tiny"),
               "mlp_convnext": ("convnext_base",), "window_block_clip": ("clip_vit_l_14",),
               "mlp_quick_gelu": ("clip_vit_l_14",), "window_block_swin384": ("swin_base_384",)}


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


def agree_bound(top: float, exact32: bool) -> float:
    """The bound on a difference from values of largest magnitude ``top``:
    1e-5 of it in f32, one bf16 ulp of it in bf16."""
    return 1e-5 * top if exact32 else 2.0 ** (math.floor(math.log2(top)) - 7)


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
        check(err <= agree_bound(top, True), f"{name}: max|d| {err:.3e} > 1e-5 of {top:.3e}")
        return err
    ulp = agree_bound(top, False)
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
            if form == "window_block_clip":
                # the JAX module passes a zero (H, 1, 1) bias; the port passes none
                zero = attention.window_block_qkv(
                    inp["x"], *inp["ln"], inp["w_qkv"], inp["b_qkv"], inp["w"][3], inp["b"][3],
                    torch.zeros((inp["heads"], 1, 1), device="cuda"), None,
                    num_heads=inp["heads"], eps=inp["eps"])
                check(torch.equal(zero, got), f"{name}: a zero bias changes the output")
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
    if FORM_KERNEL.get(form, form) == "mlp":
        f = inp["w1"].shape[0]
        # ViT's form (and CLIP's): x (also the residual) in, LN parameters;
        # ConvNeXt's: a separate shortcut in, gamma
        act, params = (3, 2 * c) if form == "mlp_convnext" else (2, 3 * c)
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
        vit = form != "mlp_convnext"  # ViT's and CLIP's form: LN prologue, raw-x residual
        act = "quick_gelu" if form == "mlp_quick_gelu" else "gelu"
        fc1_kw = {"ln": inp["ln"], "eps": inp["eps"]} if vit else {}
        fc2_kw = ({"residual": x2} if vit
                  else {"gamma": inp["gamma"], "residual": inp["shortcut"].reshape(m, c)})
        products = {
            "fc1": (lambda: linear_fused(x2, inp["w1"], inp["b1"], act=act, **fc1_kw),
                    lambda: torch.matmul(x2, inp["w1"].t()), 2 * m * c * f),
            "fc1 without the LN pass": (
                lambda: linear_fused(x2, inp["w1"], inp["b1"], act=act),
                lambda: torch.matmul(x2, inp["w1"].t()), 2 * m * c * f),
            "fc2": (lambda: linear_fused(h, inp["w2"], inp["b2"], **fc2_kw),
                    lambda: torch.matmul(h, inp["w2"].t()), 2 * m * c * f),
        }
        if not vit:
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
                int8: bool = False, size: int = IMG):
    from robustart_torch.core.config import Config

    corruptions = corruptions or main_corruptions()
    quantize = {"quantize": "int8", "quantize_force": True,
                "quantize_calib_batches": INT8_CALIB_BATCHES} if int8 else {}
    return Config({
        "model": {"type": model, "dtype": "bf16", **quantize},
        "seed": 0,
        "data": {
            "read_from": "fake", "fake_size": limit, "batch_size": batch_size,
            "num_workers": 8, "input_size": size, "test_resize": max(256, size),
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
                    corruptions: list | None = None, int8: bool = False, size: int = IMG,
                    batch: int = MAIN_BATCH) -> dict:
    """Phase 4: the ImageNet-C solver, online, at full width, every count
    set to 0 just before the run and read just after, ``batch`` images of
    ``size``² a batch. ``int8``: with ``model.quantize: int8``, which must
    launch no product of ``linear_fused.cu`` (``gemm_bf16_kernel``: the
    float forward's). Prints the run's peak device memory."""
    from robustart_torch.models.quantize import Int8Model
    from robustart_torch.ops import linear
    from robustart_torch.solvers import MultiEvalSolver

    corruptions = corruptions or main_corruptions()
    tag = f"{model}@int8" if int8 else model
    shutil.rmtree(RESULTS, ignore_errors=True)
    solver = MultiEvalSolver(main_config(batch, model, corruptions, int8=int8,
                                         size=size))  # cuda by default
    solver.build_model(seed=0)
    reset_peak()
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
    peak = peak_memory()
    n_batches = -(-MAIN_LIMIT // batch)
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
          f"non_comparable={summary['non_comparable']}; top1_per_corruption={top1}; "
          f"B={batch}, {size}px, {peak}")
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


def phase_int8_zoo(card: str) -> dict:
    """Phase 4c, the int8 forwards of ``INT8_ZOO`` (each through the
    solver's quantizer for its family, on the card):

    - card against CPU (``q.to("cpu")``: the same quantized parameters) on
      ``INT8_ZOO_IMAGES`` images of one random int8 input: rel max|Δlogit|
      ≤ ``INT8_ZOO_REL`` or cosine ≥ ``INT8_ZOO_COS``, and the same argmax;
    - the grouped convolutions' route (an f32 cuDNN convolution of the int8
      values, ``ops/quant.py::grouped_exact``) against the block-diagonal
      product, int32 accumulators bitwise on the card, at every grouped
      shape these forwards take (recorded from the B=128 forwards, on random
      int8 inputs and weights at those shapes);
    - one B=128 forward's launches: K11 ``INT8_PER_FORWARD`` times in a
      ConvNeXt, each launch held to ``dwconv_ln_reference`` on the same
      inputs on the card (``agree``: one bf16 ulp of its largest value and
      the downstream argmax), no launch of any other hand-written kernel or
      of ``linear_fused.cu``'s product;
    - the int8 forward and the family's bf16 forward at B=128, CUDA events.

    Returns {model: (int8 ms, bf16 ms)}."""
    from robustart_torch.models import create_classifier, quantize_convnext, quantize_net
    from robustart_torch.models.repvgg import reparameterize
    from robustart_torch.ops import convnext, linear, quant
    from robustart_torch.solvers.base import Solver

    gen = torch.Generator(device="cuda").manual_seed(5)
    calib = torch.randint(0, 256, (INT8_CALIB_BATCHES * MAIN_BATCH, IMG, IMG, 3),
                          dtype=torch.uint8, device="cuda", generator=gen).cpu().numpy()
    xi = torch.randint(-128, 128, (MAIN_BATCH, IMG, IMG, 3), dtype=torch.int8, device="cuda",
                       generator=gen)
    xn = torch.randn((MAIN_BATCH, IMG, IMG, 3), device="cuda", generator=gen).to(torch.bfloat16)
    x2 = xi[:INT8_ZOO_IMAGES]
    quantizers = Solver._int8_quantizers()
    grouped = {}  # (x shape, k, stride, padding, groups, cout) -> models
    real_conv, real_k11 = quantize_net.conv_i8_packed, quantize_convnext.dwconv_ln
    out = {}

    def recording(x, p, stride=1, padding=0):
        if p.route == "grouped" and x.is_cuda:
            key = (tuple(x.shape), p.k, stride, padding, p.groups, p.weight.shape[0])
            grouped.setdefault(key, set()).add(model)
        return real_conv(x, p, stride, padding)

    def k11_checked(x, w, b, gamma, beta, eps):
        y = real_k11(x, w, b, gamma, beta, eps)
        errs.append(agree(f"K11 in int8 {model}, launch {len(errs)} {tuple(x.shape)}", y,
                          convnext.dwconv_ln_reference(x, w, b, gamma, beta, eps), gen))
        return y

    try:
        for model in INT8_ZOO:
            with torch.inference_mode(False):
                clf = create_classifier(model, seed=0, device="cuda", probe_init=True)
            family = type(clf.model).__name__
            t0 = time.time()
            with torch.inference_mode():
                q = quantizers[family](clf, calib, calib_batch_size=MAIN_BATCH)
            quant_s = time.time() - t0
            del clf
            with torch.inference_mode():
                got = q(x2).cpu()
                ref = q.to("cpu")(x2.cpu())
                rel = float((got - ref).abs().max()) / float(ref.abs().max())
                cos = float(((got * ref).sum(-1) / (got.norm(dim=-1) * ref.norm(dim=-1))).min())
                same = bool(torch.equal(got.argmax(-1), ref.argmax(-1)))
                print(f"[int8 zoo] {model} ({type(q).__name__}, quantized on the card in "
                      f"{quant_s:.1f}s) card vs CPU, {INT8_ZOO_IMAGES} images: rel "
                      f"max|dlogit|={rel:.3e} (max|logit| {float(ref.abs().max()):.3e}), "
                      f"min cosine {cos:.6f}, argmax equal {same} | {card}")
                check(bool(torch.isfinite(got).all()) and got.shape == (INT8_ZOO_IMAGES, 1000),
                      f"int8 {model}: logits not finite or of shape {tuple(got.shape)}")
                check((rel <= INT8_ZOO_REL or cos >= INT8_ZOO_COS) and same,
                      f"int8 {model}: card vs CPU rel {rel:.3e}, cosine {cos:.6f}, "
                      f"argmax equal {same}")

                errs = []
                for fn in wrappers().values():
                    fn.launches = 0
                linear.linear_fused.launches = 0
                quantize_convnext.dwconv_ln = k11_checked
                quantize_net.conv_i8_packed = recording
                try:
                    y = q(xi)
                finally:
                    quantize_convnext.dwconv_ln = real_k11
                    quantize_net.conv_i8_packed = real_conv
                launched = {name: fn.launches for name, fn in wrappers().items() if fn.launches}
                want = INT8_PER_FORWARD.get(model, {})
                print(f"[int8 zoo] {model} int8 forward, B={MAIN_BATCH}: hand-kernel launches "
                      f"{launched} (expected {want}), linear_fused products "
                      f"{linear.linear_fused.launches} (expected 0)"
                      + (f"; each K11 launch against dwconv_ln_reference on the card: max|d| "
                         f"{max(errs):.3e}" if errs else ""))
                check(launched == want and len(errs) == sum(want.values()),
                      f"int8 {model}: launches {launched}, expected {want}")
                check(linear.linear_fused.launches == 0, f"int8 {model} ran a bf16 product")
                check(bool(torch.isfinite(y).all()), f"int8 {model}: B={MAIN_BATCH} logits "
                      "not finite")
                t_i8 = cuda_ms(lambda: q(xi), 5, warmup=2)
                del q, y
                with torch.inference_mode(False):
                    bf16 = create_classifier(model, seed=0, device="cuda", dtype=torch.bfloat16)
                    if family == "RepVGG":
                        bf16.model = reparameterize(bf16.model)
                t_bf = cuda_ms(lambda: bf16.forward_normalized(xn), 5, warmup=2)
                del bf16
            out[model] = (t_i8, t_bf)
            print(f"[time] {model} forward alone, B={MAIN_BATCH}: int8 {t_i8:.3f} ms "
                  f"({MAIN_BATCH / t_i8 * 1e3:.1f} img/s), bf16 {t_bf:.3f} ms "
                  f"({MAIN_BATCH / t_bf * 1e3:.1f} img/s): int8/bf16 {t_i8 / t_bf:.2f}x | {card}")
    finally:
        quantize_net.conv_i8_packed, quantize_convnext.dwconv_ln = real_conv, real_k11

    with torch.inference_mode():
        for (shape, k, stride, pad, groups, cout), models in sorted(grouped.items()):
            x = torch.randint(-128, 128, shape, dtype=torch.int8, device="cuda", generator=gen)
            w = torch.randint(-127, 128, (k, k, shape[-1] // groups, cout), dtype=torch.int8,
                              device="cuda", generator=gen)
            a = quant.conv_i8(x, w, stride, pad, groups, "grouped")
            b = quant.conv_i8(x, w, stride, pad, groups, "product")
            check(a.dtype == torch.int32 and torch.equal(a, b),
                  f"grouped route differs from the block-diagonal product at {shape} k{k} "
                  f"s{stride} g{groups}")
            del x, w, a, b
    print(f"[int8 zoo] grouped route (f32 cuDNN, TF32 off) vs block-diagonal product "
          f"(torch._int_mm), int32 bitwise on the card at {len(grouped)} shapes: "
          + ", ".join(f"{s[0]}x{s[1]}x{s[2]}x{s[3]} k{k}/s{st} g{g}->{co} "
                      f"({'/'.join(sorted(m))})"
                      for (s, k, st, _, g, co), m in sorted(grouped.items())))
    check(bool(grouped), "no grouped convolution was recorded")
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


# the models of phase_model_reference_check
REFERENCE_MODELS = ["swin_tiny", "convnext_base", "mixer_b16_224", "densenet121",
                    "clip_vit_l_14", "convnextv2_base", "swin_base_384"]


def phase_model_reference_check(card: str) -> None:
    """Phase 4b for Swin, ConvNeXt, Mixer, DenseNet and the last transformer
    names: the gaussian_noise chain of Swin-T (K9, K6 with bias and mask,
    K7), ConvNeXt-B (K11, K7 with gamma and shortcut), Mixer-B/16 (K10, K7),
    DenseNet-121 (K12 on the card, the concat forward on the CPU), CLIP-L/14
    (K6 in four head groups at 257 tokens, K7 with quick_gelu; its head from
    :func:`random_text_tower_head`), ConvNeXt-V2 (K11, GRN) and Swin-B at 384
    px (K6 at window 12) on the card against the same chain on the CPU, on
    the same K1 batch (one seed), float32, two images, the bias tables,
    layer-scale, GRN and BatchNorms drawn at a scale that reaches the logits
    (``probe_init``). Relative max|Δlogit| ≤ 1e-3 and the same argmax."""
    from robustart_torch.models import create_classifier
    from robustart_torch.solvers.multi_eval_solver import online_logits

    for model in REFERENCE_MODELS:
        t = time.time()
        gpu = create_classifier(model, seed=1, device="cuda", probe_init=True)
        cpu = create_classifier(model, seed=1, device="cpu", probe_init=True)
        size = gpu.input_size
        imgs = torch.from_numpy(
            np.random.default_rng(7).integers(0, 256, (2, size, size, 3), np.uint8))
        if model == "clip_vit_l_14":
            head = torch.from_numpy(random_text_tower_head(card, gpu.num_classes))
            for clf in (gpu, cpu):
                clf.model.zero_shot_weights.data.copy_(head)
        with torch.inference_mode():
            a = online_logits(gpu, "gaussian_noise", 3, imgs.cuda(), 4242).cpu()
            b = online_logits(cpu, "gaussian_noise", 3, imgs, 4242)
        err = float((a - b).abs().max()) / float(b.abs().max())
        print(f"[check {model}] gaussian_noise/3 chain f32, probe init, {size}px, card vs CPU: "
              f"rel max|dlogit|={err:.2e} (max|logit| {float(b.abs().max()):.3e}; "
              f"{time.time() - t:.1f}s)")
        check(err <= 1e-3 and torch.equal(a.argmax(-1), b.argmax(-1)),
              f"{model} gaussian_noise chain disagrees with the CPU reference ({err})")


def random_text_tower_head(card: str, classes: int) -> np.ndarray:
    """A zero-shot head for CLIP-L/14 built by ``compute_zero_shot_weights``
    on the card from a random text tower of ViT-L/14's shape in OpenAI's key
    layout (width 768, 12 heads, 12 layers, context 77, vocabulary 49,408,
    embed 768; no checkpoint or merges file is in the repository) and
    pre-tokenized ids (two random prompts a class, start and end tokens in
    place); its first four columns built again on the CPU, within 1e-5.
    Returns the (768, classes) head."""
    from robustart_torch.models.clip_text import compute_zero_shot_weights

    g = torch.Generator().manual_seed(21)
    width, depth, ctx, vocab, embed = 768, 12, 77, 49408, 768

    def n(*shape, s=0.02):
        return torch.randn(shape, generator=g) * s

    sd = {"token_embedding.weight": n(vocab, width), "positional_embedding": n(ctx, width, s=0.01),
          "ln_final.weight": 1.0 + n(width, s=0.1), "ln_final.bias": n(width, s=0.1),
          "text_projection": n(width, embed, s=width ** -0.5)}
    for i in range(depth):
        p = f"transformer.resblocks.{i}."
        sd.update({p + "ln_1.weight": 1.0 + n(width, s=0.1), p + "ln_1.bias": n(width, s=0.1),
                   p + "attn.in_proj_weight": n(3 * width, width, s=width ** -0.5),
                   p + "attn.in_proj_bias": n(3 * width),
                   p + "attn.out_proj.weight": n(width, width, s=width ** -0.5),
                   p + "attn.out_proj.bias": n(width),
                   p + "ln_2.weight": 1.0 + n(width, s=0.1), p + "ln_2.bias": n(width, s=0.1),
                   p + "mlp.c_fc.weight": n(4 * width, width, s=width ** -0.5),
                   p + "mlp.c_fc.bias": n(4 * width),
                   p + "mlp.c_proj.weight": n(width, 4 * width, s=(4 * width) ** -0.5),
                   p + "mlp.c_proj.bias": n(width)})
    tokens = []
    for _ in range(classes):
        ids = np.zeros((2, ctx), np.int64)
        for row in ids:
            length = int(torch.randint(5, 24, (1,), generator=g))
            row[0], row[length - 1] = vocab - 2, vocab - 1  # <|startoftext|>, <|endoftext|>
            row[1:length - 1] = torch.randint(1, vocab - 2, (length - 2,), generator=g).numpy()
        tokens.append(ids)
    t = time.time()
    head = compute_zero_shot_weights(sd, class_tokens=tokens, device="cuda")
    card_s = time.time() - t
    cpu = compute_zero_shot_weights(sd, class_tokens=tokens[:4], device="cpu")
    err = float(np.abs(head[:, :4] - cpu).max())
    norms = np.linalg.norm(head, axis=0)
    print(f"[check clip_vit_l_14] zero-shot head {head.shape} from a random ViT-L/14 text tower "
          f"and pre-tokenized ids (2 prompts a class) on the card in {card_s:.2f}s; its first 4 "
          f"columns on the CPU: max|d|={err:.2e}; column norms {norms.min():.6f}-"
          f"{norms.max():.6f} | {card}")
    check(head.shape == (embed, classes) and np.isfinite(head).all() and err <= 1e-5
          and np.abs(norms - 1).max() <= 1e-5, "the CLIP zero-shot head disagrees with the CPU's")
    return head


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
    """Phase 5, the Swin, ConvNeXt, Mixer, DenseNet, CLIP-L, ConvNeXt-V2 and
    Swin-B-384 paths: each forward alone in bf16 and f32 at its run's batch
    and image size, with its peak device memory; in bf16 each kernel's
    share of one forward's device time (``torch.profiler``); the solvers end
    to end. Returns K11's device time summed over one ConvNeXt-B bf16
    forward and the forward's CUDA-event time, and the bf16 forwards' times
    under ``forwards``."""
    from robustart_torch.models import create_classifier

    out, forwards = {}, {}
    with torch.inference_mode():
        for model, size, batch in [(m, IMG, MAIN_BATCH) for m in GAUSSIAN_MODELS] + ZOO_RUNS:
            for dtype, iters in ((torch.bfloat16, 10), (torch.float32, 3)):
                # built outside inference mode, as the solver builds it: a
                # DenseNet caches its packed blocks on its parameters' versions
                with torch.inference_mode(False):
                    clf = create_classifier(model, seed=0, device="cuda", dtype=dtype)
                xn = torch.randn((batch, size, size, 3), device="cuda").to(dtype)
                reset_peak()
                fwd = cuda_ms(lambda: clf.forward_normalized(xn), iters, warmup=2)
                peak = peak_memory()
                if dtype == torch.bfloat16:
                    forwards[model] = {"ms": fwd, "batch": batch, "size": size}
                print(f"[time] {model} forward alone, {dtype}, B={batch}, {size}px: {fwd:.3f} ms, "
                      f"{batch / fwd * 1e3:.1f} img/s; {peak} | {card}")
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
                    print(f"[time] {model} bf16 forward B={batch} by kernel (torch.profiler): "
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
    return {**out, "forwards": forwards}


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


# the adversarial slice: gradients through K6-K12 (phase 6a), model input
# gradients card against CPU (6b), benchmark_eval_adv on the card (6c), and
# the times of a PGD step and of the solver (6d)

# K6-K12's gradient checks: each form's path shape from CASES; K11 also at
# stage 3 (C over a cluster of two), K10 also at 576 tokens (its route over
# the product), K12 also at block 4; K6 and K7 also at CLIP-L/14's shapes
# and K6 at Swin-B-384's stage 0
GRAD_CASES = [("window_block", "ViT-B"), ("window_block_swin", "Swin-B stage 0"),
              ("window_block_clip", "CLIP-L/14"), ("window_block_swin384", "Swin-B-384 stage 0"),
              ("mlp", "ViT-B"), ("mlp_quick_gelu", "CLIP-L/14"),
              ("mlp_convnext", "ConvNeXt-B stage 0"), ("mha", "DeiT-Tiny"),
              ("window_mha", "Swin-T stage 0"), ("dwconv_ln", "ConvNeXt-B stage 0"),
              ("dwconv_ln", "ConvNeXt-B stage 3"), ("token_mlp", "Mixer-B/16"),
              ("token_mlp", "Mixer-B/16 at 384 px"), ("dense_block", "DenseNet-121 block 1"),
              ("dense_block", "DenseNet-121 block 4")]
# the forms this slice adds (CLIP-L/14's K6 and K7, Swin-B-384's K6): in bf16
# a gradient is held to one ulp of its largest value or, where that is
# larger, to twice the plain version's own bf16 error on the same inputs
# (its autograd in bf16 against its autograd in f32): two bf16 backwards of
# one function, each that far from the exact gradient, may lie twice that
# far apart. The bf16 backward rounds on its way to dx (the q/k/v gradient
# is stored in bf16, then dx), and the kernel's forward hands it q/k/v that
# differ by an ulp here and there, so dx can move by more than one ulp:
# Swin-B-384's d/dx read 1 ulp from one draw and 2 from another, where the
# plain version's own error was 1.3 ulps. The kernel path's own error
# against the f32 gradient is printed beside it.
GRAD_FLOOR_FORMS = {"window_block_clip", "mlp_quick_gelu", "window_block_swin384"}
# each kernel's backward: the autograd of the plain version of the Function's
# launcher (ops/plain_grad.py), recomputed from the saved inputs
GRAD_ROUTE = {
    "window_block": "plain backward of each of its three launches (linear_fused_reference, "
                    "attention_core_reference, linear_fused_reference), recomputed",
    "mlp": "plain backward of each of its two launches (linear_fused_reference), recomputed",
    "mha": "plain backward (attention_core_reference), recomputed",
    "window_mha": "plain backward (attention_core_reference with bias and mask), recomputed",
    "dwconv_ln": "plain backward (dwconv_ln_reference), recomputed",
    "token_mlp": "plain backward of the whole call (token_mlp_reference), recomputed",
    "dense_block": "plain backward of the whole call (dense_block_reference), recomputed",
}
# phase 6b: input gradients card against CPU, f32, batch 2, full width
GRAD_MODELS = ["resnet50_official", "vit_b16_224", "mixer_b16_224", "deit_tiny_b16_224",
               "swin_tiny", "convnext_base", "densenet121", "clip_vit_l_14", "convnextv2_base"]
GRAD_COSINE, GRAD_REL = 0.999, 1e-2
# the two ReLU networks that miss GRAD_REL: (the card's fixed limit on
# max|dg|/max|g|, the CPU's own oneDNN-off gap that explains the miss as
# read on an H100 80GB HBM3 host at 700 W, to its printed precision; ResNet-50's
# read again, 1.716e-2, once the eval input's normalization became the
# jitted JAX eval's, which moved its ReLU near-ties). The gap is measured
# again and must stay within its reading.
GRAD_REL_MISSED = {"resnet50_official": (3e-2, 1.72e-2), "densenet121": (4e-2, 1.79e-2)}
# phase 6c: the models of exprs/nips_benchmark/adv_eval/eval.sh and CLIP-L/14
# (batch_eval_adv/clip_eval.sh), bf16, 10 classes (with 1000 random-weight
# classes the AR's denominator is empty by chance), each attack with its
# forward + backward steps a batch; then one transfer pair of
# new_transfer/eval.sh, (source, target, attack)
ADV_MODELS = ["resnet50_official", "vit_b16_224", "mixer_b16_224", "clip_vit_l_14"]
ADV_ATTACKS = [("fgsm", 8.0, 1), ("pgd_linf", 8.0, 20)]
ADV_TRANSFER = [("convnextv2_base", "clip_vit_l_14", "fgsm")]
ADV_BATCH, ADV_LIMIT = 32, 64
ADV_PATH_KERNELS = {"resnet50_official": set(), "vit_b16_224": {"window_block", "mlp"},
                    "mixer_b16_224": {"token_mlp", "mlp"},
                    "clip_vit_l_14": {"window_block", "mlp"}, "convnextv2_base": {"dwconv_ln"}}
PER_FORWARD["vit_b16_224"] = PER_FORWARD["vit_base"]


def grad_calls(form: str, inp: dict) -> tuple:
    """(leaves, kernel call, plain call) of one form for its gradient check:
    ``leaves`` the input and every parameter by name, each call a function
    of a dict of them. K6 takes the packed q/k/v weights (its plain version
    splits them), K9 the views of one packed q/k/v tensor, K10 in bf16 the
    weights packed once as a model packs them (read by the kernel alone)."""
    from robustart_torch.ops import attention, convnext, densenet, mlp

    x = inp["x"]
    if FORM_KERNEL.get(form, form) == "window_block":
        (lns, lnb), w, bb = inp["ln"], inp["w"], inp["b"]
        c = x.shape[-1]
        leaves = {"x": x, "ln_scale": lns, "ln_bias": lnb, "w_qkv": inp["w_qkv"],
                  "b_qkv": inp["b_qkv"], "wp": w[3], "bp": bb[3]}
        if inp["rel_bias"] is not None:
            leaves["rel_bias"] = inp["rel_bias"]
        kw = {"num_heads": inp["heads"], "num_windows": inp["nw"], "eps": inp["eps"]}

        def kernel(v):
            return attention.window_block_qkv(v["x"], v["ln_scale"], v["ln_bias"], v["w_qkv"],
                                              v["b_qkv"], v["wp"], v["bp"], v.get("rel_bias"),
                                              inp["mask"], **kw)

        def plain(v):
            wq, wk, wv = v["w_qkv"].split(c)
            bq, bk, bv = v["b_qkv"].split(c)
            return attention.window_block_reference(v["x"], v["ln_scale"], v["ln_bias"], wq, bq,
                                                    wk, bk, wv, bv, v["wp"], v["bp"],
                                                    v.get("rel_bias"), inp["mask"], **kw)

        return leaves, kernel, plain
    if FORM_KERNEL.get(form, form) == "mlp":
        leaves = {k: inp[k] for k in ("x", "w1", "b1", "w2", "b2")}
        if form == "mlp_convnext":
            leaves.update(gamma=inp["gamma"], shortcut=inp["shortcut"])

            def call(fn):
                return lambda v: fn(v["x"], v["w1"], v["b1"], v["w2"], v["b2"],
                                    gamma=v["gamma"], residual=v["shortcut"])
        else:
            leaves.update(ln_scale=inp["ln"][0], ln_bias=inp["ln"][1])
            act = "quick_gelu" if form == "mlp_quick_gelu" else "gelu"

            def call(fn):
                return lambda v: fn(v["x"], v["w1"], v["b1"], v["w2"], v["b2"],
                                    ln=(v["ln_scale"], v["ln_bias"]), ln_eps=inp["eps"],
                                    residual=v["x"], act=act)
        return leaves, call(mlp.mlp), call(mlp.mlp_reference)
    if form == "mha":
        leaves = dict(zip("qkv", inp["qkv"]))
        return (leaves, lambda v: attention.mha(v["q"], v["k"], v["v"]),
                lambda v: attention.mha_reference(v["q"], v["k"], v["v"]))
    if form == "window_mha":
        leaves = {"qkv": torch.stack(inp["qkv"], dim=2), "rel_bias": inp["rel_bias"]}

        def call(fn):
            return lambda v: fn(v["qkv"][:, :, 0], v["qkv"][:, :, 1], v["qkv"][:, :, 2],
                                v["rel_bias"], inp["mask"], num_windows=inp["nw"])
        return leaves, call(attention.window_mha), call(attention.window_mha_reference)
    if form == "dwconv_ln":
        leaves = {k: inp[k] for k in ("x", "w", "b", "gamma", "beta")}

        def call(fn):
            return lambda v: fn(v["x"], v["w"], v["b"], v["gamma"], v["beta"])
        return leaves, call(convnext.dwconv_ln), call(convnext.dwconv_ln_reference)
    if form == "token_mlp":
        leaves = {k: inp[k] for k in ("x", "w1", "b1", "w2", "b2")}
        leaves.update(ln_scale=inp["ln"][0], ln_bias=inp["ln"][1])
        packed = (mlp.pack_token_weights(inp["w1"], inp["w2"])
                  if x.dtype == torch.bfloat16 else None)

        def call(fn, **kw):
            return lambda v: fn(v["x"], v["w1"], v["b1"], v["w2"], v["b2"],
                                ln=(v["ln_scale"], v["ln_bias"]), ln_eps=1e-6,
                                residual_input=True, **kw)
        return leaves, call(mlp.token_mlp, packed=packed), call(mlp.token_mlp_reference)
    names = ("g1", "b1", "w1", "g2", "b2", "w2")
    leaves = {"x": x, **dict(zip(names, inp["params"]))}
    kw = inp["kw"]
    shape = {k: kw[k] for k in ("growth", "n_layers", "mid")}
    transposes = ({"w1t": densenet.pack_w1t(inp["params"][2], c0=kw["c0"], **shape),
                   "w2t": densenet.pack_w2t(inp["params"][5], **shape)}
                  if x.dtype == torch.bfloat16 else {})

    def call(fn, **extra):
        return lambda v: fn(v["x"], *(v[k] for k in names), **kw, **extra)
    return leaves, call(densenet.dense_block, **transposes), call(densenet.dense_block_reference)


def through_plain_grad(out: torch.Tensor) -> bool:
    """Whether ``out``'s graph holds a node of ``ops/plain_grad.py``'s
    Function (its backward the plain version's)."""
    seen, stack = set(), [out.grad_fn]
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        if type(fn).__name__.startswith("_PlainGrad"):
            return True
        stack += [nxt for nxt, _ in fn.next_functions]
    return False


def check_grads(form: str, label: str, tag: str, inp: dict, gen) -> dict:
    """One GRAD_CASES check on ``inp``: the gradients of ⟨out, r⟩ (r a
    random cotangent) for the input and every parameter through the
    kernel's wrapper (the kernel forward, the plain backward:
    ``ops/plain_grad.py``) against the plain version's own autograd on the
    same inputs, each within ``agree``'s bound on its largest value; checks
    that the wrapper launched its kernel and that the output's graph runs
    through the Function. Returns the kernels line's row."""
    dtype = inp["x"].dtype
    leaves, kernel, plain = grad_calls(form, inp)
    name = FORM_KERNEL.get(form, form)
    counter = wrappers()[name]
    before = counter.launches

    def fresh():
        return {k: v.detach().clone().requires_grad_() for k, v in leaves.items()}

    vk = fresh()
    out = kernel(vk)
    check(counter.launches > before, f"{form} {label} {tag}: {name} was not launched")
    check(through_plain_grad(out),
          f"{form} {label} {tag}: the output's graph has no plain_grad Function")
    cot = torch.randn(out.shape, device="cuda", generator=gen).to(out.dtype)
    gk = torch.autograd.grad(out, list(vk.values()), cot)
    vp = fresh()
    gp = torch.autograd.grad(plain(vp), list(vp.values()), cot)
    floors, own = {}, {}
    if dtype == torch.bfloat16 and form in GRAD_FLOOR_FORMS:
        # the plain version's own bf16 error, and the kernel path's:
        # against the plain autograd in f32 on the same values
        v32 = {k: v.detach().float().requires_grad_() for k, v in leaves.items()}
        g32 = torch.autograd.grad(plain(v32), list(v32.values()), cot.float())
        floors = {leaf: float((b.float() - c).abs().max())
                  for leaf, b, c in zip(vp, gp, g32)}
        own = {leaf: float((a.float() - c).abs().max())
               for leaf, a, c in zip(vk, gk, g32)}
    torch.cuda.synchronize()
    errs, rels = {}, {}
    for leaf, a, b in zip(vk, gk, gp):
        top = float(b.float().abs().max())
        err = float((a.float() - b.float()).abs().max())
        check(top > 0 and math.isfinite(err),
              f"{form} {label} {tag}: d/d{leaf} is zero or not finite")
        bound = max(agree_bound(top, dtype == torch.float32), 2 * floors.get(leaf, 0.0))
        check(err <= bound,
              f"{form} {label} {tag}: d/d{leaf} max|d| {err:.3e} beyond the bound of "
              f"its max {top:.3e}" + (f" and twice the plain version's own bf16 error "
                                      f"{floors[leaf]:.3e}" if floors else ""))
        errs[leaf], rels[leaf] = err, err / top
    worst = max(rels, key=rels.get)
    print(f"[grad {form} {label} {tag}] kernel forward + plain backward vs the plain "
          f"version's autograd: max|d| by input "
          + ", ".join(f"{k} {v:.3e} (rel {rels[k]:.2e})" for k, v in errs.items())
          + f"; worst rel {rels[worst]:.2e} ({worst})"
          + ("; against the plain autograd in f32, the plain version's own bf16 error / "
             "the kernel path's: "
             + ", ".join(f"{k} {v:.3e} / {own[k]:.3e}" for k, v in floors.items())
             if floors else ""))
    row = {"form": form, "shape": f"{label} {'x'.join(map(str, inp['x'].shape))}",
           "max_abs_err": max(errs.values()), "max_rel_err": rels[worst],
           "inputs": list(errs)}
    return row


def phase_grad_kernels(card: str) -> dict:
    """Phase 6a: each GRAD_CASES row on the card in bf16 and f32 through
    :func:`check_grads`. Returns each kernel's figures for the kernels
    line."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = {(form, label): (make, shape) for form, label, _, make, shape in CASES}
    res: dict = {}
    for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        for form, label in GRAD_CASES:
            make, shape = rows[(form, label)]
            inp = make(*shape[:4], dtype, gen, *shape[4:])
            row = check_grads(form, label, tag, inp, gen)
            name = FORM_KERNEL.get(form, form)
            entry = res.setdefault(name, {"route": GRAD_ROUTE[name], "bf16": [], "f32": []})
            entry[tag].append(row)
            del inp
    return res


def phase_model_grads(card: str) -> dict:
    """Phase 6b: the image gradient of the mean cross-entropy
    (``attacks/gradient.py::_ce_grad``) of each GRAD_MODELS model on the
    card against the same model on the CPU, f32, the same weights
    (``probe_init``: bias tables, layer-scale and BatchNorms at a scale that
    reaches the logits), two 224² images; each model's hand kernels
    launched on the card. Targets: cosine ≥ 0.999 and max|Δg| ≤
    1e-2·max|g|. ResNet-50 and DenseNet-121 miss the second; they are held
    to the fixed limits of GRAD_REL_MISSED, and the cause of the miss is
    measured and printed: the CPU's own f32 gradient with its convolutions
    summed in another order (oneDNN off), which must stay within the gap
    recorded beside the limit. A ReLU network's input gradient is
    piecewise: an ulp can switch a ReLU or move a max-pool's argmax, which
    routes a whole upstream gradient elsewhere."""
    from robustart_torch.attacks.gradient import _ce_grad
    from robustart_torch.models import create_classifier

    x = torch.from_numpy(np.random.default_rng(9).uniform(0, 1, (2, IMG, IMG, 3))
                         .astype(np.float32))
    labels = torch.tensor([3, 7])
    out = {}
    for model in GRAD_MODELS:
        gpu = create_classifier(model, seed=1, device="cuda", probe_init=True)
        cpu = create_classifier(model, seed=1, device="cpu", probe_init=True)
        before = {n: fn.launches for n, fn in wrappers().items()}
        a = _ce_grad(gpu, x.cuda(), labels.cuda()).cpu().double()
        launched = {n: fn.launches - before[n] for n, fn in wrappers().items()
                    if fn.launches > before[n]}
        b = _ce_grad(cpu, x, labels).double()

        def compare(g):
            return (float((g * b).sum() / (g.norm() * b.norm())),
                    float((g - b).abs().max() / b.abs().max()))

        cos, rel = compare(a)
        print(f"[grad {model}] input gradient f32, card vs CPU: cosine {cos:.6f}, "
              f"max|dg|/max|g| {rel:.2e} (max|g| {float(b.abs().max()):.3e}); "
              f"kernels launched on the card: {launched or 'none (cuDNN)'} | {card}")
        check(set(PER_FORWARD.get(model, {})) <= set(launched),
              f"{model}: the card's gradient launched {launched}, not its kernels")
        bound, own = GRAD_REL, None
        if rel > GRAD_REL:
            check(model in GRAD_REL_MISSED,
                  f"{model}: input gradient card vs CPU max|dg|/max|g| {rel:.2e} misses "
                  f"{GRAD_REL:g}")
            bound, recorded = GRAD_REL_MISSED[model]
            with torch.backends.mkldnn.flags(enabled=False):
                own_cos, own = compare(_ce_grad(cpu, x, labels).double())
            print(f"[grad {model}] target max|dg| <= {GRAD_REL:g}·max|g| NOT MET ({rel:.2e}); "
                  f"held to its fixed limit {bound:.2e}; cause: the CPU's own f32 gradient "
                  f"with its convolutions in another order (oneDNN off) is {own:.2e} from it "
                  f"(cosine {own_cos:.6f}; recorded {recorded:.2e})")
            check(own <= recorded, f"{model}: the CPU's oneDNN-off gap {own:.2e} exceeds its "
                                   f"recorded {recorded:.2e}")
        check(cos >= GRAD_COSINE and rel <= bound,
              f"{model}: input gradient card vs CPU cosine {cos:.6f}, rel {rel:.2e} "
              f"(bound {bound:.2e})")
        out[model] = {"cosine": cos, "rel": rel, "cpu_reordered_rel": own}
        del gpu, cpu
    return out


def adv_config(model: str, **extra):
    from robustart_torch.core.config import Config

    return Config({
        "model": {"type": model, "dtype": "bf16", "kwargs": {"num_classes": 10}},
        "seed": 0,
        "data": {"read_from": "fake", "fake_size": ADV_LIMIT, "fake_num_classes": 10,
                 "batch_size": ADV_BATCH, "num_workers": 8, "input_size": IMG,
                 "test_resize": 256,
                 "test": {"limit_samples": ADV_LIMIT, "transforms": {"type": "JUSTNORM"}}},
        "saver": {"results_dir": str(RESULTS)},
        **extra,
    })


def phase_adv_solvers(card: str) -> dict:
    """Phase 6c: ``BenchmarkEvalAdvSolver`` on the card (its default
    device), each ADV_MODELS model in bf16 at full width with every
    ADV_ATTACKS attack at eps 8/255, and each ADV_TRANSFER pair (source →
    target), batch 32, 64 images of the fake backend, every count set to 0
    just before the run and read just after: each kernel launched once per
    forward of the path (the target's clean and adversarial forwards and
    each attack step's forward of the source; the plain backwards launch
    none), one result line a sample in each file, AR in
    [0, 100], every adversarial image in the eps box and in [0, 1]. The AR
    of random 10-class models cannot tell a working attack from a broken
    one, so after the counts are read a control holds the attack to its
    work: on the same batches, the source's mean cross-entropy at the
    adversarial images must exceed the clean one by more than twice what a
    random-sign perturbation at the same eps adds (:func:`adv_control`)."""
    from robustart_torch.solvers import BenchmarkEvalAdvSolver

    runs = {}
    budgets = {attack: (eps, steps) for attack, eps, steps in ADV_ATTACKS}
    pairs = ([(m, m, attack) for m in ADV_MODELS for attack, _, _ in ADV_ATTACKS]
             + ADV_TRANSFER)
    for model, tgt, attack in pairs:
        eps, steps = budgets[attack]
        shutil.rmtree(RESULTS, ignore_errors=True)
        solver = BenchmarkEvalAdvSolver(adv_config(model), src_name=model, tgt_name=tgt,
                                        attack=attack, eps=eps)
        seen = {"d": 0.0, "lo": 1.0, "hi": 0.0, "batches": []}
        adversarial = solver.adversarial

        def recording(x01, labels, gen, adversarial=adversarial, seen=seen):
            x_adv = adversarial(x01, labels, gen)
            seen["d"] = max(seen["d"], float((x_adv - x01).abs().max()))
            seen["lo"] = min(seen["lo"], float(x_adv.min()))
            seen["hi"] = max(seen["hi"], float(x_adv.max()))
            seen["batches"].append((x01.clone(), labels.clone(), x_adv.detach().clone()))
            return x_adv

        solver.adversarial = recording
        for fn in wrappers().values():
            fn.launches = 0
        reset_peak()
        t0 = time.time()
        res = solver.evaluate()
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = {name: fn.launches for name, fn in wrappers().items()}
        peak = peak_memory()
        tag = f"{model}@{attack}" if tgt == model else f"{model}->{tgt}@{attack}"
        batches = -(-ADV_LIMIT // ADV_BATCH)
        forwards = batches * (2 + steps)
        for name, n in launches.items():
            # the target's clean and adversarial forwards, the source's steps
            want = batches * (2 * PER_FORWARD.get(tgt, {}).get(name, 0)
                              + steps * PER_FORWARD.get(model, {}).get(name, 0))
            check(n == want, f"{name}: {n} launches on the {tag} path, expected {want}")
            check(n > 0 or name not in ADV_PATH_KERNELS[model] | ADV_PATH_KERNELS[tgt],
                  f"{name} was not launched on the {tag} path")
        for key in ("clean_file", "adv_file"):
            lines = Path(res[key]).read_text().splitlines()
            check(len(lines) == ADV_LIMIT, f"{res[key]}: {len(lines)} lines")
        budget = eps / 255.0
        check(0.0 <= res["AR"] <= 100.0, f"{tag}: AR {res['AR']}")
        check(seen["d"] <= budget + 1e-6 and seen["lo"] >= 0.0 and seen["hi"] <= 1.0,
              f"{tag}: adversarial images max|d| {seen['d']:.4e} (eps {budget:.4e}), "
              f"range [{seen['lo']}, {seen['hi']}]")
        ce = adv_control(solver.src, seen.pop("batches"), budget)
        check(ce["adv"] - ce["clean"] > 2 * max(ce["random"] - ce["clean"], 0.0),
              f"{tag}: the attack does not raise the source's loss: mean CE clean "
              f"{ce['clean']:.4f}, random-sign {ce['random']:.4f}, adversarial "
              f"{ce['adv']:.4f}")
        print(f"[adv {tag}] bf16, B={ADV_BATCH}, {ADV_LIMIT} images, eps 8/255: "
              f"AR={res['AR']:.2f}%, max|x_adv - x| {seen['d']:.5f} (eps {budget:.5f}), "
              f"range [{seen['lo']:.3f}, {seen['hi']:.3f}]; source mean CE clean "
              f"{ce['clean']:.4f}, random-sign control {ce['random']:.4f} (AR "
              f"{ce['random_AR']:.2f}%), adversarial {ce['adv']:.4f}; launches "
              f"{ {k: v for k, v in launches.items() if v} } ({forwards} forwards); "
              f"{ADV_LIMIT / wall:.1f} img/s end to end ({wall:.2f}s); {peak} | {card}")
        runs[tag] = {"launches": launches, "wall": wall, "n_img": ADV_LIMIT,
                     "dense_block_calls": 0, "AR": res["AR"], "solver": solver}
    return runs


def adv_control(clf, batches: list, eps: float) -> dict:
    """The source's mean cross-entropy over ``batches`` of (x01, labels,
    x_adv) at the clean images, at a random-sign perturbation of them by
    ``eps`` (clipped to [0, 1]) and at the adversarial images, and the AR
    that the random-sign images would give (the share of the clean-correct
    samples still correct, in %); bf16 as the solver runs, after the
    launch counts were read."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    sums = {"clean": 0.0, "random": 0.0, "adv": 0.0}
    correct = kept = n = 0
    with torch.inference_mode():
        for x01, labels, x_adv in batches:
            sign = torch.randint(0, 2, x01.shape, device=x01.device, generator=gen) * 2 - 1
            x_rand = (x01 + eps * sign).clamp(0.0, 1.0)
            preds = {}
            for key, x in (("clean", x01), ("random", x_rand), ("adv", x_adv)):
                logits = clf(x).float()
                sums[key] += float(torch.nn.functional.cross_entropy(logits, labels,
                                                                     reduction="sum"))
                preds[key] = logits.argmax(-1)
            ok = preds["clean"] == labels
            correct += int(ok.sum())
            kept += int((ok & (preds["random"] == labels)).sum())
            n += len(labels)
    out = {k: v / n for k, v in sums.items()}
    out["random_AR"] = 100.0 * kept / correct if correct else float("nan")
    return out


def hand_kernels() -> set:
    """The base names of every kernel the port's sources define, from the
    build logs (ptxas names each entry function)."""
    from robustart_torch.ops import build

    return {u.split(":")[0].split("<")[0] for name in build.KERNELS
            for u in ptxas_usage(build.build_log(name))}


def time_adv(card: str, runs: dict) -> dict:
    """Phase 6d: one PGD step (forward + backward of the mean cross-entropy,
    ``_ce_grad``) of each ADV_MODELS model at B=32 bf16 on a pre-staged
    batch, CUDA events, its peak device memory, and its device time split
    by ``torch.profiler`` into the hand kernels' forwards, the rest of the
    forward and the backward (the plain backwards: no hand kernel runs
    there); the solvers' img/s."""
    from robustart_torch.attacks.gradient import _ce_grad
    from robustart_torch.models.layers import full_f32

    hand = hand_kernels()
    gen = torch.Generator(device="cuda").manual_seed(11)
    x = torch.rand((ADV_BATCH, IMG, IMG, 3), device="cuda", generator=gen)
    y = torch.randint(0, 10, (ADV_BATCH,), device="cuda", generator=gen)
    out = {}
    for model in ADV_MODELS:
        clf = runs[f"{model}@pgd_linf"]["solver"].src

        def step():
            return _ce_grad(clf, x, y)

        def forward():
            with torch.enable_grad(), full_f32():
                return clf(x.detach().requires_grad_())

        reset_peak()
        step_ms = cuda_ms(step, 5, warmup=2)
        peak = peak_memory()
        fwd_ms = cuda_ms(forward, 5, warmup=1)
        device_breakdown(step)  # the tracer's start-up
        parts_f, parts_s = device_breakdown(forward), device_breakdown(step)

        def split(parts):
            mine = sum(ms for n, ms in parts if n.split("<")[0] in hand)
            return mine, sum(ms for _, ms in parts)

        hand_f, total_f = split(parts_f)
        hand_s, total_s = split(parts_s)
        top = "; ".join(f"{n} {ms:.3f}" for n, ms in parts_s[:5])
        print(f"[time] {model} one PGD step (forward + backward) bf16, B={ADV_BATCH}: "
              f"{step_ms:.3f} ms (forward with its graph alone {fwd_ms:.3f} ms); device "
              + (f"{total_s:.3f} ms: forward {total_f:.3f} (hand kernels {hand_f:.3f}, the rest "
                 f"{total_f - hand_f:.3f}), backward {total_s - total_f:.3f} (plain; hand "
                 f"kernels in the step's trace {hand_s:.3f}, the forward's); top kernels: {top}"
                 if parts_s else "not measured (no device time in the trace)")
              + f"; the step's {peak} | {card}")
        out[model] = {"step_ms": step_ms, "forward_ms": fwd_ms, "device_ms": total_s or None,
                      "forward_device_ms": total_f or None, "hand_forward_ms": hand_f,
                      "backward_device_ms": (total_s - total_f) if parts_s else None}
        for attack, _, _ in ADV_ATTACKS:
            run = runs[f"{model}@{attack}"]
            print(f"[time] solver end to end, {model} {attack}: {run['n_img']} images in "
                  f"{run['wall']:.2f}s = {run['n_img'] / run['wall']:.1f} img/s | {card}")
    for src, tgt, attack in ADV_TRANSFER:
        run = runs[f"{src}->{tgt}@{attack}"]
        print(f"[time] solver end to end, transfer {src} -> {tgt} {attack}: {run['n_img']} "
              f"images in {run['wall']:.2f}s = {run['n_img'] / run['wall']:.1f} img/s | {card}")
    return out


# phase 6e: AutoAttack (robustart_torch/attacks/autoattack/). (a) card against
# CPU, f32, batch 2, ViT-B/16 at full width, from one injected start (APGD)
# and one injected draw set (Square): each stage's iterations (Square's
# queries)
AA_REFERENCE_MODEL = "vit_b16_224"
AA_REFERENCE_STEPS = {"apgd-ce": 3, "apgd-t": 3, "fab-t": 3, "square": 20}
# the best losses (FAB-T: its norms; Square: the margin at its output)
# within rel AA_REL, the same argmax, and at most AA_IMG_SHARE of image
# values beyond AA_IMG_ATOL (a signed step of a gradient component near 0
# may go the other way, as in phase 6b's attacks)
AA_REL, AA_IMG_ATOL, AA_IMG_SHARE = 1e-3, 1e-6, 0.005
# (b) each stage alone (run_standard_evaluation_individual), bf16, B=32, eps
# 8/255, labels the clean argmax (every sample starts robust), on phase 6c's
# models; budgets cut to fit the smoke's time
AA_BUDGET = {"n_iter": 10, "n_target_classes": 2, "square_n_queries": 500}
AA_STAGES = ["apgd-ce", "apgd-t", "fab-t", "square"]
# the standard cascade's full budget on a batch that stays robust: APGD-CE's
# iterations, APGD-T's (9 targets × 100), FAB-T's (9 × 100), Square's queries
AA_FULL = {"apgd-ce": 100, "apgd-t": 900, "fab-t": 900, "square": 5000}
# (c) the solver with --attack autoattack_linf: ViT-B/16 at the defaults
# (standard, 100 iterations, 9 targets, 5,000 queries), CLIP-L/14
# (clip_eval.sh's model) with AA_BUDGET's cuts
AA_SOLVER_RUNS = [("vit_b16_224", {}), ("clip_vit_l_14", AA_BUDGET)]
AA_EPS = 8 / 255
# the batch of a gradient step timed beside B=32's: the solver's stages run
# on the few samples still robust (about a tenth of a random 10-class batch)
AA_SMALL_BATCH = 4


class Counting(torch.nn.Module):
    """A model whose forwards and backwards are counted where they run: a
    forward each call, a backward each time a gradient reaches the output.
    Kernel launches are then held to forwards × PER_FORWARD."""

    def __init__(self, model):
        super().__init__()
        self.inner = model
        self.forwards = self.backwards = 0

    def forward(self, x):
        self.forwards += 1
        out = self.inner(x)
        if out.requires_grad:
            out.register_hook(self._backward)
        return out

    def _backward(self, grad):
        self.backwards += 1


def phase_aa_reference(card: str) -> None:
    """Phase 6e (a): APGD-CE, APGD-T (DLR-targeted, the rank-0 target),
    FAB-T and Square in Linf on ViT-B/16 at full width, f32, two images,
    on the card (K6 and K7 forward, the plain backward) against the same
    model on the CPU, from one start (APGD) and one draw set (Square) made
    on the host: AA_REFERENCE_STEPS iterations each, held to AA_REL,
    AA_IMG_ATOL and AA_IMG_SHARE and to the same argmax."""
    from robustart_torch.attacks.autoattack import apgd, fab, square
    from robustart_torch.models import create_classifier

    eps = AA_EPS
    gpu = create_classifier(AA_REFERENCE_MODEL, seed=1, device="cuda", probe_init=True)
    cpu = create_classifier(AA_REFERENCE_MODEL, seed=1, device="cpu", probe_init=True)
    rng = np.random.default_rng(21)
    x = torch.from_numpy(rng.uniform(0, 1, (2, IMG, IMG, 3)).astype(np.float32))
    with torch.no_grad():
        logits = cpu(x)
    y, targets = logits.argmax(1), logits.topk(2).indices[:, 1]
    start = torch.clamp(x + eps * torch.from_numpy(rng.uniform(-1, 1, x.shape)
                                                   .astype(np.float32)), 0.0, 1.0)
    steps = AA_REFERENCE_STEPS
    sizes = square.window_sizes("Linf", steps["square"], IMG, IMG, 3)
    draws = square.draw_linf(x, sizes, torch.Generator().manual_seed(22))

    def margin(model, img):
        with torch.no_grad():
            return square.margin_and_ce(model(img), y.to(img.device))[0]

    runs = {
        "apgd-ce": lambda m, d: apgd.apgd_attack(
            m, x.to(d), y.to(d), eps=eps, loss="ce", n_iter=steps["apgd-ce"],
            x_init=start.to(d)),
        "apgd-t": lambda m, d: apgd.apgd_attack(
            m, x.to(d), y.to(d), eps=eps, loss="dlr-targeted", targets=targets.to(d),
            n_iter=steps["apgd-t"], x_init=start.to(d)),
        "fab-t": lambda m, d: fab.fab_attack_targeted(
            m, x.to(d), y.to(d), targets.to(d), eps=eps, n_iter=steps["fab-t"]),
        "square": lambda m, d: (square.square_attack_linf(
            m, x.to(d), y.to(d), eps=eps, n_queries=steps["square"], draws=draws),),
    }
    for stage, run in runs.items():
        before = {n: fn.launches for n, fn in wrappers().items()}
        t0 = time.time()
        got = run(gpu, "cuda")
        torch.cuda.synchronize()
        card_s = time.time() - t0
        launched = {n: fn.launches - before[n] for n, fn in wrappers().items()
                    if fn.launches > before[n]}
        t0 = time.time()
        want = run(cpu, "cpu")
        cpu_s = time.time() - t0
        img, ref = got[0].cpu(), want[0]
        if stage == "square":
            a, b = margin(gpu, got[0]).cpu(), margin(cpu, ref)
        else:
            a, b = got[1].cpu(), want[1]
        check(torch.equal(torch.isfinite(a), torch.isfinite(b)),
              f"6e {stage}: which samples have a finite value differs: {a} vs {b}")
        fin = torch.isfinite(b)
        rel = (float((a[fin] - b[fin]).abs().max() / b[fin].abs().max().clamp(min=1e-30))
               if fin.any() else 0.0)
        share = float(((img - ref).abs() > AA_IMG_ATOL).double().mean())
        with torch.no_grad():
            same = torch.equal(gpu(got[0]).argmax(1).cpu(), cpu(ref).argmax(1))
        print(f"[aa {stage}] ViT-B/16 f32 B=2 card vs CPU, {steps[stage]} "
              f"{'queries' if stage == 'square' else 'iterations'}: "
              f"{'margin' if stage == 'square' else 'norm' if stage == 'fab-t' else 'best loss'}"
              f" card {a.tolist()} CPU {b.tolist()} (rel {rel:.2e}); image values beyond "
              f"{AA_IMG_ATOL:g}: {share:.2e}; same argmax {same}; max|x_adv - x| "
              f"{float((img - x).abs().max()):.5f}; kernels launched on the card {launched}; "
              f"{card_s:.2f}s card, {cpu_s:.2f}s CPU | {card}")
        check(rel <= AA_REL, f"6e {stage}: card vs CPU rel {rel:.2e} beyond {AA_REL:g}")
        check(share <= AA_IMG_SHARE, f"6e {stage}: {share:.2e} of image values differ by more "
                                     f"than {AA_IMG_ATOL:g}")
        check(same, f"6e {stage}: the argmax at the card's output differs from the CPU's")
        check(set(PER_FORWARD[AA_REFERENCE_MODEL]) <= set(launched),
              f"6e {stage}: the card's run launched {launched}, not ViT-B's kernels")
    del gpu, cpu


def phase_aa_stages(card: str) -> dict:
    """Phase 6e (b): each AutoAttack stage alone
    (``run_standard_evaluation_individual``), standard Linf at eps 8/255
    with AA_BUDGET, on each ADV_MODELS model in bf16 at full width, B=32
    random images labelled with the model's clean argmax. The model is
    wrapped in :class:`Counting`; every count is set to 0 just before a
    stage and read just after. Checks: every image in the 1.001·eps box, in
    [0, 1] and finite; each APGD run's losses finite (APGD-T's DLR on a
    bf16 model's logits) and its best loss at least its start's (the
    start drawn here as APGD draws it, from the same stream, and passed as
    ``x_init``; its loss a forward more a run); each sample FAB-T changed
    misclassified within eps; each stage breaks at least the share a
    random-sign perturbation at eps breaks; each kernel launched forwards ×
    PER_FORWARD times and every kernel of the model's path launched. Prints
    ms per APGD and FAB iteration (one backward each) and per Square query,
    each stage's forwards and backwards, the peak memory above the
    resident, and the full standard cascade's time on one robust batch
    reckoned from them (AA_FULL; Square's query timed at the full batch);
    beside them the attack's gradient step at B=32 and at AA_SMALL_BATCH
    and a query's forward, each by CUDA events and in device time."""
    from robustart_torch.attacks.autoattack import AutoAttack, core
    from robustart_torch.attacks.autoattack.apgd import forward_loss, loss_function
    from robustart_torch.attacks.autoattack.square import margin_and_ce
    from robustart_torch.attacks.gradient import _loss_grad
    from robustart_torch.models import create_classifier
    from robustart_torch.models.layers import full_f32

    eps = AA_EPS
    gen = torch.Generator(device="cuda").manual_seed(23)
    real_apgd = core.apgd_attack
    out = {}
    for model in ADV_MODELS:
        clf = Counting(create_classifier(model, seed=0, device="cuda", num_classes=10,
                                         dtype=torch.bfloat16))
        x = torch.rand((ADV_BATCH, IMG, IMG, 3), device="cuda", generator=gen)
        sign = torch.randint(0, 2, x.shape, device="cuda", generator=gen) * 2 - 1
        with torch.no_grad():
            y = clf(x).argmax(1)
            random_share = float((clf((x + eps * sign).clamp(0.0, 1.0)).argmax(1) != y)
                                 .float().mean())
        aa = AutoAttack(clf, norm="Linf", eps=eps, version="standard", device="cuda",
                        **AA_BUDGET)
        starts, stages = [], {}

        def apgd_recording(m, xs, ys, g, *, eps, loss, targets=None, **kw):
            u = torch.rand(xs.shape, generator=g, device=g.device) * 2.0 - 1.0
            x_init = torch.clamp(xs + eps * u, 0.0, 1.0)
            f_start = forward_loss(m, x_init, loss_function(loss, ys, targets))
            x_adv, f_best = real_apgd(m, xs, ys, g, eps=eps, loss=loss, targets=targets,
                                      x_init=x_init, **kw)
            starts.append((f_start, f_best))
            return x_adv, f_best

        run_one = aa.run_standard_evaluation

        def staged(xs, ys, bs=250, attacks_to_run=None):
            (stage,) = attacks_to_run
            for fn in wrappers().values():
                fn.launches = 0
            clf.forwards = clf.backwards = 0
            starts.clear()
            reset_peak()
            torch.cuda.synchronize()
            t0 = time.time()
            x_adv = run_one(xs, ys, bs=bs, attacks_to_run=attacks_to_run)
            torch.cuda.synchronize()
            stages[stage] = {"x_adv": x_adv, "wall": time.time() - t0,
                             "forwards": clf.forwards, "backwards": clf.backwards,
                             "launches": {n: fn.launches for n, fn in wrappers().items()},
                             "peak": peak_memory(), "starts": list(starts)}
            return x_adv

        aa.run_standard_evaluation = staged
        core.apgd_attack = apgd_recording
        try:
            aa.run_standard_evaluation_individual(x, y, bs=ADV_BATCH)
        finally:
            core.apgd_attack = real_apgd
        check(list(stages) == AA_STAGES, f"6e {model}: stages run {list(stages)}")

        def query():
            with torch.no_grad(), full_f32():
                return margin_and_ce(clf.inner(x), y)

        def step(b):
            return lambda: _loss_grad(clf.inner, x[:b], loss_function("ce", y[:b]))

        query_ms, query_dev = cuda_ms(query, 5, warmup=2), device_ms(query, 5)
        steps = {b: (cuda_ms(step(b), 3, warmup=1), device_ms(step(b), 3))
                 for b in (ADV_BATCH, AA_SMALL_BATCH)}
        print(f"[time] {model} bf16, the attack's gradient step (forward + backward, "
              + ", ".join(f"B={b}: {t:.3f} ms, device {_ms(dev)}" for b, (t, dev) in steps.items())
              + f"); a Square query's forward at B={ADV_BATCH}: {query_ms:.3f} ms, device "
              f"{_ms(query_dev)} | {card}")
        total = {"launches": {n: 0 for n in KERNELS}, "dense_block_calls": 0}
        ms = {}
        for stage, st in stages.items():
            tag = f"{model} {stage}"
            x_adv = st["x_adv"]
            d = (x_adv - x).abs().flatten(1).amax(1)
            check(bool(torch.isfinite(x_adv).all()) and float(d.max()) <= eps * 1.001
                  and float(x_adv.min()) >= 0.0 and float(x_adv.max()) <= 1.0,
                  f"6e {tag}: max|x_adv - x| {float(d.max()):.4e} (eps {eps:.4e}), range "
                  f"[{float(x_adv.min())}, {float(x_adv.max())}]")
            for f_start, f_best in st["starts"]:
                # DLR's denominator z_p1 - z_p3 is taken from f32 logits: a
                # bf16 model's tied top logits must not make it 0
                check(bool(torch.isfinite(f_start).all() and torch.isfinite(f_best).all()),
                      f"6e {tag}: an APGD loss is not finite: start {f_start.tolist()}, best "
                      f"{f_best.tolist()}")
                check(bool((f_best >= f_start).all()),
                      f"6e {tag}: an APGD best loss {f_best.tolist()} is below its start's "
                      f"{f_start.tolist()}")
            with torch.no_grad():
                pred = clf.inner(x_adv).argmax(1)
            broken = float((pred != y).float().mean())
            changed = d > 0
            if stage == "fab-t" and bool(changed.any()):
                check(bool((pred[changed] != y[changed]).all())
                      and float(d[changed].max()) <= eps * 1.001,
                      f"6e {tag}: a sample FAB-T changed is classified right or beyond eps")
            check(broken >= random_share,
                  f"6e {tag}: breaks {broken:.3f} of the batch, a random-sign perturbation "
                  f"{random_share:.3f}")
            for name, n in st["launches"].items():
                want = st["forwards"] * PER_FORWARD.get(model, {}).get(name, 0)
                check(n == want, f"6e {tag}: {name} {n} launches, {st['forwards']} forwards "
                                 f"imply {want}")
                check(n > 0 or name not in ADV_PATH_KERNELS[model],
                      f"6e {tag}: {name} was not launched")
                total["launches"][name] += n
            if stage == "square":
                queries = st["forwards"] - 3  # the clean pass, the start, the acceptance
                ms[stage] = st["wall"] * 1e3 / max(queries, 1)
                unit = f"{ms[stage]:.3f} ms a query over {queries} queries (the batch shrinks " \
                       f"as samples fall; a query at B={ADV_BATCH}: {query_ms:.3f} ms)"
            else:
                ms[stage] = st["wall"] * 1e3 / max(st["backwards"], 1)
                unit = f"{ms[stage]:.3f} ms an iteration ({st['backwards']} iterations)"
            print(f"[aa {tag}] bf16 B={ADV_BATCH} eps 8/255 {AA_BUDGET}: {st['wall']:.2f}s, "
                  f"{unit}; {st['forwards']} forwards, {st['backwards']} backwards; broken "
                  f"{broken:.3f} (random-sign {random_share:.3f}); launches "
                  f"{ {k: v for k, v in st['launches'].items() if v} }; {st['peak']} | {card}")
        full = (AA_FULL["apgd-ce"] * ms["apgd-ce"] + AA_FULL["apgd-t"] * ms["apgd-t"]
                + AA_FULL["fab-t"] * ms["fab-t"] + AA_FULL["square"] * query_ms) / 1e3
        print(f"[time] AutoAttack standard on {model}, one robust batch of {ADV_BATCH} (bf16), "
              f"reckoned: {full:.1f}s = {AA_FULL['apgd-ce']} APGD-CE x {ms['apgd-ce']:.3f} ms + "
              f"{AA_FULL['apgd-t']} APGD-T x {ms['apgd-t']:.3f} + {AA_FULL['fab-t']} FAB-T x "
              f"{ms['fab-t']:.3f} + {AA_FULL['square']} Square queries x {query_ms:.3f} | {card}")
        out[f"{model}@autoattack stages"] = total
        del clf, aa, x
    return out


def phase_aa_solver(card: str) -> dict:
    """Phase 6e (c): ``BenchmarkEvalAdvSolver`` with ``--attack
    autoattack_linf`` on the card, each AA_SOLVER_RUNS model in bf16 at
    full width, eps 8/255, batch 32, 64 images of 10 classes (phase 6c's
    ``adv_config``; ``autoattack_kwargs`` as listed), the source and target
    wrapped in :class:`Counting`, every count set to 0 just before the run
    and read just after: each kernel launched forwards × PER_FORWARD, every
    kernel of the path launched, one result line a sample in each file, AR
    in [0, 100], every adversarial image in the 1.001·eps box, in [0, 1]
    and finite. Prints img/s and the robust accuracy after each stage of
    each batch."""
    from robustart_torch.solvers import BenchmarkEvalAdvSolver

    runs = {}
    for model, kw in AA_SOLVER_RUNS:
        shutil.rmtree(RESULTS, ignore_errors=True)
        extra = {"autoattack_kwargs": dict(kw)} if kw else {}
        solver = BenchmarkEvalAdvSolver(adv_config(model, **extra), src_name=model,
                                        tgt_name=model, attack="autoattack_linf", eps=8.0)
        counted = []
        build = solver._build

        def counting_build(name, path, build=build, counted=counted):
            clf = Counting(build(name, path))
            counted.append(clf)
            return clf

        solver._build = counting_build
        seen = {"d": 0.0, "lo": 1.0, "hi": 0.0, "finite": True, "stages": []}
        adversarial = solver.adversarial

        def recording(x01, labels, gen, adversarial=adversarial, seen=seen, solver=solver):
            x_adv = adversarial(x01, labels, gen)
            seen["d"] = max(seen["d"], float((x_adv - x01).abs().max()))
            seen["lo"] = min(seen["lo"], float(x_adv.min()))
            seen["hi"] = max(seen["hi"], float(x_adv.max()))
            seen["finite"] &= bool(torch.isfinite(x_adv).all())
            seen["stages"].append(list(solver.autoattack.stages))
            return x_adv

        solver.adversarial = recording
        for fn in wrappers().values():
            fn.launches = 0
        reset_peak()
        t0 = time.time()
        res = solver.evaluate()
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = {name: fn.launches for name, fn in wrappers().items()}
        peak = peak_memory()
        tag = f"{model}@autoattack_linf"
        (clf,) = counted
        for name, n in launches.items():
            want = clf.forwards * PER_FORWARD.get(model, {}).get(name, 0)
            check(n == want, f"6e {tag}: {name} {n} launches, {clf.forwards} forwards imply "
                             f"{want}")
            check(n > 0 or name not in ADV_PATH_KERNELS[model],
                  f"6e {tag}: {name} was not launched")
        for key in ("clean_file", "adv_file"):
            lines = Path(res[key]).read_text().splitlines()
            check(len(lines) == ADV_LIMIT, f"6e {res[key]}: {len(lines)} lines")
        check(0.0 <= res["AR"] <= 100.0, f"6e {tag}: AR {res['AR']}")
        check(seen["finite"] and seen["d"] <= AA_EPS * 1.001 and seen["lo"] >= 0.0
              and seen["hi"] <= 1.0,
              f"6e {tag}: adversarial images max|d| {seen['d']:.4e} (eps {AA_EPS:.4e}), range "
              f"[{seen['lo']}, {seen['hi']}], finite {seen['finite']}")
        stages = "; ".join(f"batch {i}: " + (", ".join(f"{a} {acc:.2f}% ({s:.2f}s)"
                                                      for a, s, acc in st) or "none robust")
                           for i, st in enumerate(seen["stages"]))
        print(f"[aa solver {tag}] bf16, B={ADV_BATCH}, {ADV_LIMIT} images, eps 8/255, "
              f"{kw or 'defaults (standard: 100 iterations, 9 targets, 5000 queries)'}: "
              f"AR={res['AR']:.2f}%, {ADV_LIMIT / wall:.1f} img/s ({wall:.2f}s); robust "
              f"accuracy after each stage: {stages}; max|x_adv - x| {seen['d']:.5f}; "
              f"{clf.forwards} forwards, {clf.backwards} backwards; launches "
              f"{ {k: v for k, v in launches.items() if v} }; {peak} | {card}")
        runs[tag] = {"launches": launches, "dense_block_calls": 0}
        del solver, counted, clf
    return runs


# phase 7: the natural-noise benchmarks on the shipped ViT-B/16 configs
# (exprs/exp/imagenet-p-loop-mini/config_vit_base.yaml and
# exprs/exp/imagenet-a_o-loop/config_vit_base.yaml: qkv_bias, batch 64,
# 224²), bf16, the fake backend, random weights from seed 0. ImageNet-P
# online on the ten default perturbations at 31 frames, P_VIDEOS videos
# each; ImageNet-A/O at AO_IMAGES images a split and a seeded subset of
# AO_CLASSES classes
NATURAL_MODEL = "vit_base"
NATURAL_BATCH = 64
P_FRAMES = 31
P_VIDEOS = 64
AO_IMAGES = 256
AO_CLASSES = 200
# the warping perturbations (one K2 launch a frame) and those held card
# against CPU over a whole video
P_WARPS = ("motion_blur", "zoom_blur", "translate", "rotate", "tilt", "scale")
P_REFERENCE = ("brightness", "rotate", "gaussian_noise")
NATURAL_PATH_KERNELS = {"warp_bilinear", "motion_taps", "window_block", "mlp"}


def natural_config(**test):
    from robustart_torch.core.config import Config

    return Config({
        "model": {"type": NATURAL_MODEL, "dtype": "bf16",
                  "kwargs": {"qkv_bias": True, "bn": {"use_sync_bn": False, "kwargs": {}}}},
        "seed": 0,
        "data": {
            "read_from": "fake", "fake_size": test.pop("size"), "batch_size": NATURAL_BATCH,
            "num_workers": 8, "input_size": IMG, "test_resize": 256,
            "test": {"sampler": {"type": "distributed"},
                     "evaluator": {"type": "imagenet", "kwargs": {"topk": [1, 5]}}, **test},
        },
        "saver": {"results_dir": str(RESULTS)},
    })


def p_expected_launches(n_batches: int) -> dict:
    """Each kernel's launches in the ImageNet-P run, from the code: K2 one a
    frame of each warping perturbation, K3 snow's frames as
    :func:`corruption_launches` counts them at each frame's severity, K6
    and K7 PER_FORWARD a frame (one forward a frame), K1 none (ImageNet-P's
    noise frames are floored to the uint8 grid, not fused)."""
    from robustart_torch.solvers.imgnet_p_eval_solver import (DEFAULT_PERTURBATIONS,
                                                              frame_severity)

    want = dict.fromkeys(KERNELS, 0)
    for pert in DEFAULT_PERTURBATIONS:
        for f in range(P_FRAMES):
            want["warp_bilinear"] += n_batches * (pert in P_WARPS)
            if pert == "snow":
                want["motion_taps"] += n_batches * corruption_launches(
                    "snow", frame_severity(f, P_FRAMES))["motion_taps"]
    forwards = n_batches * P_FRAMES * len(DEFAULT_PERTURBATIONS)
    for name, n in PER_FORWARD[NATURAL_MODEL].items():
        want[name] = forwards * n
    return want


def phase_natural_kernels(card: str) -> dict:
    """Phase 7 (a): K2 on each warping perturbation's last frame (t = 1) at
    the path's 64 × 224² × 3, bitwise against its plain version (phase 3's
    bound for K2), one launch a call. Returns the inputs by perturbation."""
    from robustart_torch.ops import warp
    from robustart_torch.solvers.imgnet_p_eval_solver import affine_coords

    gen = torch.Generator(device="cuda").manual_seed(7)
    img = torch.rand((NATURAL_BATCH, IMG, IMG, 3), device="cuda", generator=gen)
    inputs = {}
    for pert in P_WARPS:
        sy, sx = affine_coords(pert, P_FRAMES - 1, P_FRAMES, IMG, IMG, "cuda")
        shape = (NATURAL_BATCH, IMG, IMG)
        args = (img, sy.expand(shape).contiguous(), sx.expand(shape).contiguous())
        before = warp.warp_bilinear.launches
        got = warp.warp_bilinear(*args)
        launched = warp.warp_bilinear.launches - before
        torch.cuda.synchronize()
        bitwise = torch.equal(got, warp.warp_bilinear_reference(*args))
        reach = float(torch.maximum((args[1] - torch.arange(IMG, device="cuda").view(IMG, 1))
                                    .abs().max(), (args[2] - torch.arange(IMG, device="cuda"))
                                    .abs().max()))
        print(f"[natural K2 B={NATURAL_BATCH} {IMG}x{IMG}, {pert} frame {P_FRAMES - 1}] "
              f"bitwise={bitwise}, {launched} launch, max displacement {reach:.2f} px")
        check(bitwise, f"warp_bilinear on {pert}'s last frame disagrees with its plain version")
        check(launched == 1, f"warp_bilinear on {pert}: {launched} launches, not 1")
        inputs[pert] = args
    return inputs


def phase_p_reference(card: str) -> None:
    """Phase 7 (b): one ImageNet-P video per perturbation of P_REFERENCE,
    two images, f32, full-width ViT-B/16 (qkv_bias), 31 frames, on the card
    against the CPU: the frames made by ``perturb_frame`` (gaussian_noise's
    draws made on the CPU and injected into both), put on the uint8 grid,
    one forward of the 62 frames: the same predictions, logits within rel
    1e-3."""
    from robustart_torch.models import create_classifier
    from robustart_torch.noise.corruptions import to_unit, uint8_roundtrip
    from robustart_torch.solvers.imgnet_p_eval_solver import NOISE_PERTURBATIONS, perturb_frame

    imgs = torch.from_numpy(np.random.default_rng(8).integers(0, 256, (2, IMG, IMG, 3),
                                                              np.uint8))
    models = {dev: create_classifier(NATURAL_MODEL, seed=1, device=dev, qkv_bias=True)
              for dev in ("cuda", "cpu")}
    g = torch.Generator().manual_seed(9)
    for pert in P_REFERENCE:
        draws = [{"normal": torch.randn((2, IMG, IMG, 3), generator=g)}
                 if pert in NOISE_PERTURBATIONS else {} for _ in range(P_FRAMES)]
        logits, preds = {}, {}
        with torch.inference_mode():
            for dev, clf in models.items():
                x01 = to_unit(imgs.to(dev))
                frames = torch.cat([uint8_roundtrip(perturb_frame(
                    pert, x01, f, P_FRAMES, **{k: v.to(dev) for k, v in draws[f].items()}))
                    for f in range(P_FRAMES)])
                logits[dev] = clf(frames).cpu()
                preds[dev] = logits[dev].argmax(-1).view(P_FRAMES, 2).T
        a, b = logits["cuda"], logits["cpu"]
        err = float((a - b).abs().max()) / float(b.abs().max())
        same = torch.equal(preds["cuda"], preds["cpu"])
        print(f"[natural check] ImageNet-P {pert}, {P_FRAMES} frames x 2 images, f32 "
              f"{NATURAL_MODEL}, card vs CPU: rel max|dlogit|={err:.2e}, predictions equal "
              f"{same}; card predictions {preds['cuda'].tolist()}")
        check(err <= 1e-3 and same, f"ImageNet-P {pert} video disagrees with the CPU ({err})")


def phase_p_solver(card: str) -> dict:
    """Phase 7 (c): ``ImgnetPEvalSolver`` online on the ten default
    perturbations, 31 frames, P_VIDEOS videos each, bf16 ViT-B/16 on the
    card, every count set to 0 just before the run and read just after,
    held to :func:`p_expected_launches`; each line 31 ints in [0, 1000),
    the mFR finite and in [0, 1]. Prints the peak device memory."""
    from robustart_torch.solvers import ImgnetPEvalSolver
    from robustart_torch.solvers.imgnet_p_eval_solver import DEFAULT_PERTURBATIONS

    shutil.rmtree(RESULTS, ignore_errors=True)
    cfg = natural_config(size=P_VIDEOS, imagenet_p_online=True, n_frames=P_FRAMES,
                         limit_samples=P_VIDEOS, transforms={"type": "JUSTNORM"})
    solver = ImgnetPEvalSolver(cfg)  # cuda by default
    solver.build_model(seed=0)
    reset_peak()
    for fn in wrappers().values():
        fn.launches = 0
    t0 = time.time()
    summary = solver.evaluate()
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {name: fn.launches for name, fn in wrappers().items()}
    peak = peak_memory()
    want = p_expected_launches(-(-P_VIDEOS // NATURAL_BATCH))
    for name, n in launches.items():
        print(f"[natural P] {name} launches in the solver run: {n} (expected {want[name]})")
        check(n == want[name], f"ImageNet-P: {name} {n} launches, expected {want[name]}")
        check(n > 0 or name not in NATURAL_PATH_KERNELS,
              f"ImageNet-P: {name} was not launched")
    for pert in DEFAULT_PERTURBATIONS:
        path = RESULTS / pert / "results.txt.all"
        preds = np.array([json.loads(line)["predictions"] for line in
                          path.read_text().splitlines()])
        check(preds.shape == (P_VIDEOS, P_FRAMES) and preds.min() >= 0 and preds.max() < 1000,
              f"{path}: predictions of shape {preds.shape} in [{preds.min()}, {preds.max()}]")
    mfr = summary["Mean"]
    check(list(summary["per_perturbation"]) == list(DEFAULT_PERTURBATIONS),
          f"ImageNet-P flip rates of {list(summary['per_perturbation'])}")
    check(np.isfinite(mfr) and 0.0 <= mfr <= 1.0, f"ImageNet-P mFR {mfr}")
    n_frames = P_VIDEOS * P_FRAMES * len(DEFAULT_PERTURBATIONS)
    print(f"[natural P] {NATURAL_MODEL} bf16 B={NATURAL_BATCH}: mFR={mfr:.4f}, flip rates "
          f"{ {k: round(v, 4) for k, v in summary['per_perturbation'].items()} }; "
          f"{n_frames} img-frames in {wall:.2f}s = {n_frames / wall:.1f} img-frames/s; {peak} "
          f"| {card}")
    return {"launches": launches, "dense_block_calls": 0, "wall": wall, "n_frames": n_frames,
            "solver": solver}


def phase_ao_solver(card: str) -> dict:
    """Phase 7 (d): ``ImgnetAOEvalSolver`` at the A/O config's shape
    (ONECROP from 256, batch 64, bf16 ViT-B/16), AO_IMAGES images a split
    and a subset of AO_CLASSES classes drawn from seed 0, the counts set to
    0 just before the run and read just after (K6 and K7 PER_FORWARD a
    forward: the A pass and two O passes): AO_CLASSES scores an A line,
    top-1 in [0, 100], confidences in (0, 1], AUPR in [0, 100]."""
    from robustart_torch.solvers import ImgnetAOEvalSolver

    shutil.rmtree(RESULTS, ignore_errors=True)
    subset = sorted(np.random.default_rng(0).choice(1000, AO_CLASSES, replace=False).tolist())
    cfg = natural_config(size=AO_IMAGES, class_subset=subset, transforms={"type": "ONECROP"},
                         **{"imagenet_a&o": True})
    solver = ImgnetAOEvalSolver(cfg)
    solver.build_model(seed=0)
    for fn in wrappers().values():
        fn.launches = 0
    t0 = time.time()
    res = solver.evaluate()
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {name: fn.launches for name, fn in wrappers().items()}
    forwards = 3 * -(-AO_IMAGES // NATURAL_BATCH)
    for name, n in launches.items():
        want = forwards * PER_FORWARD[NATURAL_MODEL].get(name, 0)
        print(f"[natural A/O] {name} launches in the solver run: {n} (expected {want})")
        check(n == want, f"ImageNet-A/O: {name} {n} launches, expected {want}")
    lines = [json.loads(line) for line in
             (RESULTS / "imagenet-a" / "results.txt.all").read_text().splitlines()]
    scores = np.array([r["score"] for r in lines])
    check(scores.shape == (AO_IMAGES, AO_CLASSES) and np.isfinite(scores).all(),
          f"ImageNet-A scores of shape {scores.shape}")
    top1 = res["imagenet-a"]["top1"]
    check(0.0 <= top1 <= 100.0, f"ImageNet-A top1 {top1}")
    for split in ("results_in", "results_out"):
        recs = [json.loads(line) for line in
                (RESULTS / "imagenet-o" / f"{split}.txt.all").read_text().splitlines()]
        conf = np.array([c for r in recs for c in r["confidence"]])
        check(conf.shape == (AO_IMAGES,) and (conf > 0).all() and (conf <= 1).all(),
              f"ImageNet-O {split}: {conf.shape} confidences in [{conf.min()}, {conf.max()}]")
    aupr = res["imagenet-o"]["AUPR"]
    check(np.isfinite(aupr) and 0.0 <= aupr <= 100.0, f"ImageNet-O AUPR {aupr}")
    n_img = 3 * AO_IMAGES
    print(f"[natural A/O] {NATURAL_MODEL} bf16 B={NATURAL_BATCH}, {AO_CLASSES} classes: "
          f"ImageNet-A top1={top1:.2f}, ImageNet-O AUPR={aupr:.4f}; {n_img} images (A, O in, "
          f"O out) in {wall:.2f}s = {n_img / wall:.1f} img/s | {card}")
    return {"launches": launches, "dense_block_calls": 0, "wall": wall, "n_img": n_img,
            "solver": solver, "forwards": forwards}


def time_natural(card: str, inputs: dict, p_run: dict, ao_run: dict, rate: float) -> dict:
    """Phase 7 (e), times: K2 on each warping perturbation's last-frame
    coordinates (against its plain version, its byte bound and
    ``grid_sample``); each perturbation's video step, 31 frames of a
    pre-staged batch of 64 (frames, uint8 grid, forward, argmax, one fetch);
    the A step (forward + logits fetched) and the O step (the on-device
    confidence reduction); each solver's rate with the share of its run in
    those steps. Returns K2's numbers on these inputs."""
    import torch.nn.functional as F

    from robustart_torch.noise.corruptions import to_unit, uint8_roundtrip
    from robustart_torch.ops import warp
    from robustart_torch.solvers.imgnet_p_eval_solver import (DEFAULT_PERTURBATIONS,
                                                              affine_coords, perturb_frame,
                                                              video_seed)

    rows = []
    for pert, (img, cy, cx) in inputs.items():
        n_pix = img.numel() // 3
        bnd = (img.numel() * 4 * 2 + n_pix * 4 * 2) / rate * 1e3
        ms = cuda_ms(lambda: warp.warp_bilinear(img, cy, cx), 100)
        dev = device_ms(lambda: warp.warp_bilinear(img, cy, cx))
        if dev is not None and dev < bnd:
            # below the least time the work takes: the trace lost kernels
            print(f"[time] K2 on ImageNet-P {pert}: torch.profiler's {dev:.4f} ms is under "
                  f"the {bnd:.4f} ms bound, an incomplete trace: not measured")
            dev = None
        plain = cuda_ms(lambda: warp.warp_bilinear_reference(img, cy, cx), 5, warmup=1)
        nchw = img.permute(0, 3, 1, 2).contiguous()
        grid = torch.stack([(2 * cx + 1) / IMG - 1, (2 * cy + 1) / IMG - 1], dim=-1)

        def lib_call():
            return F.grid_sample(nchw, grid, mode="bilinear", padding_mode="reflection",
                                 align_corners=False)

        lib_err = float((lib_call().permute(0, 2, 3, 1)
                         - warp.warp_bilinear_reference(img, cy, cx)).abs().max())
        lib = cuda_ms(lib_call, 100) if lib_err <= 1e-4 else None
        print(f"[time] K2 warp_bilinear {NATURAL_BATCH}x{IMG}x{IMG}x3, ImageNet-P {pert} frame "
              f"{P_FRAMES - 1}: {ms:.4f} ms, device {_ms(dev)}, plain {plain:.3f} ms, bound "
              f"{bnd:.4f} ms (bytes), {bnd / ms:.1%} of bound"
              + (f" ({bnd / dev:.1%} by device time)" if dev else "")
              + (f", grid_sample {lib:.4f} ms" if lib is not None else
                 f", grid_sample off by {lib_err:.2e}: not timed")
              + f" | {card}")
        rows.append(dict(input=f"ImageNet-P {pert}, last frame", ms=ms, device_ms=dev,
                         plain_ms=plain, bound_ms=bnd, bound_by="bytes", library_ms=lib))

    solver = p_run["solver"]
    images = torch.randint(0, 256, (NATURAL_BATCH, IMG, IMG, 3), dtype=torch.uint8,
                           device="cuda")
    steps = {}
    with torch.inference_mode():
        for pert in DEFAULT_PERTURBATIONS:
            coords = ({f: affine_coords(pert, f, P_FRAMES, IMG, IMG, "cuda")
                       for f in range(P_FRAMES)} if pert in P_WARPS else {})

            def step(pert=pert, coords=coords):
                gen = torch.Generator(device="cuda").manual_seed(video_seed(0, pert, 0))
                x01 = to_unit(images)
                preds = torch.empty((P_FRAMES, NATURAL_BATCH), dtype=torch.int32,
                                    device="cuda")
                for f in range(P_FRAMES):
                    frame = perturb_frame(pert, x01, f, P_FRAMES, generator=gen,
                                          coords=coords.get(f))
                    preds[f] = solver.predict(uint8_roundtrip(frame))
                return preds.T.cpu()

            steps[pert] = cuda_ms(step, 2, warmup=1)
            print(f"[time] ImageNet-P video step, {pert}: {P_FRAMES} frames x B={NATURAL_BATCH} "
                  f"(frames, uint8 grid, {NATURAL_MODEL} bf16 forward, argmax, one fetch), "
                  f"pre-staged: {steps[pert]:.2f} ms, "
                  f"{P_FRAMES * NATURAL_BATCH / steps[pert] * 1e3:.1f} img-frames/s | {card}")
        fwd = cuda_ms(lambda: solver.predict(to_unit(images)), 10)
        print(f"[time] {NATURAL_MODEL} bf16 forward + argmax alone, B={NATURAL_BATCH}: "
              f"{fwd:.3f} ms; {P_FRAMES} of them {P_FRAMES * fwd:.2f} ms a video step "
              f"| {card}")
    share = sum(steps.values()) * -(-P_VIDEOS // NATURAL_BATCH) / 1e3 / p_run["wall"]
    print(f"[time] ImageNet-P solver end to end: {p_run['n_frames']} img-frames in "
          f"{p_run['wall']:.2f}s = {p_run['n_frames'] / p_run['wall']:.1f} img-frames/s; "
          f"pre-staged video steps {share:.0%} of the run | {card}")

    ao = ao_run["solver"]
    u8 = images.cpu().numpy()
    with torch.inference_mode():
        a_ms = cuda_ms(lambda: ao.eval_fn(u8).cpu(), 10)
        o_ms = cuda_ms(lambda: ao.confidence_stats(u8), 10)
    share = (a_ms + 2 * o_ms) * -(-AO_IMAGES // NATURAL_BATCH) / 1e3 / ao_run["wall"]
    print(f"[time] ImageNet-A step (copy in, bf16 forward, logits out) {a_ms:.3f} ms, "
          f"ImageNet-O step (copy in, forward, softmax max and argmax, 2B numbers out) "
          f"{o_ms:.3f} ms, B={NATURAL_BATCH}; the A/O solver end to end: {ao_run['n_img']} "
          f"images in {ao_run['wall']:.2f}s = {ao_run['n_img'] / ao_run['wall']:.1f} img/s; "
          f"pre-staged steps {share:.0%} of the run | {card}")
    return {"rows": rows, "video_steps_ms": steps}


# phase 8: the float CNN zoo. (name, kwargs, image size, batch) of each
# forward; RepVGG-B3 also in its deploy form
ZOO_FORWARDS = [
    ("mobilenet_v2", {}, IMG, MAIN_BATCH),
    ("mobilenet_v3_large_x1_0", {}, IMG, MAIN_BATCH),
    ("mobilenet_v3_small_x1_0", {}, IMG, MAIN_BATCH),
    ("efficientnet_b0", {}, IMG, MAIN_BATCH),
    ("efficientnet_b7", {}, 600, 32),
    ("regnetx_3200m", {}, IMG, MAIN_BATCH),
    ("regnety_3200m", {}, IMG, MAIN_BATCH),
    ("repvgg_B3", {}, IMG, MAIN_BATCH),
    ("shufflenet_v2_x2_0", {}, IMG, MAIN_BATCH),
    ("googlenet", {}, IMG, MAIN_BATCH),
    ("bignas_resnet18_1555M", {}, IMG, MAIN_BATCH),
]
# card against CPU on two images: f32 within rel 1e-4; bf16 (the body in
# bf16, the head in f32, against the CPU's f32) within rel ZOO_BF16_REL;
# RepVGG's deploy form against its train form on the card, f32, within rel
# ZOO_DEPLOY_REL (the fold rounds each fused weight once)
ZOO_BF16_REL = 1e-1
ZOO_DEPLOY_REL = 1e-3
# (b) the ImageNet-C solver on gaussian_noise: K1 one launch a batch and
# severity, no other kernel
ZOO_C_RUNS = ["efficientnet_b0", "mobilenet_v3_large_x1_0"]
PATH_KERNELS.update({m: {"fused_noise_normalize"} for m in ZOO_C_RUNS})
# (c) cls_solver --evaluate over an eval_list of one name a family
ZOO_EVAL_LIST = ["mobilenet_v2", "mobilenet_v3_large_x1_0", "efficientnet_b3", "regnetx_3200m",
                 "regnety_3200m", "repvgg_B3", "shufflenet_v2_x2_0", "googlenet",
                 "bignas_resnet18_1555M"]
ZOO_EVAL_IMAGES = 256
# (d) ImageNet-S: resnet50_official bf16, every decoder × resize mode
S_MODEL = "resnet50_official"
S_IMAGES = 64


def phase_zoo_forwards(card: str) -> dict:
    """Phase 8 (a): each ZOO_FORWARDS model, random weights from seed 0, on
    the card against the same model on the CPU (f32, two normalized images
    at its size: rel ≤ 1e-4 and the same argmax; bf16 within ZOO_BF16_REL),
    RepVGG-B3's deploy form (``reparameterize``) against its train form on
    the card; then each forward alone at its batch, bf16 and f32, with its
    peak device memory. Returns the bf16 ms by model."""
    from robustart_torch.models import create_classifier
    from robustart_torch.models.repvgg import reparameterize

    def rel(a, b):
        return float((a.float().cpu() - b.float().cpu()).abs().max()) / float(b.abs().max())

    out = {}
    with torch.inference_mode():
        for name, kw, size, batch in ZOO_FORWARDS:
            x2 = torch.randn((2, size, size, 3), generator=torch.Generator().manual_seed(3))
            with torch.inference_mode(False):
                cpu = create_classifier(name, seed=0, device="cpu", **kw)
            ref = cpu.forward_normalized(x2)
            forms = {name: lambda clf: clf}
            if name.startswith("repvgg"):
                def deploy(clf):
                    clf.model = reparameterize(clf.model)
                    return clf

                forms[f"{name}@deploy"] = deploy
            for tag, form in forms.items():
                for dtype in (torch.float32, torch.bfloat16):
                    with torch.inference_mode(False):
                        clf = form(create_classifier(name, seed=0, device="cuda", dtype=dtype,
                                                     **kw))
                    got = clf.forward_normalized(x2.to("cuda", dtype))
                    err = rel(got, ref)
                    same = torch.equal(got.float().cpu().argmax(-1), ref.argmax(-1))
                    bound = 1e-4 if dtype == torch.float32 else ZOO_BF16_REL
                    if tag.endswith("@deploy") and dtype == torch.float32:
                        bound = max(bound, ZOO_DEPLOY_REL)
                    print(f"[zoo check] {tag} {dtype} card vs CPU f32, 2 images {size}px: rel "
                          f"max|dlogit|={err:.2e} (bound {bound:.0e}), argmax equal {same}")
                    check(torch.isfinite(got).all() and err <= bound
                          and (same or dtype != torch.float32),
                          f"{tag} {dtype}: card vs CPU rel {err:.2e}, argmax equal {same}")
                    if tag.endswith("@deploy") and dtype == torch.float32:
                        with torch.inference_mode(False):
                            train = create_classifier(name, seed=0, device="cuda", **kw)
                        d = rel(got, train.forward_normalized(x2.to("cuda")))
                        print(f"[zoo check] {name} deploy vs train form on the card, f32: rel "
                              f"max|dlogit|={d:.2e} (bound {ZOO_DEPLOY_REL:.0e})")
                        check(d <= ZOO_DEPLOY_REL, f"{name}: deploy vs train rel {d:.2e}")
                        del train
                    xn = torch.randn((batch, size, size, 3), device="cuda").to(dtype)
                    reset_peak()
                    iters = 5 if dtype == torch.bfloat16 else 2
                    ms = cuda_ms(lambda: clf.forward_normalized(xn), iters, warmup=1)
                    print(f"[time] {tag} forward alone, {dtype}, B={batch}, {size}px: {ms:.3f} ms, "
                          f"{batch / ms * 1e3:.1f} img/s; {peak_memory()} | {card}")
                    if dtype == torch.bfloat16:
                        out[tag] = ms
                    del clf, xn
            del cpu
    return out


def phase_zoo_eval_list(card: str) -> dict:
    """Phase 8 (c): ``cls_solver --evaluate`` over an ``eval_list`` of one
    name a family (``ZOO_EVAL_LIST``), bf16, fake backend, ONECROP, batch
    MAIN_BATCH, ZOO_EVAL_IMAGES images an entry, each model at its own
    input size (efficientnet_b3 at 300): a ``results.txt.all`` of finite
    logits a entry, top-1 and top-5 in [0, 100], RepVGG in its deploy form,
    no hand-written kernel launched (the zoo's convolutions are cuDNN's).
    Prints each entry's img/s."""
    from robustart_torch.core.config import Config
    from robustart_torch.solvers.cls_solver import eval_list_solvers

    shutil.rmtree(RESULTS, ignore_errors=True)
    cfg = Config({
        "model": {"type": "resnet18", "dtype": "bf16"}, "seed": 0,
        "data": {"read_from": "fake", "fake_size": ZOO_EVAL_IMAGES, "batch_size": MAIN_BATCH,
                 "num_workers": 8, "input_size": IMG, "test_resize": 256,
                 "test": {"transforms": {"type": "ONECROP"}, "sampler": {"type": "distributed"},
                          "evaluator": {"type": "imagenet", "kwargs": {"topk": [1, 5]}}}},
        "eval_list": [{"model": {"type": n}, "saver": {
            "results_path": str(RESULTS / "eval" / n / "results.txt.all")}}
            for n in ZOO_EVAL_LIST],
    })
    rates = {}
    for fn in wrappers().values():
        fn.launches = 0
    for solver in eval_list_solvers(cfg):  # cuda by default
        name = solver.cfg.model.type
        metric = solver.evaluate()
        torch.cuda.synchronize()
        stats = solver.loop_stats
        path = Path(solver.cfg.saver.results_path)
        scores = np.array([json.loads(line)["score"] for line in path.read_text().splitlines()])
        size = solver.cfg.data.input_size
        check(scores.shape == (ZOO_EVAL_IMAGES, 1000) and np.isfinite(scores).all(),
              f"cls_solver {name}: scores of shape {scores.shape}")
        check(all(0.0 <= metric[k] <= 100.0 for k in ("top1", "top5")),
              f"cls_solver {name}: {metric}")
        check(not name.startswith("repvgg") or solver.classifier.model.deploy,
              f"cls_solver {name}: not in its deploy form")
        rates[name] = stats["images"] / stats["seconds"]
        print(f"[zoo cls_solver] {name} bf16 {size}px B={MAIN_BATCH}: top1={metric['top1']:.2f} "
              f"top5={metric['top5']:.2f}, {stats['images']} images in {stats['seconds']:.2f}s = "
              f"{rates[name]:.1f} img/s | {card}")
        del solver
    launched = {n: fn.launches for n, fn in wrappers().items() if fn.launches}
    check(not launched, f"cls_solver over the zoo launched {launched}")
    return rates


def phase_imagenet_s(card: str) -> dict:
    """Phase 8 (d): the fast-IDCT route on this host (no TensorFlow here):
    bitwise Pillow's own RGB decode under the same draft flag on 4:4:4
    JPEGs, different from the accurate decode on 4:2:0 ones; then
    ``MultiEvalDecoderResizeSolver`` on S_MODEL bf16, 3 decoders × 11 resize
    modes on a fake set of S_IMAGES 280×320 JPEGs: 33 combos in the
    summary, S_IMAGES finite 1000-logit lines a combo, Mean, Std and
    ``acc_var_neg`` consistent with the per-combo top-1s. Prints the host's
    seconds per image of each decode and resize against the device's
    seconds per batch."""
    import io

    from PIL import Image

    from robustart_torch.core.config import Config
    from robustart_torch.noise.imagenet_s import (DECODER_TYPES, RESIZE_TYPES,
                                                  decode_fast_idct, ffmpeg_decoder_impl)
    from robustart_torch.solvers import MultiEvalDecoderResizeSolver

    rng = np.random.default_rng(11)
    for h, w in ((37, 53), (224, 320)):
        arr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        for sub in (0, 2):
            buf = io.BytesIO()
            Image.fromarray(arr).save(buf, "JPEG", quality=90, subsampling=sub)
            data = buf.getvalue()
            fast = decode_fast_idct(data)
            accurate = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
            if sub == 0:
                with Image.open(io.BytesIO(data)) as im:
                    im.draft("RGB", im.size)
                    im.decoderconfig = (1, 1)
                    drafted = np.asarray(im)
                same = np.array_equal(fast, drafted)
                print(f"[imagenet-s check] fast-IDCT route vs Pillow's draft-flag RGB decode, "
                      f"4:4:4 {h}x{w}: bitwise {same}; differs from the accurate decode at "
                      f"{(fast != accurate).mean():.1%} of values")
                check(same, f"fast-IDCT route differs from Pillow's draft decode at 4:4:4 {h}x{w}")
            else:
                frac = float((fast != accurate).mean())
                print(f"[imagenet-s check] fast-IDCT route vs the accurate decode, 4:2:0 {h}x{w}: "
                      f"{frac:.1%} of values differ, max|d|={np.abs(fast.astype(int) - accurate).max()}")
                check(frac > 0, f"fast-IDCT route equals the accurate decode at 4:2:0 {h}x{w}")

    shutil.rmtree(RESULTS, ignore_errors=True)
    cfg = Config({
        "model": {"type": S_MODEL, "dtype": "bf16"}, "seed": 0,
        "data": {"read_from": "fake", "fake_size": S_IMAGES, "batch_size": S_IMAGES,
                 "num_workers": 8, "input_size": IMG,
                 "test": {"save_acc_var_neg": True, "fake_root": str(RESULTS / "s_fake")}},
        "saver": {"results_dir": str(RESULTS / "s")},
    })
    solver = MultiEvalDecoderResizeSolver(cfg)  # cuda by default
    solver.build_model(seed=0)
    for fn in wrappers().values():
        fn.launches = 0
    t0 = time.time()
    summary = solver.evaluate()
    torch.cuda.synchronize()
    wall = time.time() - t0
    per = summary["per_combo"]
    combos = [f"{d}/{r}" for d in DECODER_TYPES for r in RESIZE_TYPES]
    check(list(per) == combos, f"ImageNet-S combos {list(per)}")
    for combo in combos:
        lines = (RESULTS / "s" / combo / "results.txt.all").read_text().splitlines()
        scores = np.array([json.loads(line)["score"] for line in lines])
        check(scores.shape == (S_IMAGES, 1000) and np.isfinite(scores).all(),
              f"ImageNet-S {combo}: scores of shape {scores.shape}")
    vals = np.array(list(per.values()))
    check(np.isclose(summary["Mean"], vals.mean()) and np.isclose(summary["Std."], vals.std())
          and np.isclose(summary["acc_var_neg"], -vals.var())
          and ((vals >= 0) & (vals <= 100)).all(), f"ImageNet-S summary {summary}")
    check(summary["ffmpeg_decoder_impl"] == ffmpeg_decoder_impl(),
          f"ImageNet-S ffmpeg axis {summary['ffmpeg_decoder_impl']}")
    launched = {n: fn.launches for n, fn in wrappers().items() if fn.launches}
    check(not launched, f"ImageNet-S launched {launched}")
    t = solver.timings
    n_img = S_IMAGES * len(combos)
    dev = np.array(t["device_batch_s"])
    print(f"[imagenet-s] {S_MODEL} bf16: {len(per)} combos, Mean={summary['Mean']:.3f} "
          f"Std.={summary['Std.']:.3f} acc_var_neg={summary['acc_var_neg']:.4f}, ffmpeg axis "
          f"{summary['ffmpeg_decoder_impl']}; {n_img} images in {wall:.2f}s = "
          f"{n_img / wall:.1f} img/s | {card}")
    print(f"[imagenet-s] host seconds per image, decode: "
          + ", ".join(f"{d} {s * 1e3:.3f} ms" for d, s in t["host_decode_s"].items())
          + "; resize (mean over decoders): "
          + ", ".join(f"{r} {np.mean(s) * 1e3:.3f} ms" for r, s in t["host_resize_s"].items())
          + f"; device (copy in, forward, logits out) per batch of {S_IMAGES}: mean "
          f"{dev.mean() * 1e3:.3f} ms over {len(dev)} batches, {dev.mean() / S_IMAGES * 1e3:.4f} "
          f"ms an image | {card}")
    return {"wall": wall, "n_img": n_img}


# -- phase 9: training ------------------------------------------------------------

TRAIN_BATCH = 32
TRAIN_ROOT = ROOT / "build" / "chip_smoke_train"
# (tag, shipped recipe, steps, model.dtype or None, solver entry)
TRAIN_RECIPES = [
    ("augmentation/resnet50", "exprs/nips_benchmark/augmentation/resnet50/config.yaml", 8,
     None, "cls_solver"),
    ("pgd_adv_train/resnet50", "exprs/nips_benchmark/pgd_adv_train/resnet50/config.yaml", 4,
     None, "adv_cls_solver_train_pgd"),
    ("new_adv_train/vit_base", "exprs/nips_benchmark/new_adv_train/vit_base/config.yaml", 4,
     None, "adv_cls_solver_train_pgd_new"),
    ("new_adv_train/vit_base@bf16", "exprs/nips_benchmark/new_adv_train/vit_base/config.yaml", 4,
     "bf16", "adv_cls_solver_train_pgd_new"),
]
TRAIN_EVAL_IMAGES = 256
TRAIN_CPU_IMAGES = 4


def train_config(path: str, steps: int, dtype: str | None, tag: str, batch: int = TRAIN_BATCH):
    """A shipped recipe on the fake backend: its published widths, optimizer,
    schedule, smoothing, mixing, EMA and attack; ``steps`` batches of
    ``batch`` a run (fake_size = steps·batch, lr_scheduler.kwargs.max_epoch
    1: the depth cut), STANDARD at 224², a history line a step."""
    from robustart_torch.core.config import load_config

    cfg = load_config(ROOT / path)
    cfg.data.update(read_from="fake", fake_size=steps * batch, fake_num_classes=1000,
                    batch_size=batch, num_workers=8)
    cfg.lr_scheduler.kwargs.max_epoch = 1
    cfg.saver.update(print_freq=1, val_freq=10**6, save_dir=str(TRAIN_ROOT / tag),
                     results_path=str(TRAIN_ROOT / tag / "results.txt.all"))
    if dtype:
        cfg.model.dtype = dtype
    return cfg


def train_solver(entry: str, cfg, device: str = "cuda"):
    """The recipe's solver, by the entry its run.sh names."""
    from robustart_torch.solvers.adv_cls_solver_train_pgd import AdvClsSolverTrainPGD
    from robustart_torch.solvers.cls_solver import ClsSolver

    cls = ClsSolver if entry == "cls_solver" else AdvClsSolverTrainPGD
    return cls(cfg, device=device)


def train_history(tag: str) -> list:
    path = TRAIN_ROOT / tag / "train_history.jsonl"
    return [json.loads(line) for line in path.read_text().splitlines()]


def forwards_a_step(cfg) -> int:
    """The model forwards of one training step: the train forward and one a
    step of the in-step attack."""
    adv = cfg.get("adv_train") or {}
    return 1 + (int((adv.get("kwargs") or {}).get("steps", 0)) if adv.get("enable") else 0)


def step_parts(solver, batch) -> dict:
    """One step's pieces on a staged batch, as ``ClsSolver.train_step``
    runs them: the attack, the train forward, forward + backward, and the
    optimizer's update with the EMA, each a callable."""
    from robustart_torch.attacks.gradient import ATTACKS
    from robustart_torch.models.classifier import StepAttackView
    from robustart_torch.models.layers import full_f32, normalize_jit
    from robustart_torch.ops.image import div_const
    from robustart_torch.solvers.optim import ema_update, one_hot_smooth, smoothed_cross_entropy

    clf, cfg = solver.classifier, solver.cfg
    levels = torch.from_numpy(batch.image).cuda().float()
    x = div_const(levels, 255.0)
    y = torch.from_numpy(batch.label).cuda().long()
    soft = one_hot_smooth(y, clf.num_classes, 0.1)
    xn = normalize_jit(x, clf.mean, clf.std, levels)
    params = solver.params
    adv = cfg.get("adv_train") or {}

    gen = torch.Generator(device="cuda").manual_seed(0)

    def attack():
        clf.model.eval()
        out = ATTACKS[adv["attack"]](StepAttackView(clf), x, y, gen, **adv["kwargs"])
        for p in params.values():
            p.requires_grad_(True)
        return out

    def forward():
        with torch.enable_grad(), full_f32():
            return smoothed_cross_entropy(clf.forward_train(xn), soft)

    def forward_backward():
        with torch.enable_grad(), full_f32():
            loss = smoothed_cross_entropy(clf.forward_train(xn), soft)
            return torch.autograd.grad(loss, list(params.values()))

    grads = dict(zip(params, forward_backward()))

    def update():
        solver.optimizer.step(params, grads, solver.opt_state)
        if solver.ema:
            ema_update(solver.ema, params, solver.ema_decay)

    parts = {"forward": forward, "forward+backward": forward_backward,
             "optimizer+EMA": update}
    if adv.get("enable"):
        parts["attack"] = attack
    return parts


def phase_train_times(card: str) -> dict:
    """Phase 9, first (device traces late in a run can come back short):
    for each TRAIN_RECIPES row, ms a train step by CUDA events after a
    warm-up on a staged batch, img/s, peak device memory; the device split
    by torch.profiler of the ResNet-50 and ViT-B PGD recipes (the attack,
    the train forward with K6/K7, the backward as forward+backward less the
    forward, the optimizer's update with the EMA); and the loader's host
    seconds a batch under STANDARD."""
    from robustart_torch.data import build_dataloader

    out = {}
    for tag, path, steps, dtype, entry in TRAIN_RECIPES:
        cfg = train_config(path, 2, dtype, tag)
        solver = train_solver(entry, cfg)
        batch = next(iter(solver.prepare_train()["loader"]))
        reset_peak()
        ms = cuda_ms(lambda: solver.train_step(batch.image, batch.label), iters=3, warmup=2)
        peak = peak_memory()
        rate = TRAIN_BATCH / ms * 1e3
        print(f"[time] train step {tag}: {ms:.3f} ms at B={TRAIN_BATCH}, 224², "
              f"{forwards_a_step(cfg)} forwards a step = {rate:.1f} img/s; {peak} | {card}")
        row = {"ms": ms, "img_s": rate}
        if dtype is None and entry != "cls_solver":
            parts = step_parts(solver, batch)
            dev = {name: device_ms(fn, iters=2) for name, fn in parts.items()}
            whole = device_ms(lambda: solver.train_step(batch.image, batch.label), iters=2)
            if None in dev.values() or whole is None:
                print(f"[time] train step {tag}: device split not measured (the trace held "
                      f"no device time) | {card}")
            else:
                dev["backward"] = dev.pop("forward+backward") - dev["forward"]
                print(f"[time] train step {tag} device split (torch.profiler, ms a step): "
                      + ", ".join(f"{k} {v:.3f}" for k, v in dev.items())
                      + f"; whole step {whole:.3f} device ms against {ms:.3f} by events | {card}")
                row["device"] = {**dev, "step": whole}
        out[tag] = row
        del solver
    cfg = train_config(TRAIN_RECIPES[0][1], 4, None, "loader")
    loader = build_dataloader(cfg.data, "train", seed=0)
    t0 = time.perf_counter()
    n = sum(1 for _ in loader)
    host = (time.perf_counter() - t0) / n
    print(f"[time] train loader, STANDARD at 224², {TRAIN_BATCH} images a batch, "
          f"{cfg.data.num_workers} threads: {host:.3f} host s a batch ({n} batches) | {card}")
    out["loader_s"] = host
    return out


def phase_train_recipes(card: str) -> dict:
    """Phase 9a: each TRAIN_RECIPES row trained from random weights (seed 0)
    for its steps through the entry its run.sh names, every count set to 0
    just before and read just after: K6 and K7 held to 12 launches a
    forward (the train forward and one a PGD step) on ViT-B, none on
    ResNet-50; every loss finite; then K6 and K7 against their plain
    versions in train mode, forward and every parameter's gradient, on the
    ViT-B recipe's first block at its start, on a step's batch."""
    shutil.rmtree(TRAIN_ROOT, ignore_errors=True)
    runs = {}
    for tag, path, steps, dtype, entry in TRAIN_RECIPES:
        cfg = train_config(path, steps, dtype, tag)
        solver = train_solver(entry, cfg)
        for fn in wrappers().values():
            fn.launches = 0
        reset_peak()
        t0 = time.time()
        solver.train()
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = {name: fn.launches for name, fn in wrappers().items()}
        hist = train_history(tag)
        losses = [h["loss"] for h in hist]
        check(len(hist) == steps and all(math.isfinite(v) for v in losses),
              f"train {tag}: {len(hist)} steps, losses {losses}")
        per_forward = PER_FORWARD["vit_base"] if "vit" in tag else {}
        want = {name: steps * forwards_a_step(cfg) * per_forward.get(name, 0) for name in KERNELS}
        check(launches == want, f"train {tag}: launches {launches}, expected {want}")
        print(f"[train {tag}] {steps} steps at B={TRAIN_BATCH}, 224², {solver.cfg.optimizer.type}"
              f", model.dtype {dtype or 'f32'}: losses {[round(v, 4) for v in losses]}; "
              f"K6/K7 launches {launches['window_block']}/{launches['mlp']} (expected "
              f"{want['window_block']}/{want['mlp']}: {forwards_a_step(cfg)} forwards a step); "
              f"{wall:.1f}s with the loader; {peak_memory()} | {card}")
        runs[tag] = {"launches": launches}
        shutil.rmtree(TRAIN_ROOT / tag, ignore_errors=True)  # its checkpoints: up to 1.4 GB
    # the blocks at the recipe's start (four steps at its lr of 0.1-0.4 take
    # the activations to ~6e3, past what the f32 bound of 1e-5 is set for)
    tag, path, _, _, entry = TRAIN_RECIPES[2]
    vit = train_solver(entry, train_config(path, 1, None, "probe"))
    batch = next(iter(vit.prepare_train()["loader"]))
    train_block_checks(vit, batch)
    return runs


def train_block_checks(solver, batch) -> None:
    """K6 and K7 against their plain versions in train mode on the ViT-B
    of ``solver``: block 0's input from a train forward on the batch, the
    block's own weights, forward and the gradient of every input and
    parameter (``check_grads``), in f32 and bf16."""
    from robustart_torch.models.layers import normalize_jit
    from robustart_torch.ops.image import div_const

    clf = solver.classifier
    blk = clf.model.blocks[0]
    seen = {}
    hook = blk.register_forward_pre_hook(lambda m, a: seen.setdefault("x", a[0].detach()))
    x01 = div_const(torch.from_numpy(batch.image).cuda().float(), 255.0)
    with torch.no_grad():
        clf.forward_train(normalize_jit(x01, clf.mean, clf.std))
    hook.remove()
    gen = torch.Generator(device="cuda").manual_seed(9)
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        x = seen["x"].to(dtype)
        a, m = blk.attn, blk.mlp
        inp = {"x": x, "ln": (blk.norm1.weight.detach(), blk.norm1.bias.detach()), "eps": 1e-6,
               "w": [None, None, None, a.proj.weight.detach().to(dtype)],
               "b": [None, None, None, a.proj.bias.detach()],
               "w_qkv": a.qkv.weight.detach().to(dtype), "b_qkv": a.qkv.bias.detach(),
               "heads": a.num_heads, "rel_bias": None, "mask": None, "nw": 1}
        with torch.no_grad():
            mid = a.forward_fused(x, blk.norm1)
        mlp_inp = {"x": mid, "ln": (blk.norm2.weight.detach(), blk.norm2.bias.detach()),
                   "eps": 1e-6, "w1": m.fc1.weight.detach().to(dtype), "b1": m.fc1.bias.detach(),
                   "w2": m.fc2.weight.detach().to(dtype), "b2": m.fc2.bias.detach()}
        for form, case in (("window_block", inp), ("mlp", mlp_inp)):
            leaves, kernel, plain = grad_calls(form, case)
            with torch.no_grad():
                err = agree(f"train {form} ViT-B block 0 {tag}", kernel(leaves), plain(leaves),
                            gen)
            print(f"[train {form} ViT-B block 0 {tag}] forward against the plain version: "
                  f"max|d| {err:.3e}")
            check_grads(form, "ViT-B train block 0", tag, case, gen)


def _train_one_step(path, dtype, entry, tag, device, draws, start, adv=None, mkldnn=True):
    """One step of a recipe on TRAIN_CPU_IMAGES images on ``device`` from
    the recipe's weights (seed 0), its first batch, the injected mixup /
    cutmix ``draws`` and the attack's ``start``; where ``adv`` is given the
    step trains on it in place of its own attack's output (which is still
    made and returned). Returns (loss, each parameter's update, the first
    moment or None, the attack's output or None)."""
    from robustart_torch.attacks import gradient
    from robustart_torch.solvers import cls_solver, optim

    real_draw, real_attack = cls_solver.draw_mix, gradient.ATTACKS["pgd_linf"]
    made = {}

    def draw_mix(g, b, h, w, ma, ca):
        if ma <= 0 and ca <= 0:
            return None
        return optim.MixDraws(*(getattr(draws, f).to(device) for f in
                                ("perm", "lam_mix", "lam_cut", "use_mix", "cy", "cx")))

    def attack(model, x, y, g=None, **kw):
        made["adv"] = real_attack(model, x, y, None, start=start.to(device), **kw)
        return made["adv"] if adv is None else adv.to(device)

    cls_solver.draw_mix, gradient.ATTACKS["pgd_linf"] = draw_mix, attack
    try:
        cfg = train_config(path, 1, dtype, f"{tag}@{device}", batch=TRAIN_CPU_IMAGES)
        solver = train_solver(entry, cfg, device)
        batch = next(iter(solver.prepare_train()["loader"]))
        before = {k: v.detach().float().cpu().clone() for k, v in solver.params.items()}
        with torch.backends.mkldnn.flags(enabled=mkldnn):
            loss = float(solver.train_step(batch.image, batch.label)["loss"])
    finally:
        cls_solver.draw_mix, gradient.ATTACKS["pgd_linf"] = real_draw, real_attack
    update = {k: v.detach().float().cpu() - before[k] for k, v in solver.params.items()}
    mu = ({k: v.detach().float().cpu() for k, v in solver.opt_state["mu"].items()}
          if "mu" in solver.opt_state else None)
    return loss, update, mu, (made["adv"].detach().cpu() if made else None)


def _update_rels(got: dict, ref: dict, mu: dict | None) -> dict:
    """Each parameter's max|Δ update| over its largest update. Under Adam
    (``mu``, the reference's first moment, given) the first step is
    lr·g/|g|: where |g| is below the two runs' gradient difference its sign
    is the roundoff's, so the update is held where |g| > 1e-3·max|g|."""
    rels = {}
    for k, u in ref.items():
        d = (got[k] - u).abs()
        if mu is not None:
            g = mu[k].abs()
            d = torch.where(g > 1e-3 * g.max(), d, torch.zeros_like(d))
        top = float(u.abs().max())
        if top > 0:
            rels[k] = float(d.max()) / top
    return rels


def _worst(rels: dict) -> str:
    ranked = sorted(rels, key=rels.get, reverse=True)[:3]
    return ", ".join(f"{k} {rels[k]:.2e}" for k in ranked)


def phase_train_reference(card: str) -> None:
    """Phase 9b: one step of each recipe at full width on TRAIN_CPU_IMAGES
    images, the card against the CPU from the same weights, batch, mixup /
    cutmix draws and attack start. The in-step attack's ``sign`` steps part
    where a gradient element is below the two devices' gradient gap, so the
    CPU step trains on the card's adversarial batch; the share of values
    apart from the CPU's own attack is printed, and held to 1% on ViT-B in
    f32 (on ResNet-50 phase 6b holds the input gradient itself; bf16's gap
    is bf16's). f32 (TF32 off): the loss within rel
    1e-4; each parameter's update within 1e-3 of its largest (under AdamW
    where the gradient is not roundoff, and the first moment everywhere).
    A ResNet's update is not continuous (a ReLU or max-pool input within
    the two libraries' roundoff of a kink routes a position's gradient
    elsewhere, and at 4 images layer 4 sums 196 positions): its target of
    1e-3 is printed met or NOT MET and held to three times the CPU's own
    gap, the same step with oneDNN off. bf16: the loss within rel 3e-2."""
    from robustart_torch.solvers import optim

    gen = torch.Generator().manual_seed(17)
    n = TRAIN_CPU_IMAGES
    draws = optim.draw_mix(gen, n, IMG, IMG, 0.2, 1.0)
    start = (torch.rand((n, IMG, IMG, 3), generator=gen) * 2 - 1) * 0.01569
    for tag, path, _, dtype, entry in TRAIN_RECIPES:
        lg, ug, mg, adv = _train_one_step(path, dtype, entry, tag, "cuda", draws, start)
        lc, uc, mc, own_adv = _train_one_step(path, dtype, entry, tag, "cpu", draws, start, adv)
        if adv is not None:
            apart = float(((adv - own_adv).abs() > 1e-6).float().mean())
            held = "vit" in tag and dtype is None
            print(f"[check] train step {tag}: the card's adversarial batch against the CPU's "
                  f"own attack: {apart:.2e} of values apart"
                  + (" (bound 1e-2)" if held else " (not held: a sign step parts wherever |g| "
                     "is below the devices' gradient gap, which phase 6b holds for ResNet-50 "
                     "to GRAD_REL_MISSED, and which in bf16 is bf16's)"))
            check(not held or apart <= 1e-2,
                  f"train {tag}: adversarial batch {apart:.2e} apart card vs CPU")
        loss_rel = abs(lg - lc) / abs(lc)
        bound = 3e-2 if dtype else 1e-4
        check(loss_rel <= bound, f"train {tag}: loss rel {loss_rel:.2e} card vs CPU")
        msg = (f"[check] train step {tag} ({dtype or 'f32'}), card vs CPU on {n} images: "
               f"loss rel {loss_rel:.2e} (bound {bound:.0e})")
        if dtype:
            print(msg + " | " + card)
            continue
        rels = _update_rels(ug, uc, mc)
        worst = max(rels.values())
        if mc is not None:
            mrel = max(float((mg[k] - m).abs().max()) / max(float(m.abs().max()), 1e-30)
                       for k, m in mc.items())
            check(worst <= 1e-3 and mrel <= 1e-3,
                  f"train {tag}: update rel {worst:.2e}, first moment rel {mrel:.2e} card vs CPU")
            print(msg + f"; updates (where |g| > 1e-3 of its max) worst rel {worst:.2e}, first "
                  f"moment worst rel {mrel:.2e} (bound 1e-3) | {card}")
            continue
        _, uo, _, _ = _train_one_step(path, dtype, entry, tag, "cpu", draws, start, adv,
                                      mkldnn=False)
        own = max(_update_rels(uo, uc, None).values())
        met = "met" if worst <= 1e-3 else "NOT MET"
        print(msg + f"; updates worst rel {worst:.2e} ({_worst(rels)}): target 1e-3 {met}; "
              f"the CPU's own gap (oneDNN off) {own:.2e}, held to 3x it | {card}")
        check(worst <= max(1e-3, 3 * own),
              f"train {tag}: update rel {worst:.2e} beyond 3x the CPU's own gap {own:.2e}")


def phase_train_recover(card: str) -> None:
    """Phase 9c: the augmentation recipe for 2 epochs of 2 steps
    uninterrupted, and again from its checkpoint after epoch 0 (``--recover
    ckpt_e1.pth.tar``) in a fresh solver, deterministic algorithms on: the
    recovered steps 3 and 4 equal the uninterrupted ones (losses and every
    parameter, statistic, EMA and moment bitwise)."""
    import os

    tag, path, _, _, entry = TRAIN_RECIPES[0]
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        solvers = {}
        for name in ("whole", "recovered"):
            cfg = train_config(path, 2, None, f"recover/{name}")
            cfg.lr_scheduler.kwargs.max_epoch = 2
            cfg.saver.save_many = True
            solver = train_solver(entry, cfg)
            solver.train(recover=None if name == "whole" else
                         str(TRAIN_ROOT / "recover" / "whole" / "ckpt_e1.pth.tar"))
            solvers[name] = solver
    finally:
        torch.use_deterministic_algorithms(False)
    whole, rec = train_history("recover/whole"), train_history("recover/recovered")
    check([h["step"] for h in rec] == [3, 4] and [h["step"] for h in whole] == [1, 2, 3, 4],
          f"recover: steps {[h['step'] for h in rec]} after {[h['step'] for h in whole]}")
    check([h["loss"] for h in rec] == [h["loss"] for h in whole[2:]],
          f"recover: losses {[h['loss'] for h in rec]} against {whole[2:]}")
    a, b = solvers["whole"].train_payload(2), solvers["recovered"].train_payload(2)
    differ = [k for k in a["model"] if not torch.equal(a["model"][k], b["model"][k])]
    differ += [f"ema {k}" for k in a["ema"] if not torch.equal(a["ema"][k], b["ema"][k])]
    differ += [f"trace {k}" for k in a["optimizer"]["trace"]
               if not torch.equal(a["optimizer"]["trace"][k], b["optimizer"]["trace"][k])]
    check(not differ, f"recover: {len(differ)} tensors differ, e.g. {differ[:3]}")
    print(f"[check] recover {tag}: steps 3-4 from ckpt_e1.pth.tar equal the uninterrupted run "
          f"(losses {[round(h['loss'], 6) for h in rec]}; every parameter, statistic, EMA and "
          f"momentum bitwise) | {card}")


def phase_train_evaluate(card: str) -> None:
    """Phase 9d: the recovered augmentation run's checkpoint through
    ``cls_solver --evaluate`` (``model.use_ema`` unset: the EMA weights are
    taken), TRAIN_EVAL_IMAGES fake images, ONECROP: finite logits, top-1 and
    top-5 in range, the loaded weights the checkpoint's EMA."""
    import yaml

    from robustart_torch.solvers import cls_solver

    ckpt = TRAIN_ROOT / "recover" / "recovered" / "ckpt_e2.pth.tar"
    cfg = train_config(TRAIN_RECIPES[0][1], 1, None, "evaluate")
    cfg.data.update(fake_size=TRAIN_EVAL_IMAGES, batch_size=MAIN_BATCH)
    path = TRAIN_ROOT / "evaluate.yaml"
    path.write_text(yaml.safe_dump(json.loads(json.dumps(cfg))))
    seen = {}
    real = cls_solver.ClsSolver.evaluate

    def evaluate(self, *a, **kw):
        out = real(self, *a, **kw)
        seen["sd"] = {k: v.detach().cpu() for k, v in self.classifier.model.state_dict().items()}
        return out

    cls_solver.ClsSolver.evaluate = evaluate
    try:
        t0 = time.time()
        metric = cls_solver.main(["--config", str(path), "--evaluate", "--ckpt-filePath",
                                  str(ckpt)])
        wall = time.time() - t0
    finally:
        cls_solver.ClsSolver.evaluate = real
    lines = Path(cfg.saver.results_path).read_text().splitlines()
    scores = np.array([json.loads(line)["score"] for line in lines])
    check(scores.shape == (TRAIN_EVAL_IMAGES, 1000) and np.isfinite(scores).all(),
          f"evaluate: scores of shape {scores.shape}")
    check(all(0.0 <= metric[k] <= 100.0 for k in ("top1", "top5")), f"evaluate: {metric}")
    ema = torch.load(ckpt, map_location="cpu", weights_only=False)["ema"]
    check(all(torch.equal(seen["sd"][k], v) for k, v in ema.items()),
          "evaluate: the weights evaluated are not the checkpoint's EMA")
    print(f"[train evaluate] {ckpt.name} with its EMA (use_ema auto): top1={metric['top1']:.2f} "
          f"top5={metric['top5']:.2f} on {TRAIN_EVAL_IMAGES} images, {wall:.1f}s | {card}")


def phase(name: str, fn, *args, **kw):
    """Run one phase and print the seconds it took."""
    t = time.time()
    out = fn(*args, **kw)
    print(f"[phase] {name}: {time.time() - t:.1f}s", flush=True)
    return out


def main() -> int:
    t_start = time.time()
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
        phase("2 build", phase_build)
        k1_res = phase("3 K1", phase_k1, k1, card)
        new = phase("3 K2-K5", phase_new_kernels, card)
        blk = phase("3 K6-K12", phase_block_kernels, card)
        main_run = phase("4 resnet50_official solver", phase_main_path, card)
        vit_run = phase("4 vit_base solver", phase_main_path, card, "vit_base", VIT_CORRUPTIONS)
        deit_run = phase("4 deit_tiny_b16_224 solver", phase_main_path, card,
                         "deit_tiny_b16_224", DEIT_CORRUPTIONS)
        gaussian_runs = {m: phase(f"4 {m} solver", phase_main_path, card, m, ["gaussian_noise"])
                         for m in GAUSSIAN_MODELS}
        zoo_runs = {m: phase(f"4 {m} solver", phase_main_path, card, m, ["gaussian_noise"],
                             size=size, batch=batch) for m, size, batch in ZOO_RUNS}
        phase("4b corruption chains", phase_reference_check, card)
        phase("4b ViT chains", phase_vit_reference_check, card)
        phase("4b model chains", phase_model_reference_check, card)
        phase("4b bf16 chains", phase_bf16_chain_checks, card)
        int8_models = phase("4 int8 checks", phase_int8_checks, card)
        phase("4c int8 zoo", phase_int8_zoo, card)
        int8_runs = {m: phase(f"4 {m} int8 solver", phase_main_path, card, m, c, int8=True)
                     for m, c in INT8_RUNS.items()}
        grads = phase("6a kernel gradients", phase_grad_kernels, card)
        phase("6b model gradients", phase_model_grads, card)
        adv_runs = phase("6c adversarial solvers", phase_adv_solvers, card)
        rate = hbm_rate(torch.cuda.get_device_name(0))
        times = phase("5 K1-K5 times", time_kernels, card, k1_res, new, rate)
        times.update(phase("5 K6-K12 times", time_block_kernels, card, blk, rate))
        phase("5 resnet50 path times", time_path, card, main_run)
        phase("5 vit path times", time_vit_path, card, vit_run, deit_run)
        paths = phase("5 model path times", time_gaussian_path, card,
                      {**gaussian_runs, **zoo_runs})
        paths.pop("forwards")
        times["dwconv_ln"].update(paths)
        phase("5 int8 times", time_int8, card, int8_models, int8_runs)
        phase("6d adversarial times", time_adv, card, adv_runs)
        # phase 7 before 6e: late in a run torch.profiler's traces of the
        # card can come back empty or short, and phase 7 reads device times
        natural = phase("7 natural-noise K2", phase_natural_kernels, card)
        phase("7 ImageNet-P card vs CPU", phase_p_reference, card)
        p_run = phase("7 ImageNet-P solver", phase_p_solver, card)
        ao_run = phase("7 ImageNet-A/O solver", phase_ao_solver, card)
        natural = phase("7 natural-noise times", time_natural, card, natural, p_run, ao_run,
                        rate)
        times["warp_bilinear"]["inputs"] += natural["rows"]
        phase("6e AutoAttack card vs CPU", phase_aa_reference, card)
        aa_runs = phase("6e AutoAttack stages", phase_aa_stages, card)
        aa_runs.update(phase("6e AutoAttack solver", phase_aa_solver, card))
        phase("8a zoo forwards", phase_zoo_forwards, card)
        zoo_c_runs = {m: phase(f"8b {m} solver", phase_main_path, card, m, ["gaussian_noise"])
                      for m in ZOO_C_RUNS}
        for m, run in zoo_c_runs.items():
            print(f"[time] solver end to end, {m}: {run['n_img']} corrupted images in "
                  f"{run['wall']:.2f}s = {run['n_img'] / run['wall']:.1f} img/s | {card}")
        phase("8c zoo cls_solver eval_list", phase_zoo_eval_list, card)
        phase("8d ImageNet-S", phase_imagenet_s, card)
        phase("9 train times", phase_train_times, card)
        train_runs = phase("9a training recipes", phase_train_recipes, card)
        phase("9b train card vs CPU", phase_train_reference, card)
        phase("9c train recover", phase_train_recover, card)
        phase("9d train evaluate", phase_train_evaluate, card)
    except Failed as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(RESULTS, ignore_errors=True)
        shutil.rmtree(TRAIN_ROOT, ignore_errors=True)

    errs = {"fused_noise_normalize": k1_res["max_abs_err"], **new["max_abs_err"],
            **blk["max_abs_err"]}
    # each kernel's launches in its own paths' runs: K1-K5 on ResNet-50, the
    # model kernels summed over the model runs; every kernel's by model
    launches = dict(main_run["launches"])
    # K1's also on the zoo's ImageNet-C runs (phase 8b)
    launches["fused_noise_normalize"] += sum(run["launches"]["fused_noise_normalize"]
                                             for run in zoo_c_runs.values())
    model_runs = {"vit_base": vit_run, "deit_tiny_b16_224": deit_run, **gaussian_runs,
                  **zoo_runs}
    runs = {"resnet50_official": main_run, **model_runs,
            **{f"{m}@int8": run for m, run in int8_runs.items()}, **adv_runs, **aa_runs,
            f"imagenet_p@{NATURAL_MODEL}": p_run, f"imagenet_a_o@{NATURAL_MODEL}": ao_run,
            **zoo_c_runs, **{f"train@{tag}": run for tag, run in train_runs.items()}}
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
            **({"grad": grads[name]} if name in grads else {}),
        }
        for name, (source, replaces) in KERNELS.items()
    ]}))
    print(f"[phase] all: {time.time() - t_start:.1f}s")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
