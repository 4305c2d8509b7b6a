#!/usr/bin/env python3
"""How far the int8 transformer forwards on the card are from the same
forwards on the CPU, site by site, beside the int8 path's own error.

Run from the root of a checkout, on a machine with an NVIDIA GPU:

    python3 scripts/probe_torch_int8.py [--seeds 1 2]

For ViT-B/16, Swin-T and DeiT-Tiny at each weight seed (random weights,
``probe_init``), quantized on the card on 16 random uint8 images and copied
to the CPU (``Int8Model.to``), on the same two random int8 images: every
requantized activation of the card's forward (K8 or K9 on bf16 q/k/v)
against the CPU's (their plain versions), as the share of values that
differ and the most levels they differ by, site after site; the logits'
relative max|Δ| and least cosine; and the CPU int8 forward's own distance
from the float32 forward on the same images.
"""

from __future__ import annotations

import argparse
import contextlib
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


@contextlib.contextmanager
def recorded_requantize(module, seen: list):
    """Append every output of ``module.requantize`` to ``seen``."""
    inner = module.requantize

    def requantize(*args):
        seen.append(inner(*args))
        return seen[-1]

    module.requantize = requantize
    try:
        yield
    finally:
        module.requantize = inner


def compare(a: torch.Tensor, b: torch.Tensor) -> tuple[float, float]:
    """(relative max|a − b| over max|b|, least cosine per row)."""
    rel = float((a - b).abs().max() / b.abs().max())
    cos = float(((a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1))).min())
    return rel, cos


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, nargs="+", default=[1, 2])
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("probe_torch_int8: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from robustart_torch.models import create_classifier, quantize_swin, quantize_vit

    gen = torch.Generator(device="cuda").manual_seed(3)
    calib = torch.randint(0, 256, (16, 224, 224, 3), dtype=torch.uint8, device="cuda",
                          generator=gen).cpu().numpy()
    x = torch.randint(-128, 128, (2, 224, 224, 3), dtype=torch.int8, device="cuda",
                      generator=gen)
    for model, module, quantize in (("vit_base", quantize_vit, quantize_vit.quantize_vit),
                                    ("swin_tiny", quantize_swin, quantize_swin.quantize_swin),
                                    ("deit_tiny_b16_224", quantize_vit,
                                     quantize_vit.quantize_vit)):
        for seed in args.seeds:
            clf = create_classifier(model, seed=seed, device="cuda", probe_init=True)
            seen = {"card": [], "cpu": []}
            with torch.inference_mode():
                q = quantize(clf, calib, calib_batch_size=8)
                qc = q.to("cpu")
                for where, fn, xx in (("card", q, x), ("cpu", qc, x.cpu())):
                    with recorded_requantize(module, seen[where]):
                        seen[where + "_logits"] = fn(xx).cpu()
                ref_f32 = clf.forward(x.float().add(128).div(255)).cpu()
            rel, cos = compare(seen["card_logits"], seen["cpu_logits"])
            rel_f, cos_f = compare(seen["cpu_logits"], ref_f32)
            print(f"[int8 probe] {model} seed {seed}: card vs CPU rel max|dlogit| {rel:.3e}, "
                  f"min cosine {cos:.6f} (max|logit| {float(seen['cpu_logits'].abs().max()):.3f});"
                  f" CPU int8 vs float32 forward rel {rel_f:.3e}, min cosine {cos_f:.6f}")
            pairs = list(zip(seen["card"], seen["cpu"]))
            print(f"[int8 probe]   share of requantized values differing, site by site "
                  f"({len(pairs)} sites): " + " ".join(
                      f"{float((a.cpu() != b).float().mean()):.4f}" for a, b in pairs))
            print("[int8 probe]   most levels differing, site by site: " + " ".join(
                str(int((a.cpu().int() - b.int()).abs().max())) for a, b in pairs))
            del clf, q, qc
    return 0


if __name__ == "__main__":
    sys.exit(main())
