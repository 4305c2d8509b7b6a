#!/usr/bin/env python3
"""The natural-noise phase of ``chip_smoke.py`` alone, on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a card:

    python3 -u scripts/probe_torch_natural.py

It prints which of the host libraries the JAX package's ImageNet-S solver
uses (cv2, sklearn, tensorflow, the ``ffmpeg`` binary) this machine has,
then runs ``chip_smoke.py``'s phase 2 (the builds) and phase 7 (K2 on the
ImageNet-P warps' coordinates, ImageNet-P videos card against CPU, the P
and A/O solvers on ViT-B/16 with their launches, and the times), with
the card's name and power limit: ~2 min. Alone, ``torch.profiler``'s
device times of phase 7 are whole; after the whole smoke's earlier phases
its traces of K2 can come back short, and ``chip_smoke.py`` then reports
them as not measured.

It exits non-zero without a card or when a check fails.
"""

from __future__ import annotations

import importlib.util
import shutil
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def host_libraries() -> None:
    for mod in ("cv2", "sklearn", "tensorflow", "PIL", "scipy"):
        present = importlib.util.find_spec(mod) is not None
        version = getattr(__import__(mod), "__version__", "") if present else ""
        print(f"[libs] {mod}: {'present ' + version if present else 'absent'}")
    print(f"[libs] ffmpeg binary: {shutil.which('ffmpeg') or 'absent'}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("probe_torch_natural: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs

    host_libraries()
    card = cs.card_line()
    print(f"[device] {card}; torch {torch.__version__} CUDA {torch.version.cuda}")
    rate = cs.hbm_rate(torch.cuda.get_device_name(0))
    t0 = time.time()
    try:
        cs.phase("2 build", cs.phase_build)
        inputs = cs.phase("7 natural-noise K2", cs.phase_natural_kernels, card)
        cs.phase("7 ImageNet-P card vs CPU", cs.phase_p_reference, card)
        p_run = cs.phase("7 ImageNet-P solver", cs.phase_p_solver, card)
        ao_run = cs.phase("7 ImageNet-A/O solver", cs.phase_ao_solver, card)
        cs.phase("7 natural-noise times", cs.time_natural, card, inputs, p_run, ao_run, rate)
    except cs.Failed as exc:
        print(f"probe_torch_natural: FAILED: {exc}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(cs.RESULTS, ignore_errors=True)
    print(f"[probe] {time.time() - t0:.1f}s | {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
