"""Run ``chip_smoke.py``'s build and phase 8 alone on one NVIDIA GPU: the
fast-IDCT route and the ImageNet-S solver (8d), ``cls_solver`` over the
zoo's ``eval_list`` (8c), the zoo's two ImageNet-C runs (8b) and the zoo's
forwards card vs CPU and timed (8a), each phase's seconds printed.

    python3 -u scripts/probe_torch_zoo.py

About 100 s of command time on an H100; exits 1 on a failed check.
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    card = cs.card_line()
    print(card)
    t = time.time()
    cs.phase("2 build", cs.phase_build)
    try:
        cs.phase("8d ImageNet-S", cs.phase_imagenet_s, card)
        cs.phase("8c zoo cls_solver eval_list", cs.phase_zoo_eval_list, card)
        for m in cs.ZOO_C_RUNS:
            run = cs.phase(f"8b {m} solver", cs.phase_main_path, card, m, ["gaussian_noise"])
            print(f"[zoo] {m}: K1 {run['launches']['fused_noise_normalize']} launches, "
                  f"{run['n_img'] / run['wall']:.1f} img/s | {card}")
        cs.phase("8a zoo forwards", cs.phase_zoo_forwards, card)
    except cs.Failed as exc:
        print(f"FAILED: {exc}", file=sys.stderr)
        return 1
    print(f"[phase] all: {time.time() - t:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
