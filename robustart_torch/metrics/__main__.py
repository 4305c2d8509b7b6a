"""Offline metric CLI: ``python -m robustart_torch.metrics <evaluator> ...``.

Every evaluator's ``add_subparser``/``from_args``/``run_from_args`` hooks
under one entry point, as ``python -m robustart_tpu.metrics``:

    python -m robustart_torch.metrics imagenet   --res_file results.txt.all
    python -m robustart_torch.metrics imagenet-c --res_file .../results.txt.all
    python -m robustart_torch.metrics imagenet-a --res_file r1 --res_file r2
    python -m robustart_torch.metrics imagenet-o --res_file_in in --res_file_out out
    python -m robustart_torch.metrics imagenet-p --res_file r --perturbation gaussian_noise
    python -m robustart_torch.metrics imagenet-s --res_file r --decoder_type pil \
        --resize_type pil-bilinear
    python -m robustart_torch.metrics ar   --clean_path clean --adv_path adv
    python -m robustart_torch.metrics wcar --clean_path clean --adv_path a1 --adv_path a2

Each subcommand prints one JSON object with the metrics (the ImageNet-C
evaluator also writes the ``metric`` file beside each result file). It
reads result files only and runs on no device.
"""

from __future__ import annotations

import argparse
import json
import sys

from robustart_torch.metrics.evaluators import (
    AdvRobustEvaluator,
    ImageNetAEvaluator,
    ImageNetCEvaluator,
    ImageNetEvaluator,
    ImageNetOEvaluator,
    ImageNetPEvaluator,
    ImageNetSEvaluator,
    WorstCaseAdvRobustEvaluator,
)

EVALUATORS = {
    "imagenet": ImageNetEvaluator,
    "imagenet-c": ImageNetCEvaluator,
    "imagenet-a": ImageNetAEvaluator,
    "imagenet-o": ImageNetOEvaluator,
    "imagenet-p": ImageNetPEvaluator,
    "imagenet-s": ImageNetSEvaluator,
    "ar": AdvRobustEvaluator,
    "wcar": WorstCaseAdvRobustEvaluator,
}


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m robustart_torch.metrics",
        description="offline metric computation from result files",
    )
    subparsers = parser.add_subparsers(dest="evaluator", required=True)
    for name, cls in EVALUATORS.items():
        cls.add_subparser(name, subparsers)
    args = parser.parse_args(argv)
    evaluator = EVALUATORS[args.evaluator].from_args(args)
    result = evaluator.run_from_args(args)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    sys.exit(0 if main() is not None else 1)
