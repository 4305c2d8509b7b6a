"""``imgnet_a_o_eval_solver`` — ImageNet-A accuracy and ImageNet-O OOD dumps.

Counterpart of ``robustart_tpu/solvers/imgnet_a_o_eval_solver.py``: the same
CLI (plus ``--device``), config keys and result files.

- **ImageNet-A** (naturally adversarial, a 200-class subset of the 1k
  space): forward the ``test`` split, keep the logits of
  ``data.test.class_subset`` (a list of class indices, or a file of one
  index a line), write {'score', 'label'} lines to
  ``imagenet-a/results.txt.all`` for :class:`ImageNetAEvaluator`.
- **ImageNet-O** (out of distribution), when ``data.test.imagenet_a&o``,
  ``data.test.imagenet_o`` or ``data.test_out`` is set: dump
  {'confidence', 'correct', 'num_correct'} a batch over ``test``
  (``imagenet-o/results_in.txt.all``), then over ``test_out`` (or ``test``
  again where there is none; ``results_out.txt.all``), for
  :class:`ImageNetOEvaluator`'s AUPR. The max-softmax and the argmax are
  reduced on the device: a batch fetches 2·B numbers, not B × 1000 logits.

The forward is the solver's (``Solver.eval_fn``: the model's kernels on the
card, their plain versions on the CPU).
"""

from __future__ import annotations

import os.path as osp

import numpy as np
import torch

from robustart_torch.core.logging import get_logger
from robustart_torch.data import build_dataloader
from robustart_torch.metrics import ImageNetAEvaluator, ImageNetOEvaluator
from robustart_torch.solvers.base import ResultWriter, Solver, standard_solver_argparser

logger = get_logger("robustart.a_o_eval")


def _load_subset(spec) -> np.ndarray | None:
    """``class_subset`` as class indices: a list, or a file path."""
    if spec is None:
        return None
    if isinstance(spec, str):
        with open(spec) as f:
            return np.array([int(x) for x in f.read().split()], np.int32)
    return np.asarray(list(spec), np.int32)


class ImgnetAOEvalSolver(Solver):
    def evaluate(self, ckpt_path: str | None = None) -> dict:
        cfg = self.cfg
        if self.classifier is None:
            self.build_model(seed=int(cfg.get("seed", 0)))
        if ckpt_path:
            self.load_weights(ckpt_path)
        out_root = cfg.get_path("saver.results_dir", "results/imagenet-a_o")
        test_cfg = cfg.data.get("test", {})
        limit = test_cfg.get("limit_samples")
        results = {}

        subset = _load_subset(test_cfg.get("class_subset"))

        # ImageNet-A: accuracy over the (possibly restricted) label space
        res_a = osp.join(out_root, "imagenet-a", "results.txt.all")
        loader = build_dataloader(cfg.data, "test", self.rank, self.world_size,
                                  seed=int(cfg.get("seed", 0)))
        writer = ResultWriter(res_a, self.rank, self.world_size)

        def record_a(logits, labels, mask):
            scores = logits[:, subset] if subset is not None else logits
            for i in range(len(mask)):
                if mask[i]:
                    yield {"score": scores[i].tolist(), "label": int(labels[i])}

        self.run_eval_loop(loader, writer, record_fn=record_a, limit_samples=limit)
        merged_a = writer.merge()
        if self.rank == 0:
            results["imagenet-a"] = ImageNetAEvaluator().eval(merged_a)
            logger.info("ImageNet-A: %s", results["imagenet-a"])

        # ImageNet-O: confidence dumps of the in-dist and out-dist sets
        o_cfg = test_cfg.get("imagenet_o") or {}
        if o_cfg or test_cfg.get("imagenet_a&o") or cfg.get_path("data.test_out"):
            res_in = osp.join(out_root, "imagenet-o", "results_in.txt.all")
            res_out = osp.join(out_root, "imagenet-o", "results_out.txt.all")
            self._confidence_dump("test", res_in, limit)
            out_split = "test_out" if "test_out" in cfg.data else "test"
            self._confidence_dump(out_split, res_out, limit)
            if self.rank == 0:
                results["imagenet-o"] = ImageNetOEvaluator().eval(
                    res_file_in=res_in, res_file_out=res_out)
                logger.info("ImageNet-O: %s", results["imagenet-o"])
        return results

    @torch.inference_mode()
    def confidence_stats(self, images_u8: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(max softmax probability, argmax of the logits) of a uint8 NHWC
        batch, reduced on the device and fetched in one copy."""
        logits = self.eval_fn(images_u8)
        conf = torch.softmax(logits, dim=-1).amax(dim=-1)
        pred = logits.argmax(dim=-1)
        stats = torch.stack((conf.double(), pred.double())).cpu().numpy()
        return stats[0].astype(np.float32), stats[1].astype(np.int64)

    def _confidence_dump(self, split, res_file, limit):
        loader = build_dataloader(self.cfg.data, split, self.rank, self.world_size,
                                  seed=int(self.cfg.get("seed", 0)))
        writer = ResultWriter(res_file, self.rank, self.world_size)
        n = 0
        for batch in loader:
            conf, pred = self.confidence_stats(batch.image)
            mask = batch.mask
            correct = (pred == batch.label) & mask
            writer.write({
                "confidence": conf[mask].tolist(),
                "correct": correct[mask].astype(int).tolist(),
                "num_correct": int(correct.sum()),
            })
            n += int(mask.sum())
            if limit and n >= limit:
                break
        writer.merge()


def main(argv=None):
    parser = standard_solver_argparser("robustart imgnet_a_o_eval_solver")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; 'cpu' runs the plain versions)")
    args = parser.parse_args(argv)
    solver = ImgnetAOEvalSolver(args.config, evaluate_only=True, device=args.device)
    return solver.evaluate(ckpt_path=args.ckpt_filePath)


if __name__ == "__main__":
    main()
