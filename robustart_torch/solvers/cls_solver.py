"""``cls_solver``: classification evaluation, one model or an ``eval_list``.

Counterpart of ``robustart_tpu/solvers/cls_solver.py``, its evaluation
(:396-475): the ONECROP test loader, ``data.test.limit_samples``,
``maybe_quantize`` (which gives a RepVGG its deploy form), one
``results.txt.all`` and ``ImageNetEvaluator`` (or ``ImageNetCEvaluator``
under ``data.test.evaluator.type: imagenetc``). ``--ckpt-filePath`` loads a
torch checkpoint (a file, or the newest in a directory) through
``read_torch_checkpoint``; the JAX package reads a torch checkpoint without
``model.use_ema`` too, which selects among the weights of its own msgpack
checkpoints only, and those the port does not read.

``main`` with ``--evaluate`` over a config's ``eval_list`` evaluates each
entry with its own solver, the model at its own input size
(``core/config.py::iter_eval_list``), as the reference batch-evaluates its
zoo (exprs/exp/swin_2/config.yaml, eval.sh):

    python -m robustart_torch.solvers.cls_solver --config config.yaml --evaluate [--device cpu]

Training is not ported: ``ClsSolver.train`` and ``main`` without
``--evaluate`` raise.
"""

from __future__ import annotations

import os
import os.path as osp
import time

from robustart_torch.core.config import Config, iter_eval_list, load_config
from robustart_torch.core.logging import get_logger
from robustart_torch.data import build_dataloader
from robustart_torch.metrics import ImageNetCEvaluator, ImageNetEvaluator
from robustart_torch.solvers.base import ResultWriter, Solver, standard_solver_argparser

logger = get_logger("robustart.cls_solver")

TORCH_CKPT_EXTS = (".pth", ".pth.tar", ".pt", ".bin")
_TRAINING = "training is not ported (ROADMAP.md, modules to port: Training)"


def newest_checkpoint(ckpt_dir: str) -> str:
    """The newest torch checkpoint in a directory, by mtime (JAX
    ``solvers/base.py::newest_checkpoint``, which prefers its own
    ``*.msgpack`` saves: the port refuses a directory that holds them)."""
    names = os.listdir(ckpt_dir)
    if any(f.endswith(".msgpack") for f in names):
        raise NotImplementedError(
            f"{ckpt_dir} holds the JAX package's msgpack checkpoints, which the port does "
            "not read (ROADMAP.md, modules to port: Training); give a torch checkpoint")
    cands = [f for f in names if f.endswith(TORCH_CKPT_EXTS)]
    if not cands:
        raise FileNotFoundError(f"no torch checkpoint in {ckpt_dir}")
    return max((osp.join(ckpt_dir, f) for f in cands), key=osp.getmtime)


class ClsSolver(Solver):
    """Evaluation solver for image classification."""

    def train(self, recover: str | None = None) -> None:
        raise NotImplementedError(_TRAINING)

    def evaluate(self, ckpt_path: str | None = None,
                 results_path: str | None = None) -> dict:
        cfg = self.cfg
        if self.classifier is None:
            self.build_model(seed=int(cfg.get("seed", 0)))
        if ckpt_path:
            if osp.isdir(ckpt_path):
                ckpt_path = newest_checkpoint(ckpt_path)
            if ckpt_path.endswith(".msgpack"):
                raise NotImplementedError(
                    f"{ckpt_path} is a JAX package checkpoint, which the port does not read "
                    "(ROADMAP.md, modules to port: Training)")
            self.load_weights(ckpt_path)

        loader = build_dataloader(cfg.data, "test", self.rank, self.world_size,
                                  seed=int(cfg.get("seed", 0)))
        results_path = results_path or cfg.get_path("saver.results_path",
                                                    "results/results.txt.all")
        self.maybe_quantize(loader)
        writer = ResultWriter(results_path, self.rank, self.world_size)
        t0 = time.perf_counter()
        n = self.run_eval_loop(loader, writer,
                               limit_samples=cfg.get_path("data.test.limit_samples"))
        self.loop_stats = {"images": n, "seconds": time.perf_counter() - t0}
        merged = writer.merge()
        if self.rank != 0:
            return {}
        ev_cfg = cfg.get_path("data.test.evaluator") or Config(
            {"type": "imagenet", "kwargs": {"topk": [1, 5]}})
        kwargs = dict(ev_cfg.get("kwargs") or {})
        evaluator = (ImageNetCEvaluator(**kwargs) if ev_cfg.get("type", "imagenet") == "imagenetc"
                     else ImageNetEvaluator(**kwargs))
        metric = evaluator.eval(merged)
        logger.info("eval metric: %s", metric)
        return dict(metric.metric)


def eval_list_solvers(cfg: Config, device: str = "cuda"):
    """One :class:`ClsSolver` for each entry of the config's ``eval_list``,
    each writing ``results/eval_<i>/results.txt.all`` unless the entry names
    ``saver.results_path``."""
    for i, sub in enumerate(iter_eval_list(cfg)):
        sub["saver"] = sub.get("saver") or {}
        sub.saver.results_path = sub.get_path("saver.results_path",
                                              f"results/eval_{i}/results.txt.all")
        yield ClsSolver(sub, evaluate_only=True, device=device)


def main(argv=None):
    parser = standard_solver_argparser("robustart cls_solver")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; 'cpu' runs the plain versions)")
    args = parser.parse_args(argv)
    if not args.evaluate:
        raise NotImplementedError(_TRAINING)
    cfg = load_config(args.config)
    if cfg.get("eval_list"):
        # batch evaluation of many checkpoints from one config (reference
        # README.md:70-91, exprs/exp/swin/config.yaml:8-10)
        return [solver.evaluate(ckpt_path=args.ckpt_filePath)
                for solver in eval_list_solvers(cfg, args.device)]
    return ClsSolver(cfg, evaluate_only=True, device=args.device).evaluate(
        ckpt_path=args.ckpt_filePath)


if __name__ == "__main__":
    main()
