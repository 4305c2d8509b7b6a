"""``benchmark_eval_adv`` / ``base_benchmark_eval_adv``: the adversarial
benchmark, with src→tgt transfer.

Counterpart of ``robustart_tpu/solvers/benchmark_eval_adv.py``: the same
CLI (``--src_name/--src_path/--tgt_name/--tgt_path/--attack/--eps``, plus
``--device``), config keys and result files. The **src** model makes the
attack and the **tgt** model is evaluated on it (src == tgt: white-box AR;
src != tgt: transfer). Each batch:

1. the clean uint8 batch is copied to the device and divided by 255
   (``x · fl32(1/255)``, the JAX program's arithmetic);
2. the target's clean argmax (inference mode);
3. the attack on the source model (``robustart_torch.attacks``): a forward
   and a backward a step, through the hand kernels' forwards and their
   plain backwards on the card, from a ``torch.Generator`` seeded by (run
   seed, batch index), as the JAX package folds its key; ``autoattack_linf``
   runs ``AutoAttack(src, norm="Linf", eps, version="standard",
   **autoattack_kwargs)`` on the batch (its own seed, 0 unless the config's
   ``autoattack_kwargs`` give one, as in the JAX package), whose images are
   divided by 255 exactly, as the JAX solver divides them on the host for
   this attack;
4. the target's argmax on the adversarial batch (inference mode);
5. ``{"prediction": p, "label": l}`` lines to ``clean/results.txt.all`` and
   ``<attack>_<eps>/results.txt.all``;

and the AR comes from ``AdvRobustEvaluator``. The attack budget grid of
the reference benchmark: fgsm/pgd_linf/mim_linf at eps {0.5, 2, 8}/255,
pgd_l2 at {0.5, 2, 8}, pgd_l1 at {100, 400, 1600}. ``--eps`` is a float,
as in the JAX package, so ``adv_eval/eval.sh``'s ``0.5/255`` is refused by
both. The models come from ``Solver.build_model`` (``model.kwargs`` and
``model.dtype``) and a path's checkpoint; ``model.quantize: int8`` is not
applied, as the JAX package's adversarial solver builds float models.
"""

from __future__ import annotations

import hashlib
import os.path as osp
import time

import numpy as np
import torch

from robustart_torch.attacks import ATTACKS, make_attack_fn
from robustart_torch.attacks.autoattack import AutoAttack
from robustart_torch.core.logging import get_logger
from robustart_torch.data import build_dataloader
from robustart_torch.metrics import AdvRobustEvaluator
from robustart_torch.ops.image import div_const
from robustart_torch.solvers.base import ResultWriter, Solver, standard_solver_argparser

logger = get_logger("robustart.adv_eval")


def normalize_eps(attack: str, eps: float) -> float:
    """Linf budgets are given in 1/255 units on the CLI when above 1."""
    if attack in ("fgsm", "pgd_linf", "mim_linf", "autoattack_linf") and eps > 1:
        return eps / 255.0
    return eps


def attack_config(attack: str, eps: float) -> dict:
    eps = normalize_eps(attack, eps)
    if attack in ("pgd_linf", "pgd_l2"):
        return {"eps": eps, "rel_stepsize": 3 / 40, "steps": 20}
    if attack == "fgsm":
        return {"eps": eps}
    if attack == "mim_linf":
        return {"eps": eps, "num_steps": 20, "step_size": 0.002, "decay_factor": 1.0}
    if attack == "pgd_l1":
        return {"eps": eps, "eps_step": eps * 0.075, "max_iter": 20}
    if attack == "autoattack_linf":
        return {"eps": eps}
    raise ValueError(f"unknown attack {attack!r}")


def batch_seed(run_seed: int, batch_index: int) -> int:
    """32-bit seed of batch ``batch_index``'s random start in a run."""
    digest = hashlib.blake2b(f"{run_seed}/{batch_index}".encode(), digest_size=4).digest()
    return int.from_bytes(digest, "little")


class BenchmarkEvalAdvSolver(Solver):
    def __init__(self, config, src_name=None, src_path=None, tgt_name=None, tgt_path=None,
                 attack="pgd_linf", eps=8.0, device="cuda"):
        if attack not in ATTACKS and attack != "autoattack_linf":
            raise ValueError(f"unknown attack {attack!r}; have {list(ATTACKS)}")
        super().__init__(config, evaluate_only=True, device=device)
        if self.int8:
            logger.warning("model.quantize: int8 is not applied: the attacks differentiate the "
                           "float model, as the JAX package's adversarial solver does")
            self.int8 = False
        self.src_name = src_name or self.cfg.model.type
        self.tgt_name = tgt_name or self.src_name
        self.src_path = src_path
        self.tgt_path = tgt_path
        self.attack = attack
        self.eps = float(eps)
        self.src = self.tgt = None
        self.autoattack = None
        self._attack_fn = None

    def _build(self, name, path):
        clf = self.build_model(seed=0, name=name)
        if path:
            self.load_weights(path)
        return clf

    def adversarial(self, x01: torch.Tensor, labels: torch.Tensor,
                    generator: torch.Generator) -> torch.Tensor:
        """The attack of one batch on the source model (outside inference
        mode: it differentiates)."""
        return self._attack_fn(x01, labels, generator)

    def evaluate(self) -> dict:
        cfg = self.cfg
        self.src = self._build(self.src_name, self.src_path)
        same = self.tgt_name == self.src_name and self.tgt_path == self.src_path
        self.tgt = self.src if same else self._build(self.tgt_name, self.tgt_path)
        tgt = self.tgt
        out_root = cfg.get_path(
            "saver.results_dir", osp.join("results", "adv", f"{self.src_name}_to_{self.tgt_name}"))
        clean_file = osp.join(out_root, "clean", "results.txt.all")
        adv_file = osp.join(out_root, f"{self.attack}_{self.eps:g}", "results.txt.all")
        seed = int(cfg.get("seed", 0))
        loader = build_dataloader(cfg.data, "test", self.rank, self.world_size, seed=seed)
        limit = cfg.get_path("data.test.limit_samples")
        config = attack_config(self.attack, self.eps)
        # per-config hyperparameter overrides: cfg.attack_kwargs merges in
        config.update(dict(cfg.get("attack_kwargs") or {}))
        if self.attack == "autoattack_linf":
            aa = AutoAttack(self.src, norm="Linf", eps=config["eps"], version="standard",
                            device=self.device, **dict(cfg.get("autoattack_kwargs") or {}))
            self.autoattack = aa
            self._attack_fn = lambda x01, labels, generator: aa.run_standard_evaluation(
                x01, labels, bs=x01.shape[0])
        else:
            self._attack_fn = make_attack_fn(self.attack, self.src, **config)

        w_clean = ResultWriter(clean_file, self.rank, self.world_size)
        w_adv = ResultWriter(adv_file, self.rank, self.world_size)
        n = 0
        t0 = time.time()
        for bi, batch in enumerate(loader):
            u8 = torch.from_numpy(batch.image).to(self.device).float()
            x01 = u8 / 255.0 if self.autoattack is not None else div_const(u8, 255.0)
            labels = torch.from_numpy(batch.label.astype(np.int64)).to(self.device)
            gen = torch.Generator(device=self.device).manual_seed(batch_seed(seed, bi))
            with torch.inference_mode():
                clean_pred = tgt(x01).argmax(-1).cpu().numpy()
            x_adv = self.adversarial(x01, labels, gen)
            with torch.inference_mode():
                adv_pred = tgt(x_adv).argmax(-1).cpu().numpy()
            for i in range(len(batch.mask)):
                if batch.mask[i]:
                    label = int(batch.label[i])
                    w_clean.write({"prediction": int(clean_pred[i]), "label": label})
                    w_adv.write({"prediction": int(adv_pred[i]), "label": label})
                    n += 1
            if limit and n >= limit:
                break
        dt = time.time() - t0
        w_clean.close(), w_adv.close()
        clean_merged = w_clean.merge()
        adv_merged = w_adv.merge()
        if self.rank != 0:
            return {}
        ar = AdvRobustEvaluator().eval(clean_merged, adv_merged, num_samples=n)
        logger.info("%s eps=%s src=%s tgt=%s: AR=%.2f%% (%d samples in %.2fs, %.1f img/s)",
                    self.attack, self.eps, self.src_name, self.tgt_name, ar, n, dt,
                    n / max(dt, 1e-9))
        return {"AR": ar, "clean_file": clean_merged, "adv_file": adv_merged}


def main(argv=None):
    parser = standard_solver_argparser("robustart benchmark_eval_adv")
    parser.add_argument("--src_name", default=None)
    parser.add_argument("--src_path", default=None)
    parser.add_argument("--tgt_name", default=None)
    parser.add_argument("--tgt_path", default=None)
    parser.add_argument("--attack", default="pgd_linf",
                        choices=list(ATTACKS) + ["autoattack_linf"])
    parser.add_argument("--eps", type=float, default=8.0)
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; 'cpu' runs the plain versions)")
    args = parser.parse_args(argv)
    solver = BenchmarkEvalAdvSolver(args.config, args.src_name, args.src_path, args.tgt_name,
                                    args.tgt_path, args.attack, args.eps, device=args.device)
    return solver.evaluate()


if __name__ == "__main__":
    main()
