"""``adv_cls_solver_train_pgd``: PGD adversarial training.

Counterpart of ``robustart_tpu/solvers/adv_cls_solver_train_pgd.py``: the
classification solver with ``adv_train`` enabled, so every training step
first attacks its batch (the model in eval mode) and trains on the
adversarial images. A config without an ``adv_train`` block gets
:data:`DEFAULT_ADV` (eps 4/255, 3 steps of a third of it)::

    adv_train:
        enable: True
        attack: pgd_linf          # any robustart_torch.attacks name
        kwargs: {eps: 0.0157, rel_stepsize: 0.25, steps: 7}

    python -m robustart_torch.solvers.adv_cls_solver_train_pgd --config config.yaml [--device cpu]
"""

from __future__ import annotations

from robustart_torch.core.config import Config, load_config
from robustart_torch.solvers.base import standard_solver_argparser
from robustart_torch.solvers.cls_solver import ClsSolver

DEFAULT_ADV = {
    "enable": True,
    "attack": "pgd_linf",
    # the canonical ImageNet adversarial-training budget
    "kwargs": {"eps": 4 / 255, "rel_stepsize": 1 / 3, "steps": 3},
}


class AdvClsSolverTrainPGD(ClsSolver):
    def __init__(self, config, evaluate_only: bool = False, device="cuda"):
        super().__init__(config, evaluate_only, device=device)
        if "adv_train" not in self.cfg:
            self.cfg.adv_train = Config(DEFAULT_ADV)
        else:
            self.cfg.adv_train.setdefault("enable", True)


def main(argv=None, description: str = "robustart adv_cls_solver_train_pgd"):
    parser = standard_solver_argparser(description)
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; 'cpu' runs the plain versions)")
    args = parser.parse_args(argv)
    solver = AdvClsSolverTrainPGD(load_config(args.config), evaluate_only=args.evaluate,
                                  device=args.device)
    if args.evaluate:
        return solver.evaluate(ckpt_path=args.ckpt_filePath)
    solver.train(recover=args.recover)
    return solver.evaluate()


if __name__ == "__main__":
    main()
