"""``adv_cls_solver_train_pgd_new``: the same solver as
``adv_cls_solver_train_pgd``, launched with the AdamW + ``no_wd`` recipe
(the recipe lives in the YAML, not the code), as in the JAX package::

    python -m robustart_torch.solvers.adv_cls_solver_train_pgd_new --config config.yaml
"""

from robustart_torch.solvers.adv_cls_solver_train_pgd import AdvClsSolverTrainPGD, main

__all__ = ["AdvClsSolverTrainPGD", "main"]

if __name__ == "__main__":
    main(description="robustart adv_cls_solver_train_pgd_new")
