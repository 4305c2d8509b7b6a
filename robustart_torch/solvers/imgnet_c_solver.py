"""Alias of ``multi_eval_solver`` (the reference exposes both the
``imgnet_c_solver`` and ``multi_eval_solver`` names)."""

from robustart_torch.solvers.multi_eval_solver import MultiEvalSolver, main

ImgnetCSolver = MultiEvalSolver

__all__ = ["ImgnetCSolver", "MultiEvalSolver", "main"]

if __name__ == "__main__":
    main()
