"""Solvers (counterpart of ``robustart_tpu.solvers``: the ImageNet-C loop
and the adversarial benchmark).

``python -m robustart_torch.solvers.multi_eval_solver --config config.yaml``
runs the ImageNet-C benchmark on the GPU, ``python -m
robustart_torch.solvers.benchmark_eval_adv --config config.yaml --attack
pgd_linf --eps 8`` the adversarial one.
"""

from robustart_torch.solvers.base import ResultWriter, Solver
from robustart_torch.solvers.benchmark_eval_adv import BenchmarkEvalAdvSolver
from robustart_torch.solvers.multi_eval_solver import MultiEvalSolver

__all__ = ["ResultWriter", "Solver", "MultiEvalSolver", "BenchmarkEvalAdvSolver"]
