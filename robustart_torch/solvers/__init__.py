"""Solvers (counterpart of ``robustart_tpu.solvers``, the ImageNet-C loop).

``python -m robustart_torch.solvers.multi_eval_solver --config config.yaml``
runs the ImageNet-C benchmark on the GPU.
"""

from robustart_torch.solvers.base import ResultWriter, Solver
from robustart_torch.solvers.multi_eval_solver import MultiEvalSolver

__all__ = ["ResultWriter", "Solver", "MultiEvalSolver"]
