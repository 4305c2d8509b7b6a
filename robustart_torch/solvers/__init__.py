"""Solvers (counterpart of ``robustart_tpu.solvers``: the ImageNet-C loop,
the natural-noise benchmarks and the adversarial benchmark).

``python -m robustart_torch.solvers.multi_eval_solver --config config.yaml``
(or ``imgnet_c_solver``) runs the ImageNet-C benchmark on the GPU, ``python
-m robustart_torch.solvers.imgnet_p_eval_solver --config config.yaml``
ImageNet-P, ``python -m robustart_torch.solvers.imgnet_a_o_eval_solver
--config config.yaml`` ImageNet-A and -O, ``python -m
robustart_torch.solvers.benchmark_eval_adv --config config.yaml --attack
pgd_linf --eps 8`` the adversarial one.
"""

from robustart_torch.solvers.base import ResultWriter, Solver
from robustart_torch.solvers.benchmark_eval_adv import BenchmarkEvalAdvSolver
from robustart_torch.solvers.imgnet_a_o_eval_solver import ImgnetAOEvalSolver
from robustart_torch.solvers.imgnet_c_solver import ImgnetCSolver
from robustart_torch.solvers.imgnet_p_eval_solver import ImgnetPEvalSolver
from robustart_torch.solvers.multi_eval_solver import MultiEvalSolver

__all__ = ["ResultWriter", "Solver", "MultiEvalSolver", "ImgnetCSolver", "ImgnetPEvalSolver",
           "ImgnetAOEvalSolver", "BenchmarkEvalAdvSolver"]
