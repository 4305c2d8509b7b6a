"""Solvers (counterpart of ``robustart_tpu.solvers``: the ImageNet-C loop,
the natural-noise benchmarks, the ImageNet-S system-noise loop, the
adversarial benchmark and classification evaluation).

``python -m robustart_torch.solvers.multi_eval_solver --config config.yaml``
(or ``imgnet_c_solver``) runs the ImageNet-C benchmark on the GPU, ``python
-m robustart_torch.solvers.imgnet_p_eval_solver --config config.yaml``
ImageNet-P, ``python -m robustart_torch.solvers.imgnet_a_o_eval_solver
--config config.yaml`` ImageNet-A and -O, ``python -m
robustart_torch.solvers.benchmark_eval_adv --config config.yaml --attack
pgd_linf --eps 8`` the adversarial one, ``python -m
robustart_torch.solvers.multi_eval_decoder_resize_solver --config
config.yaml`` ImageNet-S, ``python -m robustart_torch.solvers.cls_solver
--config config.yaml --evaluate`` one model or an ``eval_list``, and
``cls_solver`` without ``--evaluate`` (or ``adv_cls_solver_train_pgd``,
``adv_cls_solver_train_pgd_new`` for PGD adversarial training) trains, then
evaluates.
"""

from robustart_torch.solvers.adv_cls_solver_train_pgd import AdvClsSolverTrainPGD
from robustart_torch.solvers.base import ResultWriter, Solver
from robustart_torch.solvers.benchmark_eval_adv import BenchmarkEvalAdvSolver
from robustart_torch.solvers.cls_solver import ClsSolver
from robustart_torch.solvers.imgnet_a_o_eval_solver import ImgnetAOEvalSolver
from robustart_torch.solvers.imgnet_c_solver import ImgnetCSolver
from robustart_torch.solvers.imgnet_p_eval_solver import ImgnetPEvalSolver
from robustart_torch.solvers.multi_eval_decoder_resize_solver import MultiEvalDecoderResizeSolver
from robustart_torch.solvers.multi_eval_solver import MultiEvalSolver

__all__ = ["ResultWriter", "Solver", "MultiEvalSolver", "ImgnetCSolver", "ImgnetPEvalSolver",
           "ImgnetAOEvalSolver", "BenchmarkEvalAdvSolver", "MultiEvalDecoderResizeSolver",
           "ClsSolver", "AdvClsSolverTrainPGD"]
