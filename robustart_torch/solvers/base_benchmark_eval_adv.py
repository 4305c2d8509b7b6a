"""Alias of ``benchmark_eval_adv`` (the reference's ``base_benchmark_eval_adv``,
nips_benchmark/adv_eval/eval.sh:47)."""

from robustart_torch.solvers.benchmark_eval_adv import BenchmarkEvalAdvSolver, main

__all__ = ["BenchmarkEvalAdvSolver", "main"]

if __name__ == "__main__":
    main()
