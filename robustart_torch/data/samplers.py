"""Deterministic shard/epoch index maps — the sampler vocabulary of the
reference config schema: {distributed, distributed_iteration,
ranked_iteration}. Counterpart of ``robustart_tpu/data/samplers.py``: pure
index computations, so the two packages walk a dataset in the same order.
"""

from __future__ import annotations

import numpy as np


def distributed_indices(n: int, rank: int, world_size: int) -> np.ndarray:
    """Non-repeating eval partition (reference 'distributed' sampler):
    rank takes indices rank, rank+W, rank+2W, ... — every sample exactly once
    across ranks, no padding (the loader pads+masks the final batch)."""
    return np.arange(rank, n, world_size)


def distributed_iteration_indices(
    n: int, rank: int, world_size: int, epoch: int, seed: int = 0
) -> np.ndarray:
    """Training sampler (reference 'distributed_iteration'): per-epoch
    deterministic shuffle, padded to a multiple of world_size so every rank
    steps in lockstep, then strided by rank."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, epoch]))
    perm = rng.permutation(n)
    total = ((n + world_size - 1) // world_size) * world_size
    if total > n:
        perm = np.concatenate([perm, perm[: total - n]])
    return perm[rank::world_size]


def ranked_iteration_indices(
    n: int,
    rank: int,
    world_size: int,
    epoch: int,
    seed: int = 0,
    labels: np.ndarray | None = None,
) -> np.ndarray:
    """Class-ranked iteration sampler (reference 21k_resnet50/config.yaml:53).
    With labels the shuffle is stratified so each rank sees a class-balanced
    stream; otherwise it is distributed_iteration."""
    if labels is None:
        return distributed_iteration_indices(n, rank, world_size, epoch, seed)
    labels = np.asarray(labels)
    rng = np.random.default_rng(np.random.SeedSequence([seed, epoch, 21]))
    # sort by label, shuffle within class, then deal round-robin across ranks
    order = np.argsort(labels, kind="stable")
    for cls in np.unique(labels):
        sel = order[labels[order] == cls]
        rng.shuffle(sel)
    total = ((n + world_size - 1) // world_size) * world_size
    if total > n:
        order = np.concatenate([order, order[: total - n]])
    return order[rank::world_size]


SAMPLERS = {
    "distributed": distributed_indices,
    "distributed_iteration": distributed_iteration_indices,
    "ranked_iteration": ranked_iteration_indices,
}
