"""Config → dataloader assembly with the reference's data schema
(counterpart of ``robustart_tpu/data/pipeline.py``).

The schema: ``data{read_from, batch_size, num_workers, prefetch_factor,
input_size, test_resize, test{root_dir, meta_file, sampler{type},
transforms{type}, evaluator{...}}}``. The JAX package's native C++ decode
pool (``data.use_native_loader``) is not part of the port; the key is
ignored and the Python loader serves every config.
"""

from __future__ import annotations

import numpy as np

from robustart_torch.data.dataset import build_dataset
from robustart_torch.data.loader import DataLoader
from robustart_torch.data.samplers import SAMPLERS
from robustart_torch.data.transforms import build_transform


def build_dataloader(
    data_cfg,
    split: str = "test",
    rank: int = 0,
    world_size: int = 1,
    epoch: int = 0,
    seed: int = 0,
    split_cfg_override=None,
) -> DataLoader:
    """Build a loader for ``data_cfg[split]`` honoring sampler/transform types.

    ``split_cfg_override`` lets the ImageNet-C solver swap
    root_dir/meta_file per stored slice while keeping one config.
    """
    split_cfg = split_cfg_override if split_cfg_override is not None else data_cfg.get(split, {})
    input_size = int(data_cfg.get("input_size", 224))
    test_resize = int(data_cfg.get("test_resize", 256))
    batch_size = int(data_cfg.get("batch_size", 32))

    dataset = build_dataset(data_cfg, split_cfg, input_size)

    sampler_type = split_cfg.get("sampler", {}).get("type", "distributed")
    if sampler_type not in SAMPLERS:
        raise ValueError(f"unknown sampler {sampler_type!r}")
    n = len(dataset)
    if sampler_type == "distributed":
        indices = SAMPLERS[sampler_type](n, rank, world_size)
    elif sampler_type == "ranked_iteration":
        indices = SAMPLERS[sampler_type](
            n, rank, world_size, epoch, seed, getattr(dataset, "labels", None)
        )
    else:
        indices = SAMPLERS[sampler_type](n, rank, world_size, epoch, seed)

    transforms_cfg = split_cfg.get("transforms", {})
    preset = (
        transforms_cfg.get("type", "ONECROP")
        if isinstance(transforms_cfg, dict)
        else "ONECROP"
    )
    return DataLoader(
        dataset,
        np.asarray(indices),
        batch_size=batch_size,
        transform=build_transform(preset, input_size, test_resize),
        num_workers=int(data_cfg.get("num_workers", 4)),
        prefetch_factor=int(data_cfg.get("prefetch_factor", 2)),
        drop_last=(split == "train"),
    )
