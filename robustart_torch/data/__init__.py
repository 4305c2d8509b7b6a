"""Input pipeline (counterpart of ``robustart_tpu.data``)."""

from robustart_torch.data.dataset import FakeDataset, MetaFileDataset, build_dataset
from robustart_torch.data.loader import Batch, DataLoader
from robustart_torch.data.pipeline import build_dataloader
from robustart_torch.data.samplers import (
    SAMPLERS,
    distributed_indices,
    distributed_iteration_indices,
    ranked_iteration_indices,
)
from robustart_torch.data.transforms import build_transform

__all__ = [
    "FakeDataset",
    "MetaFileDataset",
    "build_dataset",
    "Batch",
    "DataLoader",
    "build_dataloader",
    "build_transform",
    "SAMPLERS",
    "distributed_indices",
    "distributed_iteration_indices",
    "ranked_iteration_indices",
]
