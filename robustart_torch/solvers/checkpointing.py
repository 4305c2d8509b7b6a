"""Checkpoint discovery and loading (counterpart of
``robustart_tpu/solvers/checkpointing.py``).

The port reads the JAX package's msgpack checkpoints
(``solvers/msgpack_io.py``) and writes its own training checkpoints as torch
files (``ckpt.pth.tar``, or ``ckpt_e{epoch}.pth.tar`` under
``saver.save_many``) holding the weights and BatchNorm statistics
(``model``), the EMA weights (``ema``), the optimizer's state
(``optimizer``: ``count`` and its moments by parameter name), ``epoch`` and
``step``. Orbax ``step_N`` directories are the JAX package's own and are
refused.
"""

from __future__ import annotations

import os
import os.path as osp
import re
from typing import Any

import torch

from robustart_torch.solvers import msgpack_io

_ORBAX = ("Orbax step_N checkpoints are the JAX package's and are not read by the port "
          "(ROADMAP.md, modules to port: Training); save a msgpack checkpoint instead")


def latest_checkpoint(directory: str) -> str | None:
    """The newest checkpoint in a directory for automatic resume: an Orbax
    ``step_N`` directory first (as the JAX package picks it; :func:`load_any`
    then refuses it), else the newest msgpack or port training checkpoint
    by mtime."""
    if not osp.isdir(directory):
        return None
    steps, files = [], []
    for name in os.listdir(directory):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and osp.isdir(osp.join(directory, name)):
            steps.append((int(m.group(1)), name))
        elif name.endswith((".msgpack", ".pth.tar")):
            files.append(name)
    if steps:
        return osp.join(directory, max(steps)[1])
    if files:
        return osp.join(directory, max(files, key=lambda n: osp.getmtime(osp.join(directory, n))))
    return None


def load_any(path: str) -> Any:
    """A checkpoint's contents: a msgpack tree, or a torch file's object."""
    if osp.isdir(path) and re.search(r"step_\d+$", path.rstrip("/")):
        raise NotImplementedError(f"{path}: {_ORBAX}")
    if path.endswith(".msgpack"):
        return msgpack_io.load(path)
    return torch.load(path, map_location="cpu", weights_only=False)


def save_train_checkpoint(path: str, payload: dict) -> None:
    os.makedirs(osp.dirname(osp.abspath(path)), exist_ok=True)
    torch.save(payload, path)
