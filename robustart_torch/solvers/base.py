"""Shared solver runtime: model building, result files, eval loop.

Counterpart of ``robustart_tpu/solvers/base.py``, the part the ImageNet-C
solver needs:

- per-sample JSON-lines result files (``results.txt.all``) as the durable
  interface to the metric layer;
- rank-sharded result writing merged by rank 0 over the filesystem;
- ``saver.pretrain{path, ignore{model}}`` warm start from a
  torchvision-named checkpoint;
- ``model.dtype`` (``bf16`` / ``f32``) for the eval forward.

A solver runs on ``device`` (``cuda`` unless the caller asks for the CPU)
and fails, without falling back, when CUDA is asked for and absent. The port
runs one process; data parallelism over ``torch.distributed`` is ROADMAP.md
item 14 of the modules to port.
"""

from __future__ import annotations

import json
import os
import os.path as osp
import time
from typing import Iterable

import numpy as np
import torch

from robustart_torch.core.config import Config, load_config
from robustart_torch.core.logging import get_logger
from robustart_torch.models import create_classifier
from robustart_torch.models.convert import load_pretrain, read_torch_checkpoint

logger = get_logger("robustart.solver")

_DTYPES = {
    "bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
    "f32": torch.float32, "float32": torch.float32,
}


def resolve_device(device: str | torch.device) -> torch.device:
    """``torch.device(device)``, refusing ``cuda`` where there is none."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU"
        )
    return device


class ResultWriter:
    """Rank-sharded JSON-lines result writer with rank-0 merge.

    Writes ``<path>.rank<k>`` shards when ``world_size > 1``; ``merge()`` on
    rank 0 concatenates them into the final file. Produces the protocol the
    evaluators consume.
    """

    def __init__(self, path: str, rank: int = 0, world_size: int = 1):
        self.path = path
        self.rank = rank
        self.world_size = world_size
        os.makedirs(osp.dirname(osp.abspath(path)), exist_ok=True)
        self.shard_path = f"{path}.rank{rank}" if world_size > 1 else path
        self._f = open(self.shard_path, "w")

    def write(self, record: dict) -> None:
        self._f.write(json.dumps(record) + "\n")

    def close(self) -> None:
        if self._f.closed:
            return
        self._f.flush()
        self._f.close()
        if self.world_size > 1:
            # completion sentinel: merge must not read half-written shards
            with open(self.shard_path + ".done", "w") as f:
                f.write("done")

    def merge(self, timeout_s: float = 600.0) -> str:
        """rank 0: merge shards (call after all ranks closed; on one process
        this is a no-op). Each rank's ``.done`` sentinel signals completion."""
        self.close()
        if self.world_size == 1 or self.rank != 0:
            return self.path
        deadline = time.time() + timeout_s
        with open(self.path, "w") as out:
            for r in range(self.world_size):
                shard = f"{self.path}.rank{r}"
                while not osp.exists(shard + ".done"):
                    if time.time() > deadline:
                        raise TimeoutError(
                            f"rank {r} shard never completed: {shard}"
                        )
                    time.sleep(0.2)
                with open(shard) as f:
                    out.write(f.read())
        return self.path


class Solver:
    """Config-driven solver base: device, model, eval loop."""

    def __init__(self, config: Config | str, evaluate_only: bool = False,
                 device: str | torch.device = "cuda"):
        # evaluate_only: the reference CLI's flag; every ported solver evaluates
        self.cfg = load_config(config) if isinstance(config, str) else config
        self.device = resolve_device(device)
        for knob, item in (("model.quantize", 5), ("dist.tensor_parallel", 14),
                           ("dist.pipeline_parallel", 14)):
            value = self.cfg.get_path(knob)
            if value and value != 1:
                raise NotImplementedError(
                    f"{knob}={value!r} is not ported yet (ROADMAP.md, "
                    f"modules to port, item {item})"
                )
        self.rank = 0
        self.world_size = 1
        self.classifier = None

    # -- model --
    def build_model(self, seed: int = 0):
        mcfg = self.cfg.model
        kwargs = dict(mcfg.get("kwargs") or {})
        dtype = mcfg.get("dtype")
        if dtype:
            kwargs["dtype"] = _DTYPES[str(dtype)]
        self.classifier = create_classifier(
            mcfg.type, seed=seed, device=self.device, **kwargs
        )
        pretrain = (self.cfg.get("saver") or {}).get("pretrain") or {}
        if pretrain.get("path"):
            ignore = pretrain.get("ignore") or {}
            self.load_weights(pretrain["path"], ignore.get("model") or [])
        return self.classifier

    def load_weights(self, path: str, ignore_model: Iterable[str] = ()) -> int:
        """Load a torchvision-named checkpoint into the classifier's model."""
        logger.info("loading torch checkpoint %s", path)
        return load_pretrain(
            self.classifier.model, read_torch_checkpoint(path), ignore_model
        )

    # -- eval step --
    def eval_fn(self, images_u8: np.ndarray) -> torch.Tensor:
        """uint8 NHWC host batch → logits on the device: one copy to the
        device, /255, then the classifier (which normalizes)."""
        x = torch.from_numpy(images_u8).to(self.device)
        return self.classifier(x.to(torch.float32) / 255.0)

    @torch.inference_mode()
    def run_eval_loop(
        self,
        loader,
        writer: ResultWriter,
        limit_samples: int | None = None,
    ) -> int:
        """Forward-only loop: batches → logits → JSON-lines records
        {"score": [...logits...], "label": l} per valid sample, the
        evaluator-facing protocol."""
        n_written = 0
        t0 = time.time()
        n_images = 0
        for batch in loader:
            logits = self.eval_fn(batch.image).cpu().numpy()
            mask = batch.mask
            n_images += int(mask.sum())
            records = (
                {"score": logits[i].tolist(), "label": int(batch.label[i])}
                for i in range(len(mask))
                if mask[i]
            )
            for rec in records:
                writer.write(rec)
                n_written += 1
                if limit_samples and n_written >= limit_samples:
                    break
            if limit_samples and n_written >= limit_samples:
                break
        dt = time.time() - t0
        logger.info(
            "eval loop: %d samples in %.2fs (%.1f img/s)",
            n_written, dt, n_images / max(dt, 1e-9),
        )
        return n_written


def standard_solver_argparser(description: str):
    """The reference solver CLI surface: --config --evaluate --recover
    --ckpt-filePath."""
    import argparse

    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--config", required=True, help="yaml config path")
    parser.add_argument("--evaluate", action="store_true", help="eval only")
    parser.add_argument("--recover", default=None, help="checkpoint to resume")
    parser.add_argument(
        "--ckpt-filePath", dest="ckpt_filePath", default=None,
        help="checkpoint file/dir for evaluation",
    )
    return parser
