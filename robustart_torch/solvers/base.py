"""Shared solver runtime: model building, result files, eval loop.

Counterpart of ``robustart_tpu/solvers/base.py``, the part the ImageNet-C
solver needs:

- per-sample JSON-lines result files (``results.txt.all``) as the durable
  interface to the metric layer;
- rank-sharded result writing merged by rank 0 over the filesystem;
- ``saver.pretrain{path, ignore{model}}`` warm start from a
  torchvision-named checkpoint;
- ``model.dtype`` (``bf16`` / ``f32``) for the eval forward;
- ``model.quantize: int8``, the int8 post-training-quantization eval path
  (``maybe_quantize``, ``build_quantized``): ResNet, WideResNet and
  ResNeXt (``models/quantize.py``), and under ``model.quantize_force:
  true`` ViT/DeiT and Swin (``models/quantize_vit.py``,
  ``quantize_swin.py``), which the JAX package refuses without it. The
  int8 families of ConvNeXt, MLP-Mixer and DenseNet are not ported yet and
  raise; a family that neither package quantizes keeps the float path.

A solver runs on ``device`` (``cuda`` unless the caller asks for the CPU)
and fails, without falling back, when CUDA is asked for and absent. The port
runs one process; data parallelism over ``torch.distributed`` is ROADMAP.md
item 10 of the modules to port.
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
from robustart_torch.models.quantize import quantize_classifier
from robustart_torch.models.quantize_swin import quantize_swin
from robustart_torch.models.quantize_vit import quantize_vit

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
        for knob, item in (("dist.tensor_parallel", 10), ("dist.pipeline_parallel", 10)):
            value = self.cfg.get_path(knob)
            if value and value != 1:
                raise NotImplementedError(
                    f"{knob}={value!r} is not ported yet (ROADMAP.md, "
                    f"modules to port, item {item})"
                )
        mode = self.cfg.get_path("model.quantize")
        if mode not in (None, False, "none", "int8"):
            raise ValueError(f"unknown model.quantize mode {mode!r}")
        self.int8 = mode == "int8"
        self.rank = 0
        self.world_size = 1
        self.classifier = None
        self.quantized = None  # the int8 classifier, once built
        self._quantizer = None
        self._quantize_checked = False

    # -- model --
    def build_model(self, seed: int = 0):
        mcfg = self.cfg.model
        kwargs = dict(mcfg.get("kwargs") or {})
        dtype = mcfg.get("dtype")
        # an int8 run quantizes float32 parameters, as the JAX package's
        # quantizers read its float32 variables whatever model.dtype says
        if dtype and not self.int8:
            kwargs["dtype"] = _DTYPES[str(dtype)]
        self.classifier = create_classifier(
            mcfg.type, seed=seed, device=self.device, **kwargs
        )
        pretrain = (self.cfg.get("saver") or {}).get("pretrain") or {}
        if pretrain.get("path"):
            ignore = pretrain.get("ignore") or {}
            self.load_weights(pretrain["path"], ignore.get("model") or [])
        if self.int8:
            self._quantizer = self.int8_quantizer()
        return self.classifier

    def load_weights(self, path: str, ignore_model: Iterable[str] = ()) -> int:
        """Load a torchvision-named checkpoint into the classifier's model."""
        logger.info("loading torch checkpoint %s", path)
        return load_pretrain(
            self.classifier.model, read_torch_checkpoint(path), ignore_model
        )

    # -- int8 post-training quantization --
    # families the JAX package refuses to quantize without
    # model.quantize_force (robustart_tpu/solvers/base.py:782)
    _INT8_FUSED_REFUSALS = ("VisionTransformer", "SwinTransformer", "MlpMixer")
    # families the JAX package quantizes and the port does not yet
    _INT8_NOT_PORTED = ("ConvNeXt", "MlpMixer", "DenseNet")

    def _refuse_int8_fused_family(self, family: str) -> None:
        if bool(self.cfg.get_path("model.quantize_force")):
            logger.warning("int8 %s forced (model.quantize_force): the JAX package refuses "
                           "it otherwise; its speed against bf16 on this card is in "
                           "PERF.md", family)
            return
        raise ValueError(
            f"model.quantize: int8 refused for {family}, as the JAX package refuses it: "
            "its fused bf16 block kernels were measured faster than its int8 path on its "
            "own hardware. Whether int8 wins on this card is measured by chip_smoke.py "
            "(PERF.md). Set model.quantize_force: true to run it."
        )

    def int8_quantizer(self):
        """The quantizer of the classifier's family for ``model.quantize:
        int8`` (``quantize(classifier, calib_images_u8, calib_batch_size)``),
        or None, with a warning, for a family that neither package
        quantizes. Refuses what the JAX package refuses (ValueError) and
        what the port has not ported (NotImplementedError)."""
        family = type(self.classifier.model).__name__
        if family in self._INT8_FUSED_REFUSALS:
            self._refuse_int8_fused_family(family)
        if family in self._INT8_NOT_PORTED:
            raise NotImplementedError(
                f"model.quantize: int8 for {family} is not ported yet (ROADMAP.md, modules "
                "to port, item 2)"
            )
        quantizers = {"ResNet": quantize_classifier, "VisionTransformer": quantize_vit,
                      "SwinTransformer": quantize_swin}
        if family not in quantizers:
            logger.warning("model.quantize: int8 unsupported for %s: keeping float eval",
                           family)
        return quantizers.get(family)

    def build_quantized(self, calib_images_u8: np.ndarray):
        """int8-PTQ the classifier on ``calib_images_u8`` (uint8 NHWC from
        the eval distribution), calibrating in batches of min(64, N).
        Returns the int8 classifier, or None for an unsupported family."""
        quantize = self._quantizer or self.int8_quantizer()
        if quantize is None:
            return None
        bs = min(64, len(calib_images_u8))
        return quantize(self.classifier, calib_images_u8, calib_batch_size=bs)

    def maybe_quantize(self, loader) -> bool:
        """Swap the eval forward for the int8 path when the config asks
        (``model.quantize: int8``; ``model.quantize_calib_batches``: N,
        default 2): calibrate on the valid images of the first N batches
        of ``loader`` (the eval distribution: corrupted images when
        evaluating corruptions). Returns True when the swap happened."""
        if not self.int8:
            return False
        n_batches = int(self.cfg.get_path("model.quantize_calib_batches") or 2)
        calib = []
        for i, batch in enumerate(loader):
            calib.append(batch.image[batch.mask])
            if i + 1 >= n_batches:
                break
        calib = np.concatenate(calib)
        self.quantized = self.build_quantized(calib)
        if self.quantized is None:
            return False
        logger.info("int8 eval path enabled (%s, calib %d images)", self.quantized.name,
                    len(calib))
        return True

    # -- eval step --
    def eval_fn(self, images_u8: np.ndarray) -> torch.Tensor:
        """uint8 NHWC host batch → logits on the device: one copy to the
        device, then the int8 classifier once ``maybe_quantize`` built one,
        else /255 and the float classifier (which normalizes)."""
        x = torch.from_numpy(images_u8).to(self.device)
        if self.quantized is not None:
            return self.quantized(x)
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
