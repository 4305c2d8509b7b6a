"""Shared solver runtime: model building, result files, eval loop.

Counterpart of ``robustart_tpu/solvers/base.py``, the part the ImageNet-C
solver needs:

- per-sample JSON-lines result files (``results.txt.all``) as the durable
  interface to the metric layer;
- rank-sharded result writing merged by rank 0 over the filesystem;
- ``saver.pretrain{path, ignore{model}}`` warm start from a
  torchvision-named checkpoint, and ``saver.pretrain.clip_zero_shot``
  (``{weights}`` or ``{classnames, bpe[, num_heads]}``), which gives a raw
  OpenAI CLIP checkpoint its zero-shot head (JAX ``solvers/base.py:194-205``);
- ``model.dtype`` (``bf16`` / ``f32``) for the eval forward;
- ``model.quantize: int8``, the int8 post-training-quantization eval path
  (``maybe_quantize``, ``build_quantized``): ResNet, WideResNet and
  ResNeXt (``models/quantize.py``), ConvNeXt V1/V2, DenseNet,
  MobileNetV2/V3, EfficientNet, RegNetX/Y, RepVGG (its deploy form) and
  ShuffleNetV2 (``models/quantize_<family>.py``), and under
  ``model.quantize_force: true`` ViT/DeiT, Swin and the MLP-Mixer, which
  the JAX package refuses without it; a family that neither package
  quantizes (GoogLeNet, the NAS stand-ins) keeps the float path with a
  warning;
- ``maybe_deploy``: a RepVGG evaluates its re-parameterized deploy form
  unless ``model.deploy: false`` (JAX ``solvers/base.py:599-627``), swapped
  in once any checkpoint is loaded, where the JAX package swaps it: from
  ``maybe_quantize`` and the eval forward.

A solver runs on ``device`` (``cuda`` unless the caller asks for the CPU)
and fails, without falling back, when CUDA is asked for and absent. The port
runs one process; data parallelism over ``torch.distributed`` is ROADMAP.md's
"Facade, parallelism, CIFAR and tools" among the modules to port.
"""

from __future__ import annotations

import json
import os
import os.path as osp
import time
from typing import Callable, Iterable

import numpy as np
import torch

from robustart_torch.core.config import Config, load_config
from robustart_torch.core.device import resolve_device
from robustart_torch.core.logging import get_logger
from robustart_torch.models import CLIPVisionClassifier, create_classifier
from robustart_torch.models.convert import (load_clip_zero_shot, load_pretrain,
                                            read_torch_checkpoint, state_dict_from_flax_tree)
from robustart_torch.models.quantize import quantize_classifier
from robustart_torch.models.quantize_swin import quantize_swin
from robustart_torch.models.quantize_vit import quantize_vit
from robustart_torch.models.repvgg import RepVGG, reparameterize
from robustart_torch.solvers import msgpack_io

logger = get_logger("robustart.solver")

_DTYPES = {
    "bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
    "f32": torch.float32, "float32": torch.float32,
}


# -- checkpoints ----------------------------------------------------------------

TORCH_CKPT_EXTS = (".pth", ".pth.tar", ".pt", ".bin")


def select_eval_variables(ckpt: dict, use_ema: bool | None = None) -> dict:
    """The eval weights of a loaded msgpack checkpoint (JAX
    ``solvers/base.py::select_eval_variables``): ``use_ema`` None (auto)
    takes the EMA copy where ``extra.state.ema_params`` is not empty, True
    requires it, False takes the raw ``variables``."""
    variables = ckpt.get("variables") or {}
    state = (ckpt.get("extra") or {}).get("state") or {}
    ema = state.get("ema_params") or {}
    if use_ema is False:
        return variables
    if not ema:
        if use_ema:
            raise ValueError("model.use_ema: true but the checkpoint has no ema_params")
        return variables
    logger.info("eval: using EMA weights from checkpoint (model.use_ema=%s)", use_ema)
    return {**variables, "params": ema}


def newest_checkpoint(ckpt_dir: str) -> str:
    """The newest checkpoint in a directory by mtime, the JAX package's own
    ``*.msgpack`` saves first, else torch files (the port's training
    checkpoints among them)."""
    names = os.listdir(ckpt_dir)
    cands = ([f for f in names if f.endswith(".msgpack")]
             or [f for f in names if f.endswith(TORCH_CKPT_EXTS)])
    if not cands:
        raise FileNotFoundError(f"no checkpoint (*.msgpack or torch) in {ckpt_dir}")
    return max((osp.join(ckpt_dir, f) for f in cands), key=osp.getmtime)


def load_eval_variables(path: str, model: torch.nn.Module,
                        use_ema: bool | None = None) -> dict[str, torch.Tensor]:
    """The eval ``state_dict`` of a checkpoint for ``model``: a JAX msgpack
    checkpoint (``{variables, extra}``, or a bare variables tree) through
    :func:`select_eval_variables` and the Flax→torch bridge; the port's own
    training checkpoint with its ``ema`` chosen as ``use_ema`` says; any
    other torch file as ``read_torch_checkpoint`` reads it."""
    if path.endswith(".msgpack"):
        ckpt = msgpack_io.load(path)
        if "variables" not in ckpt and "params" in ckpt:
            ckpt = {"variables": ckpt}
        return state_dict_from_flax_tree(select_eval_variables(ckpt, use_ema), model)
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "optimizer" in obj and "model" in obj:
        ema = obj.get("ema") or {}
        if use_ema and not ema:
            raise ValueError("model.use_ema: true but the checkpoint has no EMA weights")
        if ema and use_ema is not False:
            logger.info("eval: using EMA weights from checkpoint (model.use_ema=%s)", use_ema)
            return {**obj["model"], **ema}
        return obj["model"]
    return read_torch_checkpoint(path)


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
        for knob in ("dist.tensor_parallel", "dist.pipeline_parallel"):
            value = self.cfg.get_path(knob)
            if value and value != 1:
                raise NotImplementedError(
                    f"{knob}={value!r} is not ported yet (ROADMAP.md, modules to port: "
                    "Facade, parallelism, CIFAR and tools)"
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
    def build_model(self, seed: int = 0, name: str | None = None):
        """The classifier of ``model.type`` (or ``name``) with ``model.kwargs``
        and ``model.dtype``, random weights from ``seed``, then
        ``saver.pretrain``; it becomes ``self.classifier``."""
        mcfg = self.cfg.model
        kwargs = dict(mcfg.get("kwargs") or {})
        dtype = mcfg.get("dtype")
        # an int8 run quantizes float32 parameters, as the JAX package's
        # quantizers read its float32 variables whatever model.dtype says
        if dtype and not self.int8:
            kwargs["dtype"] = _DTYPES[str(dtype)]
        self.classifier = create_classifier(
            name or mcfg.type, seed=seed, device=self.device, **kwargs
        )
        pretrain = (self.cfg.get("saver") or {}).get("pretrain") or {}
        if pretrain.get("path"):
            ignore = pretrain.get("ignore") or {}
            self.load_weights(pretrain["path"], ignore.get("model") or [],
                              pretrain.get("clip_zero_shot"))
        if self.int8:
            self._quantizer = self.int8_quantizer()
        return self.classifier

    def load_weights(self, path: str, ignore_model: Iterable[str] = (),
                     clip_zero_shot: dict | None = None) -> int:
        """Load a torchvision-named checkpoint into the classifier's model;
        ``clip_zero_shot`` then builds a CLIP model's zero-shot head."""
        logger.info("loading torch checkpoint %s", path)
        model = self.classifier.model
        state_dict = read_torch_checkpoint(path)
        n = load_pretrain(model, state_dict, ignore_model)
        if clip_zero_shot and isinstance(model, CLIPVisionClassifier):
            load_clip_zero_shot(model, state_dict, clip_zero_shot, self.device)
        return n

    # -- int8 post-training quantization --
    # families the JAX package refuses to quantize without
    # model.quantize_force (robustart_tpu/solvers/base.py:782)
    _INT8_FUSED_REFUSALS = ("VisionTransformer", "SwinTransformer", "MlpMixer")
    # families whose int8 path the JAX package warns about, having measured
    # it slower than bf16 on its own hardware (robustart_tpu/solvers/base.py:756)
    _INT8_WARNED = ("MobileNetV2", "MobileNetV3", "EfficientNet", "DenseNet", "RegNetX",
                    "ShuffleNetV2")

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

    @staticmethod
    def _int8_quantizers() -> dict:
        from robustart_torch.models.quantize_convnext import quantize_convnext
        from robustart_torch.models.quantize_densenet import quantize_densenet
        from robustart_torch.models.quantize_efficientnet import quantize_efficientnet
        from robustart_torch.models.quantize_mixer import quantize_mixer
        from robustart_torch.models.quantize_mobilenet import quantize_mobilenet_v2
        from robustart_torch.models.quantize_mobilenet_v3 import quantize_mobilenet_v3
        from robustart_torch.models.quantize_regnet import quantize_regnet
        from robustart_torch.models.quantize_repvgg import quantize_repvgg
        from robustart_torch.models.quantize_shufflenet import quantize_shufflenet

        return {"ResNet": quantize_classifier, "VisionTransformer": quantize_vit,
                "SwinTransformer": quantize_swin, "ConvNeXt": quantize_convnext,
                "MlpMixer": quantize_mixer, "DenseNet": quantize_densenet,
                "MobileNetV2": quantize_mobilenet_v2, "MobileNetV3": quantize_mobilenet_v3,
                "EfficientNet": quantize_efficientnet, "RegNetX": quantize_regnet,
                "RepVGG": quantize_repvgg, "ShuffleNetV2": quantize_shufflenet}

    def int8_quantizer(self):
        """The quantizer of the classifier's family for ``model.quantize:
        int8`` (``quantize(classifier, calib_images_u8, calib_batch_size)``),
        or None, with a warning, for a family that neither package
        quantizes (GoogLeNet, the NAS stand-ins). Refuses what the JAX
        package refuses (ValueError), and warns where it warns."""
        family = type(self.classifier.model).__name__
        if family in self._INT8_FUSED_REFUSALS:
            self._refuse_int8_fused_family(family)
        if family in self._INT8_WARNED:
            logger.warning("int8 %s: the JAX package warns that this family's int8 path ran "
                           "slower than its bf16 one; the port's int8 and bf16 forward times "
                           "on the card are in PERF.md", family)
        quantizers = self._int8_quantizers()
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
        evaluating corruptions). Returns True when the swap happened. A
        RepVGG first takes its deploy form (:meth:`maybe_deploy`)."""
        self.maybe_deploy()
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

    def maybe_deploy(self) -> bool:
        """A RepVGG evaluates the re-parameterized deploy form by default:
        every block's three branches folded into one 3×3 conv
        (``models/repvgg.py::reparameterize``), the same logits up to
        rounding. ``model.deploy: false`` keeps the train form. Called after
        any checkpoint load (from :meth:`maybe_quantize` and the eval
        forward), as the JAX package calls it. Returns True when the swap
        happened."""
        model = getattr(self.classifier, "model", None)
        if not isinstance(model, RepVGG) or model.deploy:
            return False
        if self.cfg.get_path("model.deploy") is False:
            return False
        self.classifier.model = reparameterize(model)
        self.classifier.name = f"{self.classifier.name}@deploy"
        logger.info("RepVGG: eval uses the re-parameterized deploy form "
                    "(model.deploy: false keeps the train form)")
        return True

    # -- eval step --
    def eval_fn(self, images_u8: np.ndarray) -> torch.Tensor:
        """uint8 NHWC host batch → logits on the device: one copy to the
        device, then the int8 classifier once ``maybe_quantize`` built one,
        else the float classifier on the uint8 batch, which normalizes it
        as the jitted JAX eval step does (``Classifier.forward``)."""
        self.maybe_deploy()
        x = torch.from_numpy(images_u8).to(self.device)
        if self.quantized is not None:
            return self.quantized(x)
        return self.classifier(x)

    @torch.inference_mode()
    def run_eval_loop(
        self,
        loader,
        writer: ResultWriter,
        record_fn: Callable[[np.ndarray, np.ndarray, np.ndarray], Iterable[dict]]
        | None = None,
        limit_samples: int | None = None,
    ) -> int:
        """Forward-only loop: batches → logits → JSON-lines records. The
        default record is {"score": [...logits...], "label": l} per valid
        sample, the evaluator-facing protocol; ``record_fn(logits, labels,
        mask)`` (host arrays) yields a batch's records instead."""
        n_written = 0
        t0 = time.time()
        n_images = 0
        for batch in loader:
            logits = self.eval_fn(batch.image).cpu().numpy()
            mask = batch.mask
            n_images += int(mask.sum())
            if record_fn is not None:
                records = record_fn(logits, batch.label, mask)
            else:
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
