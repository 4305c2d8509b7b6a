"""``multi_eval_solver`` — the ImageNet-C benchmark loop.

Counterpart of ``robustart_tpu/solvers/multi_eval_solver.py``: the same CLI,
config keys and result files (one ``results.txt.all`` per (corruption,
severity), a ``metric`` JSON beside each, ``summary.json`` with top-1 per
corruption and the AlexNet-normalized mCE).

Two data modes:

- **precomputed**: ``data.test.meta_file`` is an ``all.json`` mapping
  corruption → severity → {root_dir, meta_file} of stored ImageNet-C slices.
- **online** (``data.test.imagenet_c_online: True``): the clean val set is
  loaded once and each corruption is made on the device. Each batch is
  copied to the device once; every pending severity of the corruption is
  computed on it (``data.test.fuse_severities``, default on) and the stacked
  logits come back in one copy. ``gaussian_noise``, ``speckle_noise`` and
  ``impulse_noise`` run through the fused kernel K1
  (``robustart_torch.ops.noise``), whose normalized output goes straight
  into the classifier. Every other corruption runs as the JAX solver runs
  it: u8 / 255, the corruption on the device
  (``robustart_torch.noise.corruptions``, through kernels K2-K5 where it
  has one), the uint8 grid, the classifier. That includes ``shot_noise``'s
  exact Poisson sampler: K1's shot mode is a Gaussian approximation and
  would change the result. Each (severity, batch) draws from its own 32-bit
  key, a hash of (run seed, severity, batch index), so the fused and
  per-severity runs write byte-identical files.

``model.quantize: int8`` swaps in the int8 classifier
(``models/quantize*.py``), built once a run: in precomputed mode from the
first batches of the first slice (``Solver.maybe_quantize``), online from
the first batches of the first corruption, corrupted on the device at the
run's highest severity (:meth:`MultiEvalSolver._online_quantized`). It takes
the int8 grid ``k − 128``: for the noise family K1's ``centered_u8`` output,
straight into the int8 stem with no float image between; for every other
corruption the corrupted image's uint8 grid − 128.
"""

from __future__ import annotations

import hashlib
import json
import os.path as osp
import time

import numpy as np
import torch

from robustart_torch.core.logging import get_logger
from robustart_torch.data import build_dataloader
from robustart_torch.metrics import ImageNetCEvaluator, mean_corruption_error
from robustart_torch.models.quantize import Int8Model
from robustart_torch.noise.corruptions import (
    CORRUPTION_ORDER,
    CORRUPTIONS,
    NOISE_SEVERITY,
    corrupt_batch,
    to_unit,
    uint8_grid,
    uint8_roundtrip,
)
from robustart_torch.ops.noise import fused_noise_normalize
from robustart_torch.solvers.base import ResultWriter, Solver, standard_solver_argparser

logger = get_logger("robustart.multi_eval")

STANDARD_CORRUPTIONS = CORRUPTION_ORDER[:15]
# the corruptions K1 computes exactly as the solver defines them
FUSED_NOISE = ("gaussian_noise", "speckle_noise", "impulse_noise")


def batch_seed(run_seed: int, severity: int, batch_index: int) -> int:
    """32-bit random key of one (severity, batch) cell of a run."""
    digest = hashlib.blake2b(
        f"{run_seed}/{severity}/{batch_index}".encode(), digest_size=4
    ).digest()
    return int.from_bytes(digest, "little")


def corrupted_grid(corruption: str, severity: int, images_u8: torch.Tensor,
                   seed: int) -> torch.Tensor:
    """The int8 grid ``k − 128`` of a uint8 NHWC batch corrupted on its
    device: K1's ``centered_u8`` output for the noise family, else the
    corruption's uint8 grid − 128."""
    if corruption in FUSED_NOISE:
        return fused_noise_normalize(
            images_u8, seed, noise=corruption,
            sigma=NOISE_SEVERITY[corruption][severity - 1],
            out_dtype=torch.int8, output="centered_u8",
        )
    gen = torch.Generator(device=images_u8.device).manual_seed(seed)
    x = corrupt_batch(to_unit(images_u8), corruption, severity, generator=gen)
    return (uint8_grid(x) - 128).to(torch.int8)


def online_logits(classifier, corruption: str, severity: int,
                  images_u8: torch.Tensor, seed: int) -> torch.Tensor:
    """Corrupt a uint8 NHWC batch on its device and return the logits; an
    int8 classifier takes the batch's :func:`corrupted_grid`."""
    if isinstance(classifier, Int8Model):
        return classifier(corrupted_grid(corruption, severity, images_u8, seed))
    if corruption in FUSED_NOISE:
        x = fused_noise_normalize(
            images_u8, seed, noise=corruption,
            sigma=NOISE_SEVERITY[corruption][severity - 1],
            mean=classifier.mean, std=classifier.std,
            out_dtype=classifier.dtype, output="normalized",
        )
        return classifier.forward_normalized(x)
    gen = torch.Generator(device=images_u8.device).manual_seed(seed)
    x = corrupt_batch(to_unit(images_u8), corruption, severity, generator=gen)
    return classifier(uint8_roundtrip(x))


class MultiEvalSolver(Solver):
    def evaluate(self, ckpt_path: str | None = None) -> dict:
        cfg = self.cfg
        if self.classifier is None:
            self.build_model(seed=int(cfg.get("seed", 0)))
        if ckpt_path:
            self.load_weights(ckpt_path)
        test_cfg = cfg.data.get("test", {})
        out_root = cfg.get_path("saver.results_dir", "results/imagenet-c")
        limit = test_cfg.get("limit_samples")
        severities = list(test_cfg.get("severities", [1, 2, 3, 4, 5]))
        corruptions = list(test_cfg.get("corruptions", STANDARD_CORRUPTIONS))

        online = bool(test_cfg.get("imagenet_c_online", False))
        unknown = [c for c in corruptions if c not in CORRUPTIONS]
        if online and unknown:  # refuse up front: a run never skips a corruption
            raise ValueError(f"unknown corruptions {unknown}; have {list(CORRUPTION_ORDER)}")
        per_corruption: dict[str, list[float]] = {}
        evaluator = ImageNetCEvaluator(
            **(test_cfg.get("evaluator", {}).get("kwargs") or {"topk": [1, 5]})
        )
        fuse = bool(test_cfg.get("fuse_severities", True))

        for corruption in corruptions:
            res_files = {
                s: osp.join(out_root, corruption, str(s), "results.txt.all")
                for s in severities
            }
            pending = {}
            for s, res_file in res_files.items():
                if osp.exists(res_file):  # idempotent-by-filesystem recovery
                    logger.info("skip existing %s", res_file)
                else:
                    pending[s] = res_file
            if pending:
                if online and fuse and len(pending) > 1:
                    self._eval_online_fused(corruption, pending, limit)
                elif online:
                    for s, res_file in pending.items():
                        self._eval_online_fused(corruption, {s: res_file}, limit)
                else:
                    for s, res_file in pending.items():
                        self._eval_precomputed(corruption, s, res_file, limit)
            if self.rank == 0:
                for severity in severities:
                    metric = evaluator.eval(res_files[severity])
                    per_corruption.setdefault(corruption, []).append(
                        metric.metric["top1"]
                    )
                    logger.info(
                        "%s/%d top1=%.2f", corruption, severity,
                        metric.metric["top1"],
                    )
        if self.rank != 0:
            return {}
        mean_top1 = {c: float(np.mean(v)) for c, v in per_corruption.items()}
        known = {c: v for c, v in mean_top1.items() if c in STANDARD_CORRUPTIONS}
        summary = {
            "top1_per_corruption": mean_top1,
            "mCE": mean_corruption_error(known) if known else None,
            # frost blends procedural textures (frost_bank): the reference's
            # six photographs are absent, so its numbers are not comparable
            # to published frost rows or mCE
            "non_comparable": (
                {"frost": "procedural-texture substitute for missing assets"}
                if "frost" in mean_top1 else {}
            ),
            "mean_top1": float(np.mean(list(mean_top1.values()))),
        }
        with open(osp.join(out_root, "summary.json"), "w") as f:
            json.dump(summary, f, indent=2)
        logger.info("ImageNet-C summary: %s", summary)
        return summary

    @torch.inference_mode()
    def _online_quantized(self, loader, corruption):
        """The int8 classifier of an online run (``model.quantize: int8``),
        or None: built once a run, calibrated on the first
        ``model.quantize_calib_batches`` (default 2) batches of ``loader``
        corrupted on the device by ``corruption`` (the run's first) at the
        run's highest severity, whose per-tensor amax covers the milder
        cells. Calibration batch i draws ``batch_seed(seed, severity,
        −1 − i)``, a key no eval batch takes."""
        if not self.int8 or self._quantize_checked:
            return self.quantized
        self._quantize_checked = True
        seed = int(self.cfg.get("seed", 0))
        severity = max(self.cfg.data.test.get("severities", [1, 2, 3, 4, 5]))
        n_batches = int(self.cfg.get_path("model.quantize_calib_batches") or 2)
        calib = []
        for i, batch in enumerate(loader):
            images = torch.from_numpy(batch.image).to(self.device)
            grid = corrupted_grid(corruption, severity, images, batch_seed(seed, severity, -1 - i))
            calib.append((grid.to(torch.int16) + 128).to(torch.uint8).cpu().numpy())
            if i + 1 >= n_batches:
                break
        self.quantized = self.build_quantized(np.concatenate(calib))
        if self.quantized is not None:
            logger.info("int8 online eval path enabled (%s, calibrated on %s/%d)",
                        self.quantized.name, corruption, severity)
        return self.quantized

    @torch.inference_mode()
    def _eval_online_fused(self, corruption, pending, limit):
        """One pass over the clean val set computing every pending severity
        of ``corruption`` per device-resident batch; with one pending
        severity this is the per-cell run. Severity ``s`` of batch ``bi``
        draws from ``batch_seed(seed, s, bi)`` whichever way it runs."""
        cfg = self.cfg
        seed = int(cfg.get("seed", 0))
        loader = build_dataloader(
            cfg.data, "test", self.rank, self.world_size, seed=seed,
        )
        sev_list = sorted(pending)
        self.maybe_deploy()
        model = self._online_quantized(loader, corruption) or self.classifier
        writers = {
            s: ResultWriter(pending[s], self.rank, self.world_size)
            for s in sev_list
        }
        n_written = 0
        t0 = time.time()
        for bi, batch in enumerate(loader):
            images = torch.from_numpy(batch.image).to(self.device)
            logits = torch.stack([
                online_logits(model, corruption, s, images, batch_seed(seed, s, bi))
                for s in sev_list
            ]).cpu().numpy()
            for i in range(len(batch.mask)):
                if batch.mask[i]:
                    for si, s in enumerate(sev_list):
                        writers[s].write(
                            {
                                "score": logits[si, i].tolist(),
                                "label": int(batch.label[i]),
                            }
                        )
                    n_written += 1
                    if limit and n_written >= limit:
                        break
            if limit and n_written >= limit:
                break
        dt = time.time() - t0
        logger.info(
            "%s/%s (online): %d samples × %d severities in %.2fs (%.1f img/s)",
            corruption, sev_list, n_written, len(sev_list), dt,
            n_written * len(sev_list) / max(dt, 1e-9),
        )
        for w in writers.values():
            w.merge()

    # -- precomputed ImageNet-C slices on disk --
    def _eval_precomputed(self, corruption, severity, res_file, limit):
        cfg = self.cfg
        test_cfg = cfg.data.test
        with open(test_cfg.meta_file) as f:
            all_meta = json.load(f)
        entry = all_meta[corruption][str(severity)]
        override = dict(test_cfg)
        override["root_dir"] = entry.get("root_dir", test_cfg.get("root_dir"))
        override["meta_file"] = entry["meta_file"]
        loader = build_dataloader(
            cfg.data, "test", self.rank, self.world_size,
            split_cfg_override=override, seed=int(cfg.get("seed", 0)),
        )
        if not self._quantize_checked:
            # the int8 swap, once, calibrated on the corrupted eval
            # distribution this loader serves (model.quantize: int8)
            self._quantize_checked = True
            self.maybe_quantize(loader)
        writer = ResultWriter(res_file, self.rank, self.world_size)
        self.run_eval_loop(loader, writer, limit_samples=limit)
        writer.merge()


def main(argv=None):
    parser = standard_solver_argparser("robustart multi_eval_solver (ImageNet-C)")
    args = parser.parse_args(argv)
    solver = MultiEvalSolver(args.config, evaluate_only=True)
    return solver.evaluate(ckpt_path=args.ckpt_filePath)


if __name__ == "__main__":
    main()
