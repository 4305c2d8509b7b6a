"""``multi_eval_decoder_resize_solver``: the ImageNet-S system-noise loop.

Counterpart of ``robustart_tpu/solvers/multi_eval_decoder_resize_solver.py``.
Loops decoder {pil, opencv, ffmpeg} × resize {6 PIL + 5 OpenCV modes},
decoding and resizing the raw val images on the host with each combo
(``noise/imagenet_s.py``), forwards on the device, writes one
``results.txt.all`` per combo and aggregates the per-combo top-1, its mean
and std by ``ImageNetSEvaluator``; ``save_acc_var_neg`` adds the negated
variance, and ``summary.json`` names the implementation of the ffmpeg axis.

The val transform uses no randomness, so the solver decodes each
image once per decoder and resizes it for each pending resize mode
(``_CombinationDataset`` with several modes): every ``results.txt.all`` is
the one a decode per combo gives. ``timings`` holds the host's seconds per
image of each decode and resize (each loader thread's own time) and the
device's seconds per batch (copy in, forward, logits out).

``data.read_from: fake`` writes a small JPEG set (280×320 noise from
``default_rng(0)``, quality 92, ``data.fake_size`` images) once and runs the
whole loop on it.

    python -m robustart_torch.solvers.multi_eval_decoder_resize_solver \\
        --config exprs/exp/imagenet_s_loop/config_resnet50.yaml [--device cpu]
"""

from __future__ import annotations

import json
import os
import os.path as osp
import tempfile
import threading
import time
from collections import defaultdict

import numpy as np
import torch
from PIL import Image

from robustart_torch.core.logging import get_logger
from robustart_torch.data import DataLoader, distributed_indices
from robustart_torch.metrics import ImageNetSEvaluator
from robustart_torch.noise.imagenet_s import (RESIZE_TYPES, decode_image, ffmpeg_decoder_impl,
                                              resize_decoded)
from robustart_torch.solvers.base import ResultWriter, Solver, standard_solver_argparser

logger = get_logger("robustart.s_eval")

DEFAULT_DECODERS = ("pil", "opencv", "ffmpeg")
DEFAULT_RESIZES = RESIZE_TYPES


class _CombinationDataset:
    """Raw (path, label) metas, each image decoded once with ``decoder``
    and resized with each of ``resize_types`` (the val transform):
    ``image`` is (len(resize_types), size, size, 3). Adds its host seconds
    to ``timings`` (``decode`` and one entry a resize mode)."""

    def __init__(self, root_dir, meta_file, decoder, resize_types, size=224, timings=None):
        self.metas = []
        with open(meta_file) as f:
            for line in f:
                line = line.rstrip()
                if line:
                    name, label = line.split()
                    self.metas.append((name, int(label)))
        self.root_dir = root_dir
        self.decoder = decoder
        self.resize_types = tuple(resize_types)
        self.size = (size, size)
        self.labels = np.array([label for _, label in self.metas])
        self.timings = timings if timings is not None else defaultdict(float)
        self._lock = threading.Lock()

    def __len__(self):
        return len(self.metas)

    def __getitem__(self, idx):
        name, label = self.metas[idx]
        path = osp.join(self.root_dir, name)
        t0 = time.perf_counter()
        with open(path, "rb") as f:
            filebytes = np.frombuffer(f.read(), dtype=np.uint8)
        img = decode_image(filebytes, self.decoder, "RGB", path)
        spent = {"decode": time.perf_counter() - t0}
        out = []
        for r in self.resize_types:
            t0 = time.perf_counter()
            out.append(resize_decoded(img, r, self.size))
            spent[r] = time.perf_counter() - t0
        with self._lock:
            for k, v in spent.items():
                self.timings[k] += v
        return {"image": np.stack(out), "label": label, "filename": name, "index": idx}


class MultiEvalDecoderResizeSolver(Solver):
    def evaluate(self, ckpt_path: str | None = None) -> dict:
        cfg = self.cfg
        if self.classifier is None:
            self.build_model(seed=int(cfg.get("seed", 0)))
        if ckpt_path:
            self.load_weights(ckpt_path)
        test_cfg = cfg.data.get("test", {})
        out_root = cfg.get_path("saver.results_dir", "results/imagenet-s")
        limit = test_cfg.get("limit_samples")
        decoders = list(test_cfg.get("decoders", DEFAULT_DECODERS))
        resizes = list(test_cfg.get("resize_types", DEFAULT_RESIZES))
        input_size = int(cfg.data.get("input_size", 224))
        root_dir, meta_file = self._resolve_data(test_cfg, input_size)

        # host seconds per image of each decoder and resize, device seconds per batch
        self.timings = {"host_decode_s": {}, "host_resize_s": {}, "device_batch_s": [],
                        "images": 0}
        evaluator = ImageNetSEvaluator()
        for decoder in decoders:
            res_files = {r: osp.join(out_root, decoder, r, "results.txt.all") for r in resizes}
            pending = [r for r in resizes if not osp.exists(res_files[r])]
            if pending:
                self._eval_decoder(root_dir, meta_file, decoder, pending, res_files,
                                   input_size, limit)
            if self.rank == 0:
                for r in resizes:
                    out = evaluator.eval(res_files[r], decoder_type=decoder, resize_type=r)
                    logger.info("ImageNet-S %s/%s: %s", decoder, r, out)
        if self.rank != 0:
            return {}
        summary = {
            "per_combo": {f"{d}/{r}": v for (d, r), v in evaluator.metric.metric.items()},
            **evaluator.get_mean(),
            **evaluator.get_std(),
        }
        if "ffmpeg" in decoders:
            summary["ffmpeg_decoder_impl"] = ffmpeg_decoder_impl()
        if test_cfg.get("save_acc_var_neg"):
            # reference flag: accuracy variance, negated (higher = stabler)
            summary["acc_var_neg"] = -float(np.var(list(evaluator.metric.metric.values())))
        os.makedirs(out_root, exist_ok=True)
        with open(osp.join(out_root, "summary.json"), "w") as f:
            json.dump(summary, f, indent=2)
        logger.info("ImageNet-S summary: %s", summary)
        return summary

    @torch.inference_mode()
    def _eval_decoder(self, root_dir, meta_file, decoder, pending, res_files, input_size,
                      limit):
        """Every pending resize mode of ``decoder`` in one pass: a batch of
        images decoded once, then one forward a mode."""
        cfg = self.cfg
        spent = defaultdict(float)
        ds = _CombinationDataset(root_dir, meta_file, decoder, pending, input_size, spent)
        idx = distributed_indices(len(ds), self.rank, self.world_size)
        if limit:
            idx = idx[:limit]
        loader = DataLoader(ds, idx, int(cfg.data.get("batch_size", 32)), transform=None,
                            num_workers=int(cfg.data.get("num_workers", 4)))
        writers = {r: ResultWriter(res_files[r], self.rank, self.world_size) for r in pending}
        if decoder == "opencv" or any(r.startswith("opencv") for r in pending):
            import cv2  # noqa: F401  (loaded here, not inside a timed decode or resize)
        self.maybe_deploy()
        t_start = time.time()
        for batch in loader:
            for ri, r in enumerate(pending):
                t0 = time.perf_counter()
                logits = self.eval_fn(np.ascontiguousarray(batch.image[:, ri])).cpu().numpy()
                self.timings["device_batch_s"].append(time.perf_counter() - t0)
                for i in range(len(batch.mask)):
                    if batch.mask[i]:
                        writers[r].write({"score": logits[i].tolist(),
                                          "label": int(batch.label[i])})
        n = len(idx)
        logger.info("ImageNet-S %s: %d images × %d resize modes in %.2fs", decoder, n,
                    len(pending), time.time() - t_start)
        for w in writers.values():
            w.merge()
        self.timings["images"] = n
        self.timings["host_decode_s"][decoder] = spent.pop("decode") / max(n, 1)
        for r, s in spent.items():
            self.timings["host_resize_s"].setdefault(r, []).append(s / max(n, 1))

    def _resolve_data(self, test_cfg, input_size):
        if self.cfg.data.get("read_from") == "fake":
            # synthesize a small JPEG val set once
            n = int(self.cfg.data.get("fake_size", 8))
            tmp_root = test_cfg.get("fake_root") or osp.join(tempfile.gettempdir(),
                                                              f"robustart_s_fake_{n}")
            meta = osp.join(tmp_root, "meta.txt")
            if not osp.exists(meta):
                os.makedirs(tmp_root, exist_ok=True)
                rng = np.random.default_rng(0)
                with open(meta + ".part", "w") as f:
                    for i in range(n):
                        arr = rng.integers(0, 255, size=(280, 320, 3), dtype=np.uint8)
                        name = f"img_{i}.jpg"
                        Image.fromarray(arr).save(osp.join(tmp_root, name), "JPEG", quality=92)
                        f.write(f"{name} {i % 10}\n")
                os.replace(meta + ".part", meta)
            return tmp_root, meta
        return test_cfg["root_dir"], test_cfg["meta_file"]


def main(argv=None):
    parser = standard_solver_argparser("robustart multi_eval_decoder_resize_solver (ImageNet-S)")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; 'cpu' runs the plain versions)")
    args = parser.parse_args(argv)
    solver = MultiEvalDecoderResizeSolver(args.config, evaluate_only=True, device=args.device)
    return solver.evaluate(args.ckpt_filePath)


if __name__ == "__main__":
    main()
