"""Datasets: meta-file ("path label" lines) and synthetic fake backend.

Counterpart of ``robustart_tpu/data/dataset.py``. ``data.read_from`` takes
the reference vocabulary: ``fs`` (root_dir + meta_file), ``fake``
(deterministic synthetic images, no bytes on disk) and ``mc`` / ``osg``
(cluster stores in the reference, mapped to ``fs`` with a warning).
"""

from __future__ import annotations

import os.path as osp
from typing import Any

import numpy as np
from PIL import Image

from robustart_torch.core.logging import get_logger

logger = get_logger(__name__)


class MetaFileDataset:
    """root_dir + meta_file dataset of (image, label) pairs.

    Images are files PIL decodes, or ``.npy`` arrays; ``.mp4``, ``.avi``
    and ``.webm`` files are videos (ImageNet-P's published form), read by
    :func:`_read_video` as (F, H, W, 3) arrays.
    """

    def __init__(self, root_dir: str, meta_file: str, image_reader: str = "pil"):
        self.root_dir = root_dir
        self.meta_file = meta_file
        self.image_reader = image_reader
        self.metas: list[tuple[str, int]] = []
        with open(meta_file) as f:
            for line in f:
                line = line.rstrip()
                if not line:
                    continue
                filename, label = line.split()
                self.metas.append((filename, int(label)))
        self.labels = np.array([label for _, label in self.metas])

    def __len__(self) -> int:
        return len(self.metas)

    def __getitem__(self, idx: int) -> dict[str, Any]:
        filename, label = self.metas[idx]
        path = osp.join(self.root_dir, filename)
        if filename.endswith(".npy"):
            img = np.load(path)
        elif filename.endswith((".mp4", ".avi", ".webm")):
            img = _read_video(path)
        else:
            with Image.open(path) as pil:
                img = pil.convert("RGB")
                img.load()
        return {"image": img, "label": label, "filename": filename, "index": idx}


def _read_video(path: str) -> np.ndarray:
    """Decode a video file to (F, H, W, 3) RGB uint8 with OpenCV, as the
    JAX package does. cv2 is imported here, and only here: nothing else of
    the port needs it."""
    try:
        import cv2
    except ImportError as exc:
        raise ImportError(
            f"reading the video {path} needs OpenCV (the cv2 module), which is not "
            "installed; store the videos as .npy (F, H, W, 3) arrays instead"
        ) from exc

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise IOError(f"cannot open video {path}")
    frames = []
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
    finally:
        cap.release()
    if not frames:
        raise IOError(f"no frames decoded from {path}")
    return np.stack(frames)


class FakeDataset:
    """Deterministic synthetic dataset (``read_from: fake``).

    Image i is seeded by (seed, i), so it is the same image the JAX
    package's ``FakeDataset`` yields.
    """

    def __init__(
        self,
        size: int = 256,
        image_size: int = 224,
        num_classes: int = 1000,
        seed: int = 0,
    ):
        self.size = size
        self.image_size = image_size
        self.num_classes = num_classes
        self.seed = seed
        self.labels = np.arange(size) % num_classes

    def __len__(self) -> int:
        return self.size

    def __getitem__(self, idx: int) -> dict[str, Any]:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, idx]))
        # low-frequency random image (distinguishes classes weakly; cheap)
        small = rng.integers(0, 256, size=(8, 8, 3), dtype=np.uint8)
        img = np.asarray(
            Image.fromarray(small).resize(
                (self.image_size, self.image_size), Image.BILINEAR
            )
        )
        return {
            "image": img,
            "label": int(self.labels[idx]),
            "filename": f"fake_{idx}.jpg",
            "index": idx,
        }


def build_dataset(data_cfg, split_cfg, input_size: int):
    """Build a dataset from the reference config vocabulary."""
    read_from = data_cfg.get("read_from", "fs")
    if read_from in ("mc", "osg"):
        logger.warning(
            "read_from=%s maps to the filesystem reader in this build", read_from
        )
        read_from = "fs"
    if read_from == "fake":
        return FakeDataset(
            size=int(data_cfg.get("fake_size", 256)),
            image_size=input_size,
            num_classes=int(data_cfg.get("fake_num_classes", 1000)),
            seed=int(data_cfg.get("fake_seed", 0)),
        )
    if read_from == "fs":
        return MetaFileDataset(
            root_dir=split_cfg["root_dir"],
            meta_file=split_cfg["meta_file"],
            image_reader=split_cfg.get("image_reader", {}).get("type", "pil"),
        )
    raise ValueError(f"unknown read_from {read_from!r}")
