"""Batched, prefetching data loader (counterpart of
``robustart_tpu/data/loader.py``).

A thread pool decodes and transforms images; a producer thread keeps
``prefetch_factor`` uint8 NHWC batches ready on the host. Eval batches are
padded to full size with a validity mask so every step sees one shape.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Iterator

import numpy as np


class Batch(dict):
    """dict with attribute access: batch.image, batch.label, batch.mask."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e


class DataLoader:
    """Deterministic batched loader over (dataset, indices).

    Yields Batch dicts with:
      image: (B, H, W, 3) uint8
      label: (B,) int32
      index: (B,) int32 dataset indices
      mask:  (B,) bool — False on padding rows of the final batch
    """

    def __init__(
        self,
        dataset,
        indices: np.ndarray,
        batch_size: int,
        transform=None,
        num_workers: int = 4,
        prefetch_factor: int = 2,
        drop_last: bool = False,
    ):
        self.dataset = dataset
        self.indices = np.asarray(indices)
        self.batch_size = batch_size
        self.transform = transform
        self.num_workers = max(1, num_workers)
        self.prefetch_factor = max(1, prefetch_factor)
        self.drop_last = drop_last

    def __len__(self) -> int:
        n = len(self.indices)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _load_one(self, idx: int) -> dict[str, Any]:
        item = self.dataset[int(idx)]
        img = item["image"]
        if self.transform is not None:
            img = self.transform(img)
        img = np.asarray(img, dtype=np.uint8)
        return {"image": img, "label": item["label"], "index": item["index"]}

    def _make_batch(self, batch_indices: np.ndarray, executor) -> Batch:
        items = list(executor.map(self._load_one, batch_indices))
        n = len(items)
        bs = self.batch_size
        images = np.stack([it["image"] for it in items])
        labels = np.array([it["label"] for it in items], np.int32)
        idxs = np.array([it["index"] for it in items], np.int32)
        mask = np.ones((n,), bool)
        if n < bs:  # pad final batch to the static shape
            pad = bs - n
            images = np.concatenate([images, np.repeat(images[-1:], pad, 0)])
            labels = np.concatenate([labels, np.repeat(labels[-1:], pad)])
            idxs = np.concatenate([idxs, np.repeat(idxs[-1:], pad)])
            mask = np.concatenate([mask, np.zeros((pad,), bool)])
        return Batch(image=images, label=labels, index=idxs, mask=mask)

    def __iter__(self) -> Iterator[Batch]:
        n_batches = len(self)
        out_q: queue.Queue = queue.Queue(maxsize=self.prefetch_factor)
        stop = threading.Event()

        def put(item) -> bool:
            # bounded waits so a consumer that stopped early never strands
            # the producer on a full queue
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                with ThreadPoolExecutor(max_workers=self.num_workers) as executor:
                    for b in range(n_batches):
                        lo = b * self.batch_size
                        sel = self.indices[lo : lo + self.batch_size]
                        if not put(self._make_batch(sel, executor)):
                            return
                put(None)
            except BaseException as exc:  # surface worker errors, don't hang
                put(exc)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                batch = out_q.get()
                if batch is None:
                    return
                if isinstance(batch, BaseException):
                    raise batch
                yield batch
        finally:
            stop.set()
            thread.join(timeout=60)
