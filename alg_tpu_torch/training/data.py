"""Training input pipeline (counterpart of ``alg_tpu/training/data.py``): a
directory of per-example ``.npz`` latent files and a host-side prefetch.

Training runs over precomputed latents, so an example is one ``.npz`` of
small tensors and the input pipeline is host work: read, stack, copy to the
device. :func:`prefetch` overlaps it with the step: a daemon thread pulls
batches from the iterator, turns them into tensors (pinned host memory and a
non-blocking copy when the target is a CUDA device) and hands them over a
small bounded queue. Exceptions in the worker propagate to the consumer; the
queue depth bounds host memory.
"""

from __future__ import annotations

import glob
import os
import queue
import threading
from typing import Iterator

import numpy as np
import torch


class LatentDataset:
    """Directory of per-example ``.npz`` files with the loss's batch keys
    (file list sorted for determinism)."""

    def __init__(self, data_dir: str, mmap: bool = True):
        self.files = sorted(glob.glob(os.path.join(data_dir, "*.npz")))
        if not self.files:
            raise FileNotFoundError(f"no .npz examples under {data_dir}")
        self.mmap = mmap
        with np.load(self.files[0]) as z:
            self.keys = sorted(z.files)

    def __len__(self) -> int:
        return len(self.files)

    def example(self, i: int) -> dict:
        # a zipped npz cannot be memory-mapped; np.load then reads it whole
        with np.load(self.files[i], mmap_mode="r" if self.mmap else None) as z:
            if sorted(z.files) != self.keys:
                raise ValueError(f"{self.files[i]}: keys {sorted(z.files)} != {self.keys}")
            return {k: np.asarray(z[k]) for k in z.files}

    def batches(self, batch_size: int, steps: int, seed: int, start: int = 0) -> Iterator[dict]:
        """``steps`` host batches: shuffled epochs, stacked leading axis.
        ``start`` skips batches without reading files, so a resumed run sees
        the same data order."""
        rng = np.random.RandomState(seed)
        order: list = []
        for step in range(steps):
            while len(order) < batch_size:
                epoch = list(range(len(self.files)))
                rng.shuffle(epoch)
                order.extend(epoch)
            idx, order = order[:batch_size], order[batch_size:]
            if step < start:
                continue
            examples = [self.example(i) for i in idx]
            yield {k: np.stack([ex[k] for ex in examples]) for k in self.keys}


class _Stop:
    pass


def to_device(batch: dict, device) -> dict:
    """A host batch (numpy arrays) as tensors on ``device``: through pinned
    memory and a non-blocking copy for a CUDA device."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.require(v, requirements=["C", "W"]))  # a memory-mapped example is read-only
        out[k] = t.pin_memory().to(device, non_blocking=True) if device.type == "cuda" else t.to(device)
    return out


def prefetch(batch_iter: Iterator[dict], depth: int = 2, device="cuda", mesh=None) -> Iterator[dict]:
    """Background-thread prefetch: host batches -> tensors on ``device``,
    ``depth`` ahead of the consumer; with a ``mesh``, only this rank's dp
    rows of each batch (``training.train.shard_batch``)."""
    if mesh is not None:
        from alg_tpu_torch.training.train import shard_batch

        batch_iter = (shard_batch(b, mesh) for b in batch_iter)
    q: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))

    def worker():
        try:
            for batch in batch_iter:
                q.put(to_device(batch, device))
            q.put(_Stop)
        except BaseException as e:  # propagate into the consumer
            q.put(e)

    threading.Thread(target=worker, daemon=True, name="alg-torch-prefetch").start()
    while True:
        item = q.get()
        if item is _Stop:
            return
        if isinstance(item, BaseException):
            raise item
        yield item
