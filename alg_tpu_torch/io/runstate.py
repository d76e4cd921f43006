"""Resumable denoise runs (counterpart of ``alg_tpu/io/runstate.py``).

An atomic, fingerprinted on-disk snapshot of a sampler's carry. Everything
before the denoise loop (prompt embeddings, the VAE-encoded condition, the
initial noise and every per-step noise stack: DPM, stochastic DDIM, the
pixel-space posterior draws) follows from the call's arguments and seed, so
a snapshot holds only ``(next step, carry leaves)``: a resumed call redoes
the prefix and starts the loop at the saved step. The result equals an
uninterrupted run's bit for bit where the prefix is deterministic.

The carries are nested tuples of tensors (a NamedTuple such as the UniPC
state counts as a tuple): CogVideoX ``(latents, old_pred[, prev_pred])``,
Wan ``(latents, UniPC state[, prev_pred])``, Hunyuan ``latents`` or
``(latents, prev_pred)``. Leaves are stored in depth-first order, as
``jax.tree_util`` flattens the same tuples, in ``alg_tpu``'s file layout.

* A save writes a temporary file in the same directory and renames it over
  the snapshot (``os.replace``). The temporary name is hidden (a leading
  dot) and unique to the writer (``tempfile.mkstemp``), so no other writer
  and no ``*`` sweep of the directory can take it away mid-write.
* A snapshot written for other arguments (another fingerprint), or whose
  leaves do not fit the live carry in shape and dtype, or that cannot be
  read, starts a fresh run with a warning, never an error.
* :meth:`RunCheckpoint.complete` removes the snapshot when the run ends.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import tempfile
import zipfile
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

log = logging.getLogger(__name__)


def run_fingerprint(kind: str, **args: Any) -> str:
    """Stable hash of the arguments that define a run, each reduced with
    ``repr`` (strings, scalars, small tuples); arrays passed directly are
    not hashed: the carry's shape and dtype check covers them."""
    payload = json.dumps({"kind": kind, **{k: repr(v) for k, v in args.items()}}, sort_keys=True)
    return hashlib.sha256(payload.encode()).hexdigest()[:32]


def flatten(carry) -> List[torch.Tensor]:
    """The carry's tensors, depth first."""
    if isinstance(carry, (tuple, list)):
        return [leaf for part in carry for leaf in flatten(part)]
    return [carry]


def unflatten(template, leaves: List[torch.Tensor]):
    """A carry shaped as ``template`` with ``leaves`` (depth first) in it."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, (tuple, list)):
            parts = [build(p) for p in node]
            return type(node)(*parts) if hasattr(node, "_fields") else type(node)(parts)
        return next(it)

    return build(template)


def _torch_dtype(dtype: np.dtype) -> Optional[torch.dtype]:
    try:
        return torch.from_numpy(np.empty(0, dtype)).dtype
    except TypeError:  # no torch counterpart (strings, objects)
        return None


class RunCheckpoint:
    """On-disk snapshot of a sampler carry, saved every ``every`` steps.

    A pipeline calls :meth:`restore` once with its fresh initial carry (the
    template), :meth:`maybe_save` after each step, and :meth:`complete` when
    the loop ends (removes the file unless ``keep``)."""

    def __init__(self, path: str, fingerprint: str = "", every: int = 8, keep: bool = False):
        self.path = str(path)
        self.fingerprint = fingerprint
        self.every = max(1, int(every))
        self.keep = bool(keep)
        self._last_saved: Optional[int] = None

    def restore(self, carry) -> Tuple[int, Any]:
        """``(start step, carry)``: the leaves from disk, on the template's
        devices, where a valid snapshot with this fingerprint exists, else
        ``(0, carry)`` unchanged."""
        if not os.path.exists(self.path):
            return 0, carry
        try:
            with np.load(self.path) as z:
                if str(z["fingerprint"]) != self.fingerprint:
                    log.warning("runstate %s: fingerprint mismatch (different generation args): starting fresh",
                                self.path)
                    return 0, carry
                step = int(z["step"])
                saved = [z[f"leaf_{i}"] for i in range(int(z["n_leaves"]))]
        except (OSError, EOFError, KeyError, ValueError, zipfile.BadZipFile) as e:  # truncated or foreign
            log.warning("runstate %s: unreadable (%s): starting fresh", self.path, e)
            return 0, carry
        live = flatten(carry)
        if len(live) != len(saved) or any(
                tuple(s.shape) != tuple(c.shape) or _torch_dtype(s.dtype) != c.dtype for s, c in zip(saved, live)):
            log.warning("runstate %s: carry structure mismatch: starting fresh", self.path)
            return 0, carry
        self._last_saved = step
        log.info("runstate %s: resuming the denoise loop at step %d", self.path, step)
        return step, unflatten(carry, [torch.from_numpy(s).to(c.device) for s, c in zip(saved, live)])

    def maybe_save(self, next_step: int, carry) -> None:
        """Save when ``next_step`` is at least ``every`` steps past the last save."""
        if self._last_saved is not None and next_step - self._last_saved < self.every:
            return
        self.save(next_step, carry)

    def save(self, next_step: int, carry) -> None:
        arrs = {f"leaf_{i}": leaf.detach().cpu().numpy() for i, leaf in enumerate(flatten(carry))}
        d = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(prefix=f".{os.path.basename(self.path)}.", suffix=".partial", dir=d)
        try:
            with os.fdopen(fd, "wb") as f:  # a file object: np.savez appends no ".npz"
                np.savez(f, step=np.int64(next_step), n_leaves=np.int64(len(arrs)), fingerprint=self.fingerprint,
                         **arrs)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
        except BaseException:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise
        self._last_saved = next_step

    def complete(self) -> None:
        """The run finished: drop the snapshot (unless ``keep``)."""
        if self.keep:
            return
        try:
            os.remove(self.path)
        except FileNotFoundError:
            pass


def as_checkpoint(checkpoint, fingerprint: str, every: int) -> Optional[RunCheckpoint]:
    """A pipeline's ``checkpoint=`` argument (a path or a
    :class:`RunCheckpoint`) as a :class:`RunCheckpoint`."""
    if checkpoint is None:
        return None
    if isinstance(checkpoint, RunCheckpoint):
        if not checkpoint.fingerprint:
            checkpoint.fingerprint = fingerprint
        return checkpoint
    return RunCheckpoint(str(checkpoint), fingerprint, every=every)
