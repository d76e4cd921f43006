"""Training checkpoint/resume and EMA (counterpart of
``alg_tpu/training/checkpoint.py``).

One ``.npz`` per checkpoint holds the trainable tree, the optimizer state
(AdamW moments and count), the optional EMA shadow tree and the step
counter. Tree structure is not stored: arrays are keyed by flattened index
(``opt/0000`` ...) and restored into the structure, dtypes and devices of a
template tree, which a run can always rebuild from its config. A resumed run
continues bit for bit.

EMA: an fp32 shadow of the trainable tree, ``ema = d·ema + (1−d)·p`` after
each step, updated in place.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import numpy as np
import torch

from alg_tpu_torch.training.train import to_numpy, tree_leaves, tree_map, tree_unflatten


def make_ema_update(decay: float):
    """``ema_update(ema, params) -> ema`` (the shadow is updated in place)."""

    @torch.no_grad()
    def update(ema, params):
        for e, p in zip(tree_leaves(ema), tree_leaves(params)):
            e.mul_(decay).add_(p.to(e.dtype) * (1.0 - decay))
        return ema

    return update


def init_ema(params):
    """Float32 shadow copy of the trainable tree (a real copy: the update
    works in place)."""
    return tree_map(lambda p: p.detach().to(torch.float32, copy=True), params)


def _flatten(tag: str, tree) -> dict:
    return {f"{tag}/{i:04d}": to_numpy(leaf) for i, leaf in enumerate(tree_leaves(tree))}


def _unflatten(tag: str, data: dict, like):
    out = []
    for i, leaf in enumerate(tree_leaves(like)):
        arr = data[f"{tag}/{i:04d}"]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"checkpoint {tag}[{i}]: saved shape {arr.shape} != expected {tuple(leaf.shape)}")
        t = torch.from_numpy(arr).to(device=leaf.device, dtype=leaf.dtype)
        out.append(t.requires_grad_(leaf.requires_grad))
    return tree_unflatten(like, out)


def save_train_state(path: str, step: int, trainable, opt_state, ema=None) -> None:
    """Write one checkpoint file (atomic rename, safe under preemption)."""
    data = {"step": np.asarray(step, np.int64)}
    data.update(_flatten("trainable", trainable))
    data.update(_flatten("opt", opt_state))
    if ema is not None:
        data.update(_flatten("ema", ema))
    tmp = path + ".tmp"
    np.savez(tmp, **data)
    if not tmp.endswith(".npz"):  # np.savez appends .npz to names without it
        tmp += ".npz"
    os.replace(tmp, path)


def load_train_state(path: str, trainable_like, opt_state_like, ema_like=None):
    """Restore ``(step, trainable, opt_state, ema)`` into template structures.

    ``ema_like`` may be passed even when the file has no EMA (returns None);
    a file with an EMA restored without ``ema_like`` raises."""
    with np.load(path) as z:
        data = {k: z[k] for k in z.files}
    step = int(data["step"])
    trainable = _unflatten("trainable", data, trainable_like)
    opt_state = _unflatten("opt", data, opt_state_like)
    has_ema = any(k.startswith("ema/") for k in data)
    if has_ema and ema_like is None:
        raise ValueError(f"{path} contains an EMA tree; pass ema_like to restore it")
    ema = _unflatten("ema", data, ema_like) if has_ema else None
    return step, trainable, opt_state, ema


_CKPT_RE = re.compile(r"^step_(\d+)\.npz$")


def checkpoint_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}.npz")


def _steps(ckpt_dir: str) -> list:
    return sorted(int(m.group(1)) for m in map(_CKPT_RE.match, os.listdir(ckpt_dir)) if m)


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """Path of the highest-step ``step_*.npz`` under ``ckpt_dir`` (or None)."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = _steps(ckpt_dir)
    return checkpoint_path(ckpt_dir, steps[-1]) if steps else None


def prune_checkpoints(ckpt_dir: str, keep: int) -> None:
    """Delete all but the newest ``keep`` checkpoints."""
    if keep <= 0 or not os.path.isdir(ckpt_dir):
        return
    for step in _steps(ckpt_dir)[:-keep]:
        os.remove(checkpoint_path(ckpt_dir, step))
