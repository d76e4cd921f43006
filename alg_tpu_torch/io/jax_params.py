"""Carry a JAX-package parameter tree into the port's modules.

The tree is ``alg_tpu``'s nested dict of numpy arrays (after
``jax.device_get``) for the CogVideoX DiT, the T5 encoder or the CogVideoX
VAE. Module attribute names follow the tree's keys, so the mapping is by
rule:

  * the weight-stacked DiT ``blocks`` (leading layer axis) are unstacked into
    ``blocks.<i>``; lists (T5 blocks, VAE stages and resnets) are indexed;
  * ``kernel`` becomes ``weight``: ``[in, out]`` transposed to ``[out, in]``,
    DHWIO conv kernels to ``[out, in, D, H, W]``, HWIO to ``[out, in, H, W]``;
  * ``scale`` becomes ``weight``; ``bias`` stays;
  * any other array leaf (T5 ``embed``, the shared ``relative_attention_bias``
    table) is an embedding and becomes ``<name>.weight`` as it is.

Missing or unused keys and shape mismatches raise.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np
import torch
from torch import nn

_KERNEL_PERM = {2: (1, 0), 4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}


def _leaf(prefix: str, key: str, arr) -> Tuple[str, np.ndarray]:
    arr = np.asarray(arr)
    if key == "kernel":
        if arr.ndim not in _KERNEL_PERM:
            raise ValueError(f"{prefix}kernel: no layout rule for a {arr.ndim}-D kernel")
        return prefix + "weight", arr.transpose(_KERNEL_PERM[arr.ndim])
    if key == "scale":
        return prefix + "weight", arr
    if key == "bias":
        return prefix + "bias", arr
    return prefix + key + ".weight", arr


def flatten_jax_tree(tree, prefix: str = "") -> Iterator[Tuple[str, np.ndarray]]:
    """(state-dict name, array in torch layout) for every leaf of ``tree``."""
    for key, val in tree.items():
        if isinstance(val, dict):
            if key == "blocks":  # weight-stacked layers: leading axis is the layer
                n = len(next(iter(_leaves(val))))
                for i in range(n):
                    yield from flatten_jax_tree(_index(val, i), f"{prefix}blocks.{i}.")
            else:
                yield from flatten_jax_tree(val, f"{prefix}{key}.")
        elif isinstance(val, (list, tuple)):
            for i, item in enumerate(val):
                yield from flatten_jax_tree(item, f"{prefix}{key}.{i}.")
        else:
            yield _leaf(prefix, key, val)


def _leaves(tree):
    for val in tree.values():
        if isinstance(val, dict):
            yield from _leaves(val)
        else:
            yield val


def _index(tree, i: int):
    return {k: _index(v, i) if isinstance(v, dict) else np.asarray(v)[i] for k, v in tree.items()}


@torch.no_grad()
def load_jax_params(module: nn.Module, tree) -> nn.Module:
    """Copy ``tree`` into ``module``'s parameters (cast to their dtype and
    device); raises on missing or unused keys and on shape mismatches."""
    flat = dict(flatten_jax_tree(tree))
    state = module.state_dict()
    missing, unused = sorted(set(state) - set(flat)), sorted(set(flat) - set(state))
    if missing or unused:
        raise KeyError(f"parameter trees differ: missing {missing[:8]} ({len(missing)}), "
                       f"unused {unused[:8]} ({len(unused)})")
    for name, arr in flat.items():
        dst = state[name]
        if tuple(arr.shape) != tuple(dst.shape):
            raise ValueError(f"{name}: shape {tuple(arr.shape)} does not fit {tuple(dst.shape)}")
        if arr.dtype.name == "bfloat16":  # from_numpy has no ml_dtypes bf16; fp32 holds it exactly
            arr = arr.astype(np.float32)
        dst.copy_(torch.from_numpy(np.ascontiguousarray(arr)))
    return module
