"""Carry a JAX-package parameter tree into the port's modules.

The tree is ``alg_tpu``'s nested dict of numpy arrays (after
``jax.device_get``) for the CogVideoX, Wan or HunyuanVideo DiT, the T5 /
UMT5 encoder, the CLIP vision tower or text model, Llama or Llava, or one of
the three VAEs. Module attribute names follow the tree's keys, so the
mapping is by rule:

  * the weight-stacked DiT containers (a dict named ``blocks``,
    ``transformer_blocks`` or ``single_transformer_blocks`` whose leaves have
    a leading layer axis) are unstacked into ``<name>.<i>``; lists (T5,
    Llama and token-refiner blocks, CLIP layers, VAE stages and resnets) are
    indexed; an empty dict (an affine-free norm) holds nothing;
  * ``kernel`` becomes ``weight``: ``[in, out]`` transposed to ``[out, in]``,
    DHWIO conv kernels to ``[out, in, D, H, W]``, HWIO to ``[out, in, H, W]``;
  * ``scale`` becomes ``weight``; ``bias`` stays;
  * a quantized linear of ``alg_tpu/ops/quant.py`` (``kernel_q`` with
    ``w_scale``, or ``kernel_q4`` with ``w_scale4`` and ``w_scale``) becomes a
    :class:`~alg_tpu_torch.models.layers.QuantizedLinear` in the linear's
    place: ``kernel_q`` -> ``weight_q`` and ``kernel_q4`` -> ``weight_q4``
    (``[in, out]`` / ``[in/2, out]`` transposed; the int4 codes stay packed
    along IN), ``w_scale4`` ``[G, out]`` transposed, ``w_scale`` ``[1, out]``
    flattened;
  * plain tables keep their name and layout: ``scale_shift_table``, the Wan
    VAE's ``gamma``, CLIP's ``class_embedding`` and ``position_embedding``;
  * any other array leaf (T5's and Llama's ``embed``, CLIP text's
    ``token_embedding``, a ``relative_attention_bias`` table) is an embedding
    and becomes ``<name>.weight`` as it is.

Missing or unused keys and shape mismatches raise.

LoRA adapter trees need no mapping: the port keys and lays them out as the
JAX package does (:func:`load_jax_lora`, :func:`lora_to_jax`).
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np
import torch
from torch import nn

_KERNEL_PERM = {2: (1, 0), 4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}
_PLAIN_TABLES = ("scale_shift_table", "gamma", "class_embedding", "position_embedding")
_STACKED = ("blocks", "transformer_blocks", "single_transformer_blocks")  # as dicts; the same names as lists are lists


_QUANTIZED = {"kernel_q": "weight_q", "kernel_q4": "weight_q4", "w_scale": "w_scale", "w_scale4": "w_scale4"}


def leaf_name(prefix: str, key: str) -> str:
    """The module's name for the tree leaf ``key`` under ``prefix``."""
    if key in ("kernel", "scale"):
        return prefix + "weight"
    if key in _QUANTIZED:
        return prefix + _QUANTIZED[key]
    if key == "bias" or key in _PLAIN_TABLES:
        return prefix + key
    return prefix + key + ".weight"


def _leaf(prefix: str, key: str, arr) -> Tuple[str, np.ndarray]:
    arr = np.asarray(arr)
    if key == "kernel":
        if arr.ndim not in _KERNEL_PERM:
            raise ValueError(f"{prefix}kernel: no layout rule for a {arr.ndim}-D kernel")
        arr = arr.transpose(_KERNEL_PERM[arr.ndim])
    elif key in ("kernel_q", "kernel_q4", "w_scale4"):
        arr = arr.T
    elif key == "w_scale":
        arr = arr.reshape(-1)
    return leaf_name(prefix, key), arr


def flatten_jax_tree(tree, prefix: str = "") -> Iterator[Tuple[str, np.ndarray]]:
    """(state-dict name, array in torch layout) for every leaf of ``tree``."""
    for key, val in tree.items():
        if isinstance(val, dict):
            if key in _STACKED:  # weight-stacked layers: leading axis is the layer
                n = len(next(iter(_leaves(val))))
                for i in range(n):
                    yield from flatten_jax_tree(_index(val, i), f"{prefix}{key}.{i}.")
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
def copy_state_(module: nn.Module, flat) -> nn.Module:
    """Copy ``flat`` (state-dict name -> tensor or numpy array) into
    ``module``'s parameters, cast to their dtype and device; raises on
    missing or unused names and on shape mismatches."""
    state = module.state_dict()
    missing, unused = sorted(set(state) - set(flat)), sorted(set(flat) - set(state))
    if missing or unused:
        raise KeyError(f"parameter trees differ: missing {missing[:8]} ({len(missing)}), "
                       f"unused {unused[:8]} ({len(unused)})")
    for name, src in flat.items():
        dst = state[name]
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"{name}: shape {tuple(src.shape)} does not fit {tuple(dst.shape)}")
        if not isinstance(src, torch.Tensor):
            if src.dtype.name == "bfloat16":  # from_numpy has no ml_dtypes bf16; fp32 holds it exactly
                src = src.astype(np.float32)
            src = torch.from_numpy(np.ascontiguousarray(src))
        dst.copy_(src)
    return module


def _swap_quantized_(module: nn.Module, flat) -> None:
    """Put a :class:`QuantizedLinear` wherever ``flat`` holds a quantized
    weight and ``module`` a linear."""
    from alg_tpu_torch.models.layers import QuantizedLinear

    for name in flat:
        path, _, leaf = name.rpartition(".")
        if leaf not in ("weight_q", "weight_q4"):
            continue
        parent_path, _, attr = path.rpartition(".")
        parent = module.get_submodule(parent_path)
        linear = getattr(parent, attr)
        if isinstance(linear, nn.Linear):
            setattr(parent, attr, QuantizedLinear(linear.in_features, linear.out_features,
                                                  "w8" if leaf == "weight_q" else "w4", bias=linear.bias is not None,
                                                  device=linear.weight.device, dtype=linear.weight.dtype))


def load_jax_params(module: nn.Module, tree) -> nn.Module:
    """Copy ``tree`` into ``module``'s parameters (cast to their dtype and
    device), the linears that ``tree`` holds quantized made
    :class:`~alg_tpu_torch.models.layers.QuantizedLinear` first; raises on
    missing or unused keys and on shape mismatches."""
    flat = dict(flatten_jax_tree(tree))
    _swap_quantized_(module, flat)
    return copy_state_(module, flat)


def load_jax_lora(tree, device="cpu", requires_grad: bool = True):
    """A JAX-package LoRA tree (``alg_tpu.training.init_lora_params``, as
    numpy) as the port's adapters: same keys (``"blocks/attn/to_q"``) and
    layouts (``A [L, in, r]``, ``B [L, r, out]``), fp32 leaf tensors on
    ``device`` that require a gradient."""
    return {path: {name: torch.tensor(np.asarray(arr, dtype=np.float32), device=device,
                                      requires_grad=requires_grad) for name, arr in ab.items()}
            for path, ab in tree.items()}


def lora_to_jax(loras):
    """The port's adapters as the numpy tree the JAX package takes."""
    return {path: {name: t.detach().float().cpu().numpy() for name, t in ab.items()} for path, ab in loras.items()}
