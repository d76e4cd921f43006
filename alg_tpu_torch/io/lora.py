"""Merge diffusers/peft-format LoRA weights into a DiT's parameters
(counterpart of ``alg_tpu/io/lora.py``).

For peft pairs ``<module>.lora_A.weight [r, in]`` / ``<module>.lora_B.weight
[out, r]`` the merge is ``W <- W + scale·(B @ A)`` on the port's ``[out, in]``
weights, computed in fp32 and cast to the weight's dtype. Parameters are a
dict from ``module.named_parameters()`` / ``state_dict()`` names to tensors;
the result is a new dict that shares every untouched tensor, to be loaded
with ``module.load_state_dict``. Merging costs nothing per sampler step, and
an adapter is unmerged by merging it again with ``-scale``.

An adapter trained with ``training.lora`` comes here through
``training.lora.to_peft_state``.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Sequence, Tuple

import numpy as np
import torch

# diffusers module name -> module path inside one block of the port's DiT
_COGVIDEOX_BLOCK_MAP = {
    "attn1.to_q": "attn.to_q",
    "attn1.to_k": "attn.to_k",
    "attn1.to_v": "attn.to_v",
    "attn1.to_out.0": "attn.to_out",
    "ff.net.0.proj": "ff.fc_in",
    "ff.net.2": "ff.fc_out",
    "norm1.linear": "norm1.linear",
    "norm2.linear": "norm2.linear",
}

_WAN_BLOCK_MAP = {
    "attn1.to_q": "attn1.to_q",
    "attn1.to_k": "attn1.to_k",
    "attn1.to_v": "attn1.to_v",
    "attn1.to_out.0": "attn1.to_out",
    "attn2.to_q": "attn2.to_q",
    "attn2.to_k": "attn2.to_k",
    "attn2.to_v": "attn2.to_v",
    "attn2.to_out.0": "attn2.to_out",
    "attn2.add_k_proj": "attn2.add_k_proj",
    "attn2.add_v_proj": "attn2.add_v_proj",
    "ffn.net.0.proj": "ffn.fc_in",
    "ffn.net.2": "ffn.fc_out",
}

_HUNYUAN_DOUBLE_BLOCK_MAP = {
    "attn.to_q": "attn.to_q",
    "attn.to_k": "attn.to_k",
    "attn.to_v": "attn.to_v",
    "attn.to_out.0": "attn.to_out",
    "attn.add_q_proj": "attn.add_q_proj",
    "attn.add_k_proj": "attn.add_k_proj",
    "attn.add_v_proj": "attn.add_v_proj",
    "attn.to_add_out": "attn.to_add_out",
    "ff.net.0.proj": "ff.fc_in",
    "ff.net.2": "ff.fc_out",
    "ff_context.net.0.proj": "ff_context.fc_in",
    "ff_context.net.2": "ff_context.fc_out",
    "norm1.linear": "norm1_linear",
    "norm1_context.linear": "norm1_context_linear",
}

_HUNYUAN_SINGLE_BLOCK_MAP = {
    "attn.to_q": "attn.to_q",
    "attn.to_k": "attn.to_k",
    "attn.to_v": "attn.to_v",
    "proj_mlp": "proj_mlp",
    "proj_out": "proj_out",
    "norm.linear": "norm_linear",
}


def _np(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return value.detach().float().cpu().numpy()
    return np.asarray(value)


def collect_lora_pairs(state: Mapping) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """{module_name: (A [r, in], B [out, r])} from a peft-style state dict.
    Accepts optional "transformer." prefixes and ".default" adapter infixes."""
    pairs: Dict[str, dict] = {}
    for key, value in state.items():
        m = re.match(r"(?:transformer\.)?(.*)\.lora_([AB])(?:\.default)?\.weight$", key)
        if m:
            pairs.setdefault(m.group(1), {})[m.group(2)] = _np(value)
    return {name: (p["A"], p["B"]) for name, p in pairs.items() if "A" in p and "B" in p}


def _merge(params: Mapping, pairs, scale: float, stacks: Sequence[Tuple[str, str, Mapping[str, str]]]):
    """Merge peft pairs into the block lists. ``stacks``: (diffusers prefix,
    the port's list name, module map) per block stack. Unmatched LoRA modules
    raise: a silent partial merge corrupts outputs."""
    out = dict(params)
    unmatched = []
    for name, (a, b) in pairs.items():
        target = None
        for prefix, list_name, module_map in stacks:
            m = re.match(rf"{prefix}\.(\d+)\.(.*)$", name)
            if m and m.group(2) in module_map:
                target = f"{list_name}.{int(m.group(1))}.{module_map[m.group(2)]}.weight"
                break
        if target is None or target not in params:
            unmatched.append(name)
            continue
        w = out[target]
        delta = torch.from_numpy((b.astype(np.float32) @ a.astype(np.float32)) * np.float32(scale))
        out[target] = (w.detach().float() + delta.to(w.device)).to(w.dtype)
    if unmatched:
        raise KeyError(f"LoRA modules with no mapping: {unmatched[:5]}{'...' if len(unmatched) > 5 else ''}")
    return out


def merge_lora_cogvideox(params, lora_state: Mapping, scale: float = 1.0):
    """New CogVideoX DiT parameter dict with the LoRA merged."""
    return _merge(params, collect_lora_pairs(lora_state), scale,
                  [("transformer_blocks", "blocks", _COGVIDEOX_BLOCK_MAP)])


def merge_lora_wan(params, lora_state: Mapping, scale: float = 1.0):
    """New Wan DiT parameter dict with the LoRA merged."""
    return _merge(params, collect_lora_pairs(lora_state), scale, [("blocks", "blocks", _WAN_BLOCK_MAP)])


def merge_lora_hunyuan(params, lora_state: Mapping, scale: float = 1.0):
    """New HunyuanVideo DiT parameter dict with the LoRA merged: both the
    double-stream and the single-stream stack."""
    return _merge(params, collect_lora_pairs(lora_state), scale, [
        ("transformer_blocks", "transformer_blocks", _HUNYUAN_DOUBLE_BLOCK_MAP),
        ("single_transformer_blocks", "single_transformer_blocks", _HUNYUAN_SINGLE_BLOCK_MAP),
    ])
