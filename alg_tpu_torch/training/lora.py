"""LoRA fine-tuning: trainable low-rank adapters over frozen base parameters
(counterpart of ``alg_tpu/training/lora.py``).

``W_eff = W + (α/r)·A@B`` with ``A ~ N(0, 1)/r`` and ``B = 0``, so the adapted
model starts at the base model; gradients flow only through A and B.

The adapter tree is keyed as the JAX package keys it, by the module's path in
that package's parameter tree, and a weight-stacked block container
(``blocks``, ``transformer_blocks``, ``single_transformer_blocks``) gets one
stacked adapter ``A [L, in, r]`` / ``B [L, r, out]``:
``{"blocks/attn/to_q": {"A": ..., "B": ...}}``. So :func:`to_peft_state` gives
the same arrays under the same names as the JAX package's, and a tree carries
over with ``io.jax_params``. The base parameters are the port's: a dict from
``module.named_parameters()`` names (``blocks.3.attn.to_q.weight``, ``[out,
in]``) to tensors, which the losses run through
``torch.func.functional_call``. :func:`apply_lora` returns such a dict with
merged weights, :func:`attach_lora` one with the adapters beside the untouched
weights (``<module>.lora_A`` / ``.lora_B``, read by ``models.layers.Linear``).

Over a quantized base (QLoRA: W8A8 / W4A8 block linears, ``ops/quant.py``)
the adapters attach and are never merged: :func:`lora_base` gives the base
with the quantized weights and scales, :func:`has_quantized_kernels` tells
it apart, and :func:`make_lora_loss` attaches over it by default.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

# attention/MLP projections across all three DiT families
DEFAULT_TARGETS: Tuple[str, ...] = (
    "to_q", "to_k", "to_v", "to_out",
    "add_q_proj", "add_k_proj", "add_v_proj", "to_add_out",
    "fc_in", "fc_out", "proj_mlp", "proj_out",
)

_STACKED = ("blocks", "transformer_blocks", "single_transformer_blocks")
# a linear's weight leaf, and how many IN values a stored column holds (two int4 codes a byte)
_KERNEL_LEAVES = {"weight": 1, "weight_q": 1, "weight_q4": 2}
# the port's quantized weights (ops/quant.py) and the JAX package's leaf names for them
_QUANTIZED_LEAVES = ("weight_q", "weight_q4", "kernel_q", "kernel_q4")


def has_quantized_kernels(params) -> bool:
    """True when the dict holds W8A8/W4A8 weights (the port's ``QuantizedLinear`` buffers or the JAX package's
    ``ops.quant`` leaf names)."""
    return any(name.rsplit(".", 1)[-1] in _QUANTIZED_LEAVES for name in params)


def lora_base(module: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The frozen base of a LoRA loss over ``module``: its parameters, and the
    weights and scales of its quantized linears (``ops.quant.QUANT_BUFFERS``),
    so that the adapters find those linears and the loss's ``compute_dtype``
    casts their scales as it casts the parameters."""
    from alg_tpu_torch.ops.quant import QUANT_BUFFERS

    base = dict(module.named_parameters())
    base.update((name, b) for name, b in module.named_buffers() if name.rsplit(".", 1)[-1] in QUANT_BUFFERS)
    return base


def _kernel(params, name: str) -> Tuple[Optional[str], Optional[torch.Tensor]]:
    """(leaf, stored weight) of the linear ``name`` in ``params``, or (None, None)."""
    for leaf in _KERNEL_LEAVES:
        if f"{name}.{leaf}" in params:
            return leaf, params[f"{name}.{leaf}"]
    return None, None


def _tree_path(module_name: str) -> Tuple[str, Optional[int]]:
    """``blocks.3.attn.to_q`` -> (``blocks/attn/to_q``, 3); a module outside
    the stacked containers keeps its list indices as ``[i]`` and has no layer."""
    parts = module_name.split(".")
    if parts[0] in _STACKED and len(parts) > 1 and parts[1].isdigit():
        return "/".join(parts[:1] + parts[2:]), int(parts[1])
    return "/".join(f"[{p}]" if p.isdigit() else p for p in parts), None


def _module_names(path: str, stacked_layers: Optional[int]) -> Iterator[Tuple[Optional[int], str]]:
    """(layer, module name) for an adapter path: the inverse of :func:`_tree_path`."""
    parts = [p.strip("[]") for p in path.split("/")]
    if stacked_layers is None:
        yield None, ".".join(parts)
    else:
        for i in range(stacked_layers):
            yield i, ".".join(parts[:1] + [str(i)] + parts[1:])


def _targets(params, targets: Sequence[str], prefixes=None) -> Dict[str, Dict[Optional[int], Tuple[int, int]]]:
    """{adapter path: {layer or None: (out, in)}} of every targeted linear, plain or quantized."""
    found: Dict[str, Dict[Optional[int], Tuple[int, int]]] = {}
    for name, w in params.items():
        parts = name.split(".")
        if len(parts) < 2 or parts[-1] not in _KERNEL_LEAVES or parts[-2] not in targets or w.dim() != 2:
            continue
        if prefixes is not None and parts[0] not in prefixes:
            continue
        path, layer = _tree_path(name[:-len(parts[-1]) - 1])
        found.setdefault(path, {})[layer] = (w.shape[0], w.shape[1] * _KERNEL_LEAVES[parts[-1]])
    return found


def init_lora_params(generator: torch.Generator, params, rank: int = 8,
                     targets: Sequence[str] = DEFAULT_TARGETS,
                     prefixes: Optional[Sequence[str]] = None) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{"path/to/module": {"A": [..., in, r], "B": [..., r, out]}}`` in fp32
    on the generator's device: A ~ N(0, 1)/r, B = 0.

    ``prefixes`` restricts adaptation to subtrees by the first path key, e.g.
    ``("blocks",)`` adapts the DiT block stack but not the output head."""
    loras = {}
    for path, layers in sorted(_targets(params, targets, prefixes).items()):
        out_dim, in_dim = next(iter(layers.values()))
        lead = () if None in layers else (len(layers),)
        a = torch.randn(lead + (in_dim, rank), generator=generator, device=generator.device) * (1.0 / rank)
        b = torch.zeros(lead + (rank, out_dim), device=generator.device)
        loras[path] = {"A": a, "B": b}
    if not loras:
        raise ValueError(f"no kernels matched targets {tuple(targets)}")
    return loras


def _adapter_slices(params, loras):
    """(module name, A [in, r], B [r, out]) for every adapted linear."""
    for path, ab in loras.items():
        a, b = ab["A"], ab["B"]
        for layer, name in _module_names(path, a.shape[0] if a.dim() == 3 else None):
            if _kernel(params, name)[0] is None:
                raise KeyError(f"adapter {path!r}: the base has no parameter {name}.weight")
            yield name, (a if layer is None else a[layer]), (b if layer is None else b[layer])


def apply_lora(params, loras, scale: float = 1.0):
    """A parameter dict with ``W + scale·A@B`` at every adapted linear.

    Differentiable in ``loras``; the base is untouched. ``scale`` is ``α/r``.
    The delta is computed in fp32 and cast to the weight's dtype. A quantized
    linear cannot take a merged delta without a float copy of its weight:
    adapting one raises (attach it, :func:`attach_lora`)."""
    out = dict(params)
    for name, a, b in _adapter_slices(params, loras):
        leaf, w = _kernel(params, name)
        if leaf != "weight":
            raise ValueError(f"{name} is quantized ({leaf}): attach its adapter (attach_lora), it cannot merge")
        out[name + ".weight"] = w + (torch.matmul(a, b) * scale).transpose(-1, -2).to(w.dtype)
    return out


def attach_lora(params, loras, scale: float = 1.0):
    """A parameter dict with unmerged adapters attached: each adapted module
    gains ``lora_A`` and ``lora_B·scale``, which ``models.layers.Linear``
    reads as ``y += (x·A)·B``. Same function as :func:`apply_lora`, but the
    base weights are neither copied nor differentiated; the QLoRA form over
    a quantized base."""
    out = dict(params)
    for name, a, b in _adapter_slices(params, loras):
        out[name + ".lora_A"] = a
        out[name + ".lora_B"] = b * scale
    return out


def make_lora_loss(loss_fn: Callable, base_params=None, scale: float = 1.0, attach: Optional[bool] = None) -> Callable:
    """``loss(loras, batch, draws)``: the full-parameter loss over a frozen
    base with the adapters as the trainable tree; feed it to
    ``training.train.make_train_step``.

    With ``base_params=None`` the loss takes the base as a trailing call
    argument, ``loss(loras, batch, draws, base)``, which the train step passes
    through. ``attach`` picks merged (:func:`apply_lora`, False) or attached
    (:func:`attach_lora`, True); by default it attaches exactly when the base
    is quantized, and it must be given when the base is a call argument."""
    if attach is None:
        if base_params is None:
            raise ValueError("attach must be given when the base is a call argument")
        attach = has_quantized_kernels(base_params)
    bind = attach_lora if attach else apply_lora

    if base_params is None:

        def lora_loss(loras, batch, draws, base):
            return loss_fn(bind(base, loras, scale), batch, draws)

    else:

        def lora_loss(loras, batch, draws):
            return loss_fn(bind(base_params, loras, scale), batch, draws)

    lora_loss.draw = getattr(loss_fn, "draw", None)
    return lora_loss


def to_peft_state(loras, block_paths: Dict[str, str], prefix: str = "transformer.") -> Dict[str, np.ndarray]:
    """Export adapters to the peft state-dict layout that
    ``io.lora.collect_lora_pairs`` parses: ``block_paths`` maps an adapter
    path to the diffusers module-name template with ``{i}`` for the layer;
    stacked adapters expand to per-layer entries; ``lora_A.weight`` is
    ``[r, in]`` and ``lora_B.weight`` ``[out, r]``."""
    state = {}
    for path, ab in loras.items():
        template = block_paths.get(path)
        if template is None:
            raise KeyError(f"no diffusers module template for adapter {path!r}")
        a, b = (np.asarray(torch.as_tensor(t).detach().float().cpu()) for t in (ab["A"], ab["B"]))
        layers = range(a.shape[0]) if a.ndim == 3 else (None,)
        for i in layers:
            name = prefix + template.format(i=0 if i is None else i)
            state[f"{name}.lora_A.weight"] = (a if i is None else a[i]).T
            state[f"{name}.lora_B.weight"] = (b if i is None else b[i]).T
    return state


# adapter path -> diffusers module template, per family
COGVIDEOX_PEFT_PATHS = {
    "blocks/attn/to_q": "transformer_blocks.{i}.attn1.to_q",
    "blocks/attn/to_k": "transformer_blocks.{i}.attn1.to_k",
    "blocks/attn/to_v": "transformer_blocks.{i}.attn1.to_v",
    "blocks/attn/to_out": "transformer_blocks.{i}.attn1.to_out.0",
    "blocks/ff/fc_in": "transformer_blocks.{i}.ff.net.0.proj",
    "blocks/ff/fc_out": "transformer_blocks.{i}.ff.net.2",
}

WAN_PEFT_PATHS = {
    "blocks/attn1/to_q": "blocks.{i}.attn1.to_q",
    "blocks/attn1/to_k": "blocks.{i}.attn1.to_k",
    "blocks/attn1/to_v": "blocks.{i}.attn1.to_v",
    "blocks/attn1/to_out": "blocks.{i}.attn1.to_out.0",
    "blocks/attn2/to_q": "blocks.{i}.attn2.to_q",
    "blocks/attn2/to_k": "blocks.{i}.attn2.to_k",
    "blocks/attn2/to_v": "blocks.{i}.attn2.to_v",
    "blocks/attn2/to_out": "blocks.{i}.attn2.to_out.0",
    "blocks/attn2/add_k_proj": "blocks.{i}.attn2.add_k_proj",
    "blocks/attn2/add_v_proj": "blocks.{i}.attn2.add_v_proj",
    "blocks/ffn/fc_in": "blocks.{i}.ffn.net.0.proj",
    "blocks/ffn/fc_out": "blocks.{i}.ffn.net.2",
}

HUNYUAN_PEFT_PATHS = {
    "transformer_blocks/attn/to_q": "transformer_blocks.{i}.attn.to_q",
    "transformer_blocks/attn/to_k": "transformer_blocks.{i}.attn.to_k",
    "transformer_blocks/attn/to_v": "transformer_blocks.{i}.attn.to_v",
    "transformer_blocks/attn/to_out": "transformer_blocks.{i}.attn.to_out.0",
    "transformer_blocks/attn/add_q_proj": "transformer_blocks.{i}.attn.add_q_proj",
    "transformer_blocks/attn/add_k_proj": "transformer_blocks.{i}.attn.add_k_proj",
    "transformer_blocks/attn/add_v_proj": "transformer_blocks.{i}.attn.add_v_proj",
    "transformer_blocks/attn/to_add_out": "transformer_blocks.{i}.attn.to_add_out",
    "transformer_blocks/ff/fc_in": "transformer_blocks.{i}.ff.net.0.proj",
    "transformer_blocks/ff/fc_out": "transformer_blocks.{i}.ff.net.2",
    "transformer_blocks/ff_context/fc_in": "transformer_blocks.{i}.ff_context.net.0.proj",
    "transformer_blocks/ff_context/fc_out": "transformer_blocks.{i}.ff_context.net.2",
    "single_transformer_blocks/attn/to_q": "single_transformer_blocks.{i}.attn.to_q",
    "single_transformer_blocks/attn/to_k": "single_transformer_blocks.{i}.attn.to_k",
    "single_transformer_blocks/attn/to_v": "single_transformer_blocks.{i}.attn.to_v",
    "single_transformer_blocks/proj_mlp": "single_transformer_blocks.{i}.proj_mlp",
    "single_transformer_blocks/proj_out": "single_transformer_blocks.{i}.proj_out",
}

# adapter scope per family: (path prefixes, diffusers templates)
FAMILY_PEFT = {
    "cogvideox": (("blocks",), COGVIDEOX_PEFT_PATHS),
    "wan": (("blocks",), WAN_PEFT_PATHS),
    "hunyuan": (("transformer_blocks", "single_transformer_blocks"), HUNYUAN_PEFT_PATHS),
}
