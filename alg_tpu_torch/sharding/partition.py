"""Megatron-style tensor parallelism for the three DiTs (counterpart of
``alg_tpu/sharding/partition.py``).

A spec tree maps every parameter name of a DiT (``named_parameters()``,
plus the codes and scales of its quantized linears) to a tuple with one
entry per tensor dim, in the port's ``[out, in]`` layout: ``None`` (whole)
or ``"tp"`` (split over the tp axis). Column-parallel linears (q/k/v,
``fc_in``) split their output rows, row-parallel ones (the attention output,
``fc_out``) their input columns; norms, modulation linears, embeddings and
the head are replicated, as in ``alg_tpu``. Two places where GSPMD did work
that the port does by hand:

* Wan's q/k RMS norms act on the whole inner dim after the column-parallel
  projection: their scales split with the columns and the norm all-reduces
  its sum of squares (``models.layers.TensorParallelRMSNorm``).
* HunyuanVideo's single-stream ``proj_out`` reads the concat of the
  head-sharded attention output and the tp-sharded MLP activations: its
  input axis splits as :class:`Segments` ``(dim, mlp)``, so a rank holds its
  columns of each segment rather than a contiguous slice of the concat.

:func:`add_pp` prefixes ``"pp"`` to the specs of the stacked blocks: the
layer index in the name stages over the pp axis (``alg_tpu``'s
``P("pp", ...)`` on the stacked layer axis). :func:`shard_params` slices a
tree to this rank's shards, :func:`gather_params` puts whole tensors back
together, and :func:`shard_transformer` builds a DiT that holds only this
rank's shards, with the parallel linears of ``models.layers``.
"""

from __future__ import annotations

import copy
import dataclasses
import re
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from alg_tpu_torch.models import layers as L
from alg_tpu_torch.sharding import collectives as C

BLOCK_KEYS = ("blocks", "transformer_blocks", "single_transformer_blocks")
_QUANT_BUFFERS = ("weight_q", "weight_q4", "w_scale4", "w_scale")
_VECTOR_LEAVES = ("bias", "w_scale")  # per-output leaves of a linear


@dataclasses.dataclass(frozen=True)
class Segments:
    """An input axis made of consecutive segments (in units of the concat's
    features) that each split over tp; a leaf whose axis is a multiple of
    the concat (W4's packed codes, its group scales) scales them."""

    sizes: Tuple[int, ...]


def _linear_spec(kind, leaf: str) -> tuple:
    if kind == "col":
        return ("tp",) if leaf in _VECTOR_LEAVES else ("tp", None)
    if leaf in _VECTOR_LEAVES:
        return ()
    return (None, "tp" if kind == "row" else kind)


def _specs(params, rules) -> Dict[str, tuple]:
    """``rules``: (module-path regex, kind) with kind ``"col"``, ``"row"``,
    ``"norm"`` or a :class:`Segments`; every other leaf is replicated."""
    specs = {}
    for name in params:
        module, _, leaf = name.rpartition(".")
        spec = ()
        for pattern, kind in rules:
            if re.fullmatch(pattern, module):
                spec = ("tp",) if kind == "norm" else _linear_spec(kind, leaf)
                break
        specs[name] = spec if spec else tuple(None for _ in params[name].shape)
    return specs


def cogvideox_transformer_specs(params) -> Dict[str, tuple]:
    """Specs for ``models.cogvideox.CogVideoXTransformer``'s parameters."""
    b = r"blocks\.\d+"
    return _specs(params, [(rf"{b}\.attn\.to_[qkv]", "col"), (rf"{b}\.attn\.to_out", "row"),
                           (rf"{b}\.ff\.fc_in", "col"), (rf"{b}\.ff\.fc_out", "row")])


def wan_transformer_specs(params) -> Dict[str, tuple]:
    """Specs for ``models.wan.WanTransformer``'s parameters: both attention
    streams Megatron-sharded, the q/k norm scales split with the columns."""
    a = r"blocks\.\d+\.attn[12]"
    return _specs(params, [(rf"{a}\.(to_[qkv]|add_[kv]_proj)", "col"), (rf"{a}\.to_out", "row"),
                           (rf"{a}\.(norm_q|norm_k|norm_added_k)", "norm"),
                           (r"blocks\.\d+\.ffn\.fc_in", "col"), (r"blocks\.\d+\.ffn\.fc_out", "row")])


def hunyuan_transformer_specs(params) -> Dict[str, tuple]:
    """Specs for ``models.hunyuan.HunyuanVideoTransformer``'s parameters:
    the double blocks' video and text projections, the single blocks' qkv,
    ``proj_mlp`` and segmented ``proj_out``; the per-head q/k norms, the
    modulation linears and the token refiner stay replicated."""
    d, s = r"transformer_blocks\.\d+", r"single_transformer_blocks\.\d+"
    rules = [(rf"{d}\.attn\.(to_[qkv]|add_[qkv]_proj)", "col"), (rf"{d}\.attn\.(to_out|to_add_out)", "row"),
             (rf"{d}\.(ff|ff_context)\.fc_in", "col"), (rf"{d}\.(ff|ff_context)\.fc_out", "row"),
             (rf"{s}\.attn\.to_[qkv]", "col"), (rf"{s}\.proj_mlp", "col")]
    biases = [n for n in params if re.fullmatch(rf"{s}\.proj_mlp\.(bias|w_scale)", n)]
    if biases:  # proj_out's input is [attention (dim), mlp activations]
        mlp = params[biases[0]].shape[0]
        dim = params[biases[0].replace("proj_mlp", "attn.to_q")].shape[0]
        rules.append((rf"{s}\.proj_out", Segments((dim, mlp))))
    return _specs(params, rules)


SPECS = {"cogvideox": cogvideox_transformer_specs, "wan": wan_transformer_specs,
         "hunyuan": hunyuan_transformer_specs}


_PER_HEAD = re.compile(r"(blocks|transformer_blocks|single_transformer_blocks)\.\d+\.attn\.norm_(q|k|added_q|added_k)\.")


def partial_over_tp(specs) -> set:
    """The replicated leaves that act on this rank's heads only: the
    per-head q/k norms of CogVideoX and HunyuanVideo. Their gradients are
    partial on each tp rank and are all-reduced over tp (GSPMD's reduction
    of a replicated parameter used in sharded compute)."""
    return {name for name, spec in specs.items()
            if _PER_HEAD.match(name) and not any(s is not None and s != "pp" for s in spec)}


def family_of_model(model: nn.Module) -> str:
    name = type(model).__name__
    for family, cls in (("cogvideox", "CogVideoXTransformer"), ("wan", "WanTransformer"),
                        ("hunyuan", "HunyuanVideoTransformer")):
        if name == cls:
            return family
    raise ValueError(f"no partition specs for {name}")


def add_pp(specs: Dict[str, tuple]) -> Dict[str, tuple]:
    """Stage the stacked block layers over the ``pp`` axis: ``"pp"`` before
    the spec of every leaf of a block (its layer index in the name decides
    its stage); the other leaves stay as given."""
    return {name: ("pp",) + spec if name.split(".", 1)[0] in BLOCK_KEYS else spec for name, spec in specs.items()}


def _layers(params) -> Dict[str, int]:
    """The number of layers of each block container in the names."""
    out: Dict[str, int] = {}
    for name in params:
        head, _, rest = name.partition(".")
        if head in BLOCK_KEYS:
            out[head] = max(out.get(head, 0), int(rest.split(".", 1)[0]) + 1)
    return out


def stage_of(name: str, layers: Dict[str, int], pp: int) -> int:
    head, _, rest = name.partition(".")
    n = layers[head]
    if n % pp:
        raise ValueError(f"num_layers={n} of {head} not divisible by pp={pp}")
    return int(rest.split(".", 1)[0]) // (n // pp)


def _segment_sizes(seg: Segments, length: int):
    total = sum(seg.sizes)
    if (length * seg.sizes[0]) % total:
        raise ValueError(f"an axis of {length} does not follow the segments {seg.sizes}")
    return [length * s // total for s in seg.sizes]


def _check_w4(name: str, x: torch.Tensor, dims: tuple, tp: int) -> None:
    """W4A8 row-parallel guard: a shard of packed codes along IN must keep
    whole 128-element quantization groups (``alg_tpu``'s check)."""
    if not name.endswith("weight_q4") or tp == 1 or len(dims) < 2 or dims[1] is None:
        return
    ins = [s * 2 for s in _segment_sizes(dims[1], x.shape[1])] if isinstance(dims[1], Segments) else [x.shape[1] * 2]
    for kin in ins:
        if kin % (128 * tp):
            raise ValueError(f"W4A8 row-parallel linear with in dim {kin} cannot shard over tp={tp}: quantization "
                             "groups (128) would straddle shards. Use mode='w8' for this model/tp combination.")


def _slice(x: torch.Tensor, dims: tuple, tp: int, r: int, name: str) -> torch.Tensor:
    for d, s in enumerate(dims):
        if s is None or tp == 1:
            continue
        if isinstance(s, Segments):
            parts = x.split(_segment_sizes(s, x.shape[d]), dim=d)
        else:
            parts = (x,)
        for p in parts:
            if p.shape[d] % tp:
                raise ValueError(f"{name}: dim {d} of {tuple(x.shape)} does not split over tp={tp}")
        x = torch.cat([p.chunk(tp, dim=d)[r] for p in parts], dim=d)
    return x


def shard_params(params, specs, mesh) -> Dict[str, torch.Tensor]:
    """This rank's shards of ``params`` (name -> tensor) under ``specs``:
    each leaf sliced over tp where its spec says so, and under :func:`add_pp`
    specs only the leaves of this rank's stage kept. The shards are new
    tensors on ``mesh.device`` (the whole ones are left as they are, and may
    lie on the host); a leaf that requires a gradient gives a leaf shard that
    requires one."""
    tp, r = mesh.size("tp"), mesh.local_rank("tp")
    layers = _layers(params)
    out = {}
    for name, x in params.items():
        spec = specs[name]
        if spec[:1] == ("pp",):
            spec = spec[1:]
            if not _on_stage(name, layers, mesh):
                continue
        _check_w4(name, x, spec, tp)
        shard = _slice(x.detach(), spec, tp, r, name).to(mesh.device, copy=True)
        out[name] = shard.requires_grad_(x.requires_grad) if shard.is_floating_point() else shard
    return out


def _on_stage(name: str, layers: Dict[str, int], mesh) -> bool:
    """Whether this rank's pp stage holds the tensor ``name`` (every tensor outside the blocks it does)."""
    pp = mesh.size("pp")
    return pp == 1 or name.split(".", 1)[0] not in BLOCK_KEYS or stage_of(name, layers, pp) == mesh.local_rank("pp")


def _unslice(x: torch.Tensor, dims: tuple, mesh) -> torch.Tensor:
    group, tp = mesh.group("tp"), mesh.size("tp")
    for d, s in enumerate(dims):
        if s is None or tp == 1:
            continue
        shards = C._all_gather(x, d, group).chunk(tp, dim=d)
        if isinstance(s, Segments):  # each shard holds its piece of every segment
            local = _segment_sizes(s, x.shape[d])
            pieces = [sh.split(local, dim=d) for sh in shards]
            x = torch.cat([torch.cat([p[i] for p in pieces], dim=d) for i in range(len(local))], dim=d)
        else:
            x = torch.cat(shards, dim=d)
    return x


@torch.no_grad()
def gather_params(params, specs, mesh) -> Dict[str, torch.Tensor]:
    """The whole tensors of a sharded tree (:func:`shard_params`' inverse),
    on every rank: tp shards all-gathered, the stages' blocks exchanged over
    pp. Every rank of the mesh calls it."""
    out = {}
    for name, x in params.items():
        spec = specs[name]
        out[name] = _unslice(x.detach(), spec[1:] if spec[:1] == ("pp",) else spec, mesh)
    if mesh.size("pp") > 1:
        staged = {n: t.cpu() for n, t in out.items() if specs[n][:1] == ("pp",)}
        for part in C.gather_objects(staged, mesh.group("pp")):
            out.update((n, t.to(mesh.device)) for n, t in part.items())
    return out


def transformer_specs(model: nn.Module) -> Dict[str, tuple]:
    """The specs of ``model``'s family over its parameters and quantized buffers."""
    return SPECS[family_of_model(model)](model_state(model))


def model_state(model: nn.Module) -> Dict[str, torch.Tensor]:
    """Parameters and the codes and scales of quantized linears, by name."""
    state = dict(model.named_parameters())
    state.update((n, b) for n, b in model.named_buffers() if n.rsplit(".", 1)[-1] in _QUANT_BUFFERS)
    return state


class RemoteBlock(nn.Module):
    """Stands in for a block that another pipeline stage holds."""

    def forward(self, *args):
        raise RuntimeError("this block lives on another pipeline stage: run the model inside "
                           "sharding.pipeline.pipeline_blocks")


_PARALLEL = {("col", False): L.ColumnParallelLinear, ("row", False): L.RowParallelLinear,
             ("col", True): L.ColumnParallelQuantizedLinear, ("row", True): L.RowParallelQuantizedLinear}


def _parallel_linear(module: nn.Module, kind: str, name: str, local, group) -> nn.Module:
    quantized = isinstance(module, L.QuantizedLinear)
    cls = _PARALLEL[(kind, quantized)]
    new = copy.copy(module)  # the module's attributes, with its own tensor dicts
    new.__class__ = cls
    new._parameters, new._buffers, new._modules = dict(module._parameters), dict(module._buffers), {}
    for leaf, value in list(new._parameters.items()) + list(new._buffers.items()):
        key = f"{name}.{leaf}"
        if value is None or key not in local:
            continue
        if leaf in new._parameters:
            new._parameters[leaf] = nn.Parameter(local[key], requires_grad=value.requires_grad)
        else:
            new._buffers[leaf] = local[key]
    out_leaf = "weight" if not quantized else ("weight_q" if module.w_scale4 is None else "weight_q4")
    w = new._parameters.get(out_leaf, new._buffers.get(out_leaf))
    new.out_features = w.shape[0]
    new.in_features = w.shape[1] * (2 if out_leaf == "weight_q4" else 1)
    new.group = group
    return new


def shard_transformer(model: nn.Module, mesh, specs: Optional[Dict[str, tuple]] = None,
                      copy_all: bool = False) -> nn.Module:
    """A copy of the DiT ``model`` that holds only this rank's shards, on
    ``mesh.device``: the column- and row-parallel linears of
    ``models.layers`` (quantized ones too), Wan's tensor-parallel q/k norms,
    ``H / tp`` heads in each block's attention, and with ``pp > 1``
    :class:`RemoteBlock` in place of the other stages' blocks. ``model`` is
    left as it is. A whole tensor that already lies on ``mesh.device`` is
    shared with ``model`` unless ``copy_all``; the others are copied there, so
    a DiT on the host gives one whose card holds this rank's shards and
    nothing else (the other stages' blocks and the other tp slices are never
    copied). ``specs``: the family's by default."""
    specs = transformer_specs(model) if specs is None else specs
    tp, group, device = mesh.size("tp"), mesh.group("tp"), mesh.device
    if mesh.size("pp") > 1:
        specs = add_pp(specs)
    state = model_state(model)
    layers = _layers(state)
    split = {n: t for n, t in state.items() if tp > 1 and any(s not in (None, "pp") for s in specs[n])}
    local = shard_params(split, specs, mesh)  # this stage's tp-split leaves

    def placed(name, t):  # what the copy holds for ``model``'s tensor ``name``
        if name in local:
            new = local[name]
        elif not _on_stage(name, layers, mesh):
            new = torch.empty(0, dtype=t.dtype, device="meta")  # its block becomes a RemoteBlock below
        elif t.device == device and not copy_all:
            return t
        else:
            new = t.detach().to(device, copy=True)
        return nn.Parameter(new, requires_grad=t.requires_grad) if isinstance(t, nn.Parameter) else new

    memo = {id(t): placed(name, t) for name, t in list(model.named_parameters()) + list(model.named_buffers())}
    out = copy.deepcopy(model, memo)
    for key in BLOCK_KEYS:
        blocks = getattr(out, key, None)
        if blocks is None or mesh.size("pp") == 1:
            continue
        for i in range(len(blocks)):
            if not _on_stage(f"{key}.{i}.", layers, mesh):
                blocks[i] = RemoteBlock()
    for name, module in list(out.named_modules()):
        if tp == 1 or name.split(".", 1)[0] not in BLOCK_KEYS or isinstance(module, RemoteBlock):
            continue  # at tp = 1 the modules stay as they are, so the forward is the unsharded one
        if hasattr(module, "nh"):
            if module.nh % tp:
                raise ValueError(f"{name}: {module.nh} heads do not split over tp={tp}")
            module.nh //= tp
        leaf = next((f"{name}.{w}" for w in ("weight", "weight_q", "weight_q4") if f"{name}.{w}" in specs), None)
        spec = specs.get(leaf, ())
        spec = spec[1:] if spec[:1] == ("pp",) else spec
        if isinstance(module, (L.Linear, L.QuantizedLinear)) and any(s is not None for s in spec):
            new = _parallel_linear(module, "col" if spec[0] == "tp" else "row", name, local, group)
        elif isinstance(module, L.RMSNorm) and spec == ("tp",):
            new = L.TensorParallelRMSNorm(local[leaf].shape[0], module.eps, device="meta")
            new.weight = nn.Parameter(local[leaf], requires_grad=module.weight.requires_grad)
            new.group, new.full_dim = group, state[leaf].shape[0]
        else:
            continue
        out.set_submodule(name, new)
    return out
