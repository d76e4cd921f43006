"""Opt-in W8A8 and W4A8 linears (counterpart of ``alg_tpu/ops/quant.py``).

W8A8: per-output-channel symmetric int8 weights (static scales), per-row
symmetric int8 activations (dynamic absmax scales), an int8 x int8 product
with int32 accumulation, and an fp32 epilogue. W4A8 stores the weights as
group-128 symmetric int4 in [-7, 7], two codes a byte along IN, and
requantizes them to per-output-channel int8 at each use, so the product is
the same int8 one. Never on by default: it changes the numbers.

Layouts are the port's ``[out, in]`` (the JAX package's ``[in, out]``
transposed): ``weight_q`` int8 ``[out, in]``, ``weight_q4`` int8 ``[out,
in/2]`` whose byte ``j`` holds IN index ``2j`` in its low nibble and ``2j+1``
in its high one, ``w_scale4`` fp32 ``[out, in/128]`` and ``w_scale`` fp32
``[out]``. The quantizers run on the device where the weight lies, in fp32
with divisions rounded once (``_div``) and ``torch.round`` (half to even),
so their codes and scales are bit-equal to the JAX package's numpy
reference, on the card as on the CPU.

The product is ``torch._int_mm`` on a CUDA tensor (cuBLASLt's int8 GEMM, as
the JAX package leaves its int8 dot to XLA) and an int32 matmul on the CPU:
the CPU is the plain version the tests hold the card to, and a CUDA tensor
never takes it. ``_int_mm`` needs more than 16 rows and K and N multiples of
8; fewer rows (the modulation linears see one a sample) are padded with zero
rows and cut off again, which changes nothing since each row is quantized on
its own. The weight goes in as ``weight_q.t()``: the contiguous ``[out, in]``
int8 weight seen as a column-major ``[in, out]`` operand (cuBLASLt's "TN"
int8 layout, checked by ``chip_smoke.py``'s phase Q1).

:func:`quantize_transformer_` replaces the big block linears of a DiT with
:class:`~alg_tpu_torch.models.layers.QuantizedLinear`, one at a time, with
the JAX package's selection rules.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

GROUP = 128  # int4 group along IN
BLOCK_CONTAINERS = ("blocks", "transformer_blocks", "single_transformer_blocks")
# the buffers of a quantized linear; the first two are its weight in either mode
QUANT_BUFFERS = ("weight_q", "weight_q4", "w_scale", "w_scale4")
MODES = ("w8", "w4")
INT_MM_MIN_ROWS = 17  # torch._int_mm on CUDA takes more than 16 rows

# The layout torch._int_mm is given the weight in (see the module docstring).
WEIGHT_LAYOUT = "weight_q [out, in] contiguous, passed as weight_q.t()"


def _div(a: torch.Tensor, d: float) -> torch.Tensor:
    """``a / d`` rounded once, as numpy rounds it. The divisor is a tensor on ``a``'s device: CUDA turns a
    division by a Python number into a product with its rounded reciprocal, one ulp off for some values."""
    return a / torch.full((), d, dtype=a.dtype, device=a.device)


def quantize_kernel(weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 over IN: ``weight [..., out, in]`` ->
    (int8 ``[..., out, in]``, fp32 scale ``[..., out]``), ``scale =
    max(absmax, 1e-12) / 127`` (``alg_tpu/ops/quant.py:quantize_kernel``)."""
    w = weight.float()
    scale = _div(torch.clamp_min(w.abs().amax(-1, keepdim=True), 1e-12), 127.0)
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale.squeeze(-1)


def quantize_kernel_w4(weight: torch.Tensor, group: int = GROUP) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Group-wise symmetric int4 over IN: ``weight [..., out, in]`` ->
    (packed int8 ``[..., out, in/2]``, group scales fp32 ``[..., out,
    in/group]``, int8 requant scale fp32 ``[..., out]``), the codes in [-7,
    7] and ``s8 = max(7·s4) / 127`` (``alg_tpu/ops/quant.py:quantize_kernel_w4``)."""
    kin = weight.shape[-1]
    if kin % group or kin % 2:
        raise ValueError(f"in dim {kin} not divisible by group {group} (and 2)")
    w = weight.float()
    wg = w.reshape(w.shape[:-1] + (kin // group, group))
    s4 = _div(torch.clamp_min(wg.abs().amax(-1, keepdim=True), 1e-12), 7.0)
    q4 = torch.clamp(torch.round(wg / s4), -7, 7).to(torch.int8).reshape(w.shape)
    packed = (q4[..., 0::2] & 0x0F) | (q4[..., 1::2] * 16)  # the high code's low 4 bits are 0: | adds
    s4 = s4.squeeze(-1)
    s8 = _div(torch.clamp_min((7.0 * s4).amax(-1), 1e-12), 127.0)
    return packed, s4, s8


def w4_to_int8(packed: torch.Tensor, w_scale4: torch.Tensor, w_scale: torch.Tensor) -> torch.Tensor:
    """Unpack the sign-extended nibbles and requantize group-wise to
    per-output-channel int8: ``[..., out, in]`` (``alg_tpu/ops/quant.py:w4_to_int8``)."""
    lo = ((packed & 0x0F) ^ 8) - 8  # sign-extends the low nibble
    hi = packed >> 4  # arithmetic shift: the high nibble, sign-extended
    q4 = torch.stack([lo, hi], dim=-1).reshape(packed.shape[:-1] + (2 * packed.shape[-1],))
    g_cnt = w_scale4.shape[-1]
    mult = w_scale4 / w_scale[..., None]  # [..., out, G]
    wf = q4.reshape(q4.shape[:-1] + (g_cnt, q4.shape[-1] // g_cnt)).float()
    return torch.clamp(torch.round(wf * mult[..., None]), -127, 127).to(torch.int8).reshape(q4.shape)


def quantize_rows(x: torch.Tensor, group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 of the activations: ``x [..., K]`` -> (int8
    ``[..., K]``, fp32 ``[..., 1]``), ``xs = max(absmax / 127, 1e-12)``; with
    a process ``group`` the rows' features are sharded over it and the
    absmax is all-reduced."""
    xf = x.float()
    amax = xf.abs().amax(-1, keepdim=True)
    if group is not None:
        from alg_tpu_torch.sharding.collectives import all_reduce_

        all_reduce_(amax, group, torch.distributed.ReduceOp.MAX)
    xs = torch.clamp_min(_div(amax, 127.0), 1e-12)
    return torch.clamp(torch.round(xf / xs), -127, 127).to(torch.int8), xs


def int8_matmul(a: torch.Tensor, weight_q: torch.Tensor) -> torch.Tensor:
    """``a [M, K] int8 @ weight_q[N, K]ᵀ`` -> int32 ``[M, N]``, exact:
    ``torch._int_mm`` on a CUDA tensor (rows padded to 17 with zeros), an
    int32 matmul on the CPU."""
    if a.is_cuda:
        m = a.shape[0]
        if m < INT_MM_MIN_ROWS:
            return torch._int_mm(F.pad(a, (0, 0, 0, INT_MM_MIN_ROWS - m)), weight_q.t())[:m]
        return torch._int_mm(a, weight_q.t())
    if a.device.type != "cpu":
        raise RuntimeError(f"int8_matmul: no route for a {a.device.type} tensor")
    return a.to(torch.int32) @ weight_q.to(torch.int32).t()


def _epilogue(acc: torch.Tensor, xs: torch.Tensor, w_scale: torch.Tensor, bias: Optional[torch.Tensor], dtype):
    y = acc.float() * xs * w_scale
    if bias is not None:
        y = y + bias.float()
    return y.to(dtype)


def quantized_linear_forward(x: torch.Tensor, weight_q: torch.Tensor, w_scale: torch.Tensor,
                             bias: Optional[torch.Tensor] = None, group=None) -> torch.Tensor:
    """W8A8 ``x @ (weight_q·w_scale)ᵀ + bias`` in ``x``'s dtype, as
    ``alg_tpu/ops/quant.py:_quantized_linear_impl``: per-row int8 ``x``, the
    int32 product, ``acc·xs·w_scale (+ bias)`` in fp32. With a process
    ``group`` the input features are sharded over it (a row-parallel
    linear): the absmax and the int32 accumulators are all-reduced."""
    lead = x.shape[:-1]
    xq, xs = quantize_rows(x.reshape(-1, x.shape[-1]), group)
    acc = int8_matmul(xq, weight_q)
    if group is not None:
        from alg_tpu_torch.sharding.collectives import all_reduce_

        all_reduce_(acc, group)
    return _epilogue(acc, xs, w_scale, bias, x.dtype).reshape(lead + (weight_q.shape[0],))


@contextlib.contextmanager
def _fp32_matmul():
    """fp32 products without TF32 inside the block."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def int8_weight(weight: torch.Tensor, w_scale4: Optional[torch.Tensor], w_scale: torch.Tensor) -> torch.Tensor:
    """The int8 ``[out, in]`` weight the product takes: ``weight`` itself where
    ``w_scale4`` is None (W8), else the packed int4 ``weight`` unpacked by
    :func:`w4_to_int8`."""
    return weight if w_scale4 is None else w4_to_int8(weight, w_scale4, w_scale)


class _QuantizedLinearFn(torch.autograd.Function):
    """The W8A8 / W4A8 linear, differentiable in ``x`` by the QLoRA rule of
    ``alg_tpu/ops/quant.py:_quantized_linear_bwd``: ``dx = g · (wq·w_scale)``
    in fp32 (TF32 off), the int8 product and the activation rounding taken
    as the identity; the frozen weights, scales and bias get no gradient.
    An int4 weight is unpacked again in the backward, not kept unpacked."""

    @staticmethod
    def forward(ctx, x, weight, w_scale4, w_scale, bias):
        ctx.save_for_backward(weight, w_scale4, w_scale)
        ctx.x_dtype = x.dtype
        return quantized_linear_forward(x, int8_weight(weight, w_scale4, w_scale), w_scale, bias)

    @staticmethod
    def backward(ctx, g):
        weight, w_scale4, w_scale = ctx.saved_tensors
        w8 = int8_weight(weight, w_scale4, w_scale)
        with _fp32_matmul():
            dx = g.float() @ (w8.float() * w_scale.float()[:, None])
        return dx.to(ctx.x_dtype), None, None, None, None


def quantized_linear(x: torch.Tensor, weight: torch.Tensor, w_scale4: Optional[torch.Tensor], w_scale: torch.Tensor,
                     bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The W8A8 linear over the int8 ``weight`` (``w_scale4`` None), or the
    W4A8 one over the packed int4 ``weight`` and its group scales
    ``w_scale4`` (unpacked by :func:`int8_weight` at each use), with the
    QLoRA backward where ``x`` requires a gradient."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _QuantizedLinearFn.apply(x, weight, w_scale4, w_scale, bias)
    return quantized_linear_forward(x, int8_weight(weight, w_scale4, w_scale), w_scale, bias)


# -- tree quantization --------------------------------------------------------


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown quantization mode {mode!r}")


def _selected(path: str, linear: nn.Module, modulation: bool) -> bool:
    """``alg_tpu``'s rules for a linear at ``path`` inside a block container:
    in and out at least 128 (``_is_big_linear``), and, unless
    ``modulation``, no name on the path that holds ``norm`` or is ``ada``."""
    if not isinstance(linear, nn.Linear) or linear.in_features < 128 or linear.out_features < 128:
        return False
    return modulation or not any("norm" in name or name == "ada" for name in path.split("."))


def _quantize_linears_(container: nn.Module, mode: str, modulation: bool) -> int:
    """Replace the selected linears under ``container`` in place, one at a time."""
    from alg_tpu_torch.models.layers import QuantizedLinear

    chosen = [path for path, m in container.named_modules() if path and _selected(path, m, modulation)]
    for path in chosen:
        parent_path, _, name = path.rpartition(".")
        parent = container.get_submodule(parent_path) if parent_path else container
        linear = getattr(parent, name)
        # w4 needs whole groups of 128 along IN; other in-dims fall back to int8
        use = "w4" if mode == "w4" and linear.in_features % GROUP == 0 else "w8"
        setattr(parent, name, QuantizedLinear.from_linear(linear, use))
        del linear  # the bf16 weight goes as soon as the parent lets go of it
    return len(chosen)


@torch.no_grad()
def quantize_transformer_(model: nn.Module, mode: str = "w8", modulation: bool = False) -> nn.Module:
    """Quantize the big linears inside a DiT's block containers in place
    (``alg_tpu/ops/quant.py:quantize_transformer_params``); embeddings, heads
    and everything outside ``blocks``, ``transformer_blocks`` and
    ``single_transformer_blocks`` stay as they are. ``modulation=True`` also
    quantizes the in-block AdaLN / modulation linears. ``mode="w4"`` stores
    int4 weights where IN is a multiple of 128 and falls back to int8
    elsewhere. Each linear's weight is quantized where it lies and dropped
    before the next, so the device never holds both trees. Returns ``model``."""
    _check_mode(mode)
    for key in BLOCK_CONTAINERS:
        container = getattr(model, key, None)
        if isinstance(container, nn.Module):
            _quantize_linears_(container, mode, modulation)
    return model


def quantize_pipeline(pipe, mode: str = "w8"):
    """Quantize ``pipe.transformer``'s blocks in place (``modulation=False``,
    as ``alg_tpu/ops/quant.py:quantize_pipeline``); returns ``pipe``."""
    quantize_transformer_(pipe.transformer, mode=mode)
    return pipe


@torch.no_grad()
def random_init_quantized(model: nn.Module, generator: torch.Generator, mode: str = "w8",
                          modulation: bool = False) -> nn.Module:
    """Random weights for ``model`` (built on the ``meta`` device), made on
    the generator's device one block at a time, each block's linears
    quantized before the next block is made: the device never holds the
    bf16 block stacks. Draws as ``layers.init_random_`` (everything outside
    the block containers first, then each block), so not the numbers of an
    unquantized random init. Returns ``model``."""
    from alg_tpu_torch.models.layers import init_random_

    _check_mode(mode)
    device = generator.device
    stacks = {key: getattr(model, key) for key in BLOCK_CONTAINERS if isinstance(getattr(model, key, None), nn.ModuleList)}
    for key in stacks:
        setattr(model, key, nn.ModuleList())
    init_random_(model.to_empty(device=device), generator)
    for key, blocks in stacks.items():
        built = nn.ModuleList()
        for block in blocks:
            block = init_random_(block.to_empty(device=device), generator)
            _quantize_linears_(block, mode, modulation)
            built.append(block)
        setattr(model, key, built)
    return model
