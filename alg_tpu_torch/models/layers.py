"""Shared building blocks (PyTorch counterpart of ``alg_tpu/models/layers.py``).

Parameters are named after the JAX package's parameter tree (``kernel`` ->
``weight``, ``scale`` -> ``weight``) so :mod:`alg_tpu_torch.io.jax_params`
can carry a tree across. Compute policy follows the JAX package: matmuls in
the activation dtype, norms with fp32 statistics and an fp32 affine, cast
back once.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def layer_norm(x: torch.Tensor, weight: Optional[torch.Tensor], bias: Optional[torch.Tensor],
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last dim: fp32 mean/var, fp32 affine (none when
    ``weight`` is None), cast back."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight.float() + bias.float()
    return y.to(x.dtype)


def t5_layer_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """T5 RMS norm: mean square in fp32, fp32 scale, cast back. Also the JAX
    package's ``rms_norm`` with ``offset=0.0``, the same arithmetic: Wan's
    q/k norm over the full inner dim, HunyuanVideo's per head over the head
    dim, Llama's over the hidden size (``eps`` 1e-5)."""
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (y * weight.float()).to(x.dtype)


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int,
               eps: float = 1e-6) -> torch.Tensor:
    """GroupNorm of a channels-first ``[B, C, ...]`` tensor in fp32, cast back.

    Each group's statistics run over its channels and every spatial position,
    as in the JAX package's channels-last ``group_norm``."""
    return F.group_norm(x.float(), groups, weight.float(), bias.float(), eps).to(x.dtype)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU."""
    return F.gelu(x)


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


def sinusoidal_timestep_embedding(timesteps: torch.Tensor, dim: int) -> torch.Tensor:
    """diffusers ``get_timestep_embedding`` as CogVideoX and Wan call it
    (``flip_sin_to_cos=True``, ``downscale_freq_shift=0``): fp32
    ``[cos, sin]`` of ``t·exp(-log(10000)·i/half)``."""
    half = dim // 2
    exponent = -math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=timesteps.device)
    emb = torch.exp(exponent / half)[None, :] * timesteps.float()[:, None]
    out = torch.cat([torch.cos(emb), torch.sin(emb)], dim=-1)
    return F.pad(out, (0, 1)) if dim % 2 == 1 else out


class Linear(nn.Linear):
    """``nn.Linear`` that can carry an attached (unmerged) low-rank adapter,
    as ``alg_tpu/models/layers.py:linear`` reads ``lora_A``/``lora_B``:
    ``y += ((x.float() @ A) @ B).to(y.dtype)`` with ``A`` [in, r] and ``B``
    [r, out] (already times the LoRA scale); the products run in fp32 whatever
    dtype the adapters arrive in (bf16 under ``compute_dtype``).

    The adapter lives in two buffers that are None, and so absent from the
    state dict, except while ``training.lora.attach_lora`` substitutes them
    through ``torch.func.functional_call``. The DiTs build their linears from
    this class; the frozen encoders keep ``nn.Linear``."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, device=None, dtype=None):
        super().__init__(in_features, out_features, bias=bias, device=device, dtype=dtype)
        self.register_buffer("lora_A", None, persistent=False)
        self.register_buffer("lora_B", None, persistent=False)

    def forward(self, x):
        y = F.linear(x, self.weight, self.bias)
        if self.lora_A is not None:
            y = y + ((x.float() @ self.lora_A.float()) @ self.lora_B.float()).to(y.dtype)
        return y


class QuantizedLinear(nn.Module):
    """A W8A8 (``mode="w8"``) or W4A8 (``"w4"``) linear
    (``alg_tpu/ops/quant.py:quantized_linear``), the frozen form
    ``ops.quant.quantize_transformer_`` gives a block linear. Buffers, in
    the port's ``[out, in]`` layout: ``weight_q`` int8 ``[out, in]``, or
    ``weight_q4`` int8 ``[out, in/2]`` (two int4 codes a byte along IN) and
    ``w_scale4`` fp32 ``[out, in/128]``; ``w_scale`` fp32 ``[out]``. The bias
    stays a parameter in the model's dtype. An attached adapter (``lora_A``,
    ``lora_B``) adds its term as :class:`Linear` does; it is never merged."""

    def __init__(self, in_features: int, out_features: int, mode: str = "w8", bias: bool = True, device=None,
                 dtype=None):
        from alg_tpu_torch.ops.quant import GROUP

        super().__init__()
        self.in_features, self.out_features, self.mode = in_features, out_features, mode
        if mode == "w8":
            self.register_buffer("weight_q", torch.empty(out_features, in_features, dtype=torch.int8, device=device))
            self.register_buffer("w_scale4", None)
        elif mode == "w4":
            self.register_buffer("weight_q4", torch.empty(out_features, in_features // 2, dtype=torch.int8,
                                                          device=device))
            self.register_buffer("w_scale4", torch.empty(out_features, in_features // GROUP, dtype=torch.float32,
                                                         device=device))
        else:
            raise ValueError(f"unknown quantization mode {mode!r}")
        self.register_buffer("w_scale", torch.empty(out_features, dtype=torch.float32, device=device))
        self.bias = nn.Parameter(torch.empty(out_features, device=device, dtype=dtype),
                                 requires_grad=False) if bias else None
        self.register_buffer("lora_A", None, persistent=False)
        self.register_buffer("lora_B", None, persistent=False)

    @classmethod
    @torch.no_grad()
    def from_linear(cls, linear: nn.Linear, mode: str = "w8") -> "QuantizedLinear":
        """``linear``'s weight quantized on its device; the bias carried as it is."""
        from alg_tpu_torch.ops import quant

        w = linear.weight
        out = cls(linear.in_features, linear.out_features, mode, bias=linear.bias is not None, device="meta",
                  dtype=w.dtype)
        if mode == "w8":
            out.weight_q, out.w_scale = quant.quantize_kernel(w)
        else:
            out.weight_q4, out.w_scale4, out.w_scale = quant.quantize_kernel_w4(w)
        if linear.bias is not None:
            out.bias = nn.Parameter(linear.bias.detach(), requires_grad=False)
        return out

    @property
    def weight_codes(self) -> torch.Tensor:
        """``weight_q`` (W8) or the packed ``weight_q4`` (W4): the weight ``ops.quant`` takes beside
        ``w_scale4`` (None in W8)."""
        return self.weight_q if self.w_scale4 is None else self.weight_q4

    def int8_weight(self) -> torch.Tensor:
        """The int8 ``[out, in]`` weight the product takes (a w4 weight unpacked)."""
        from alg_tpu_torch.ops.quant import int8_weight

        return int8_weight(self.weight_codes, self.w_scale4, self.w_scale)

    def forward(self, x):
        from alg_tpu_torch.ops.quant import quantized_linear

        y = quantized_linear(x, self.weight_codes, self.w_scale4, self.w_scale, self.bias)
        if self.lora_A is not None:
            y = y + ((x.float() @ self.lora_A.float()) @ self.lora_B.float()).to(y.dtype)
        return y

    def extra_repr(self) -> str:
        return f"in_features={self.in_features}, out_features={self.out_features}, mode={self.mode}"


class ColumnParallelLinear(Linear):
    """A linear whose output features are sharded over the ``tp`` group
    ``group``: this rank holds ``out / tp`` rows of the weight and bias. Its
    input passes through Megatron's identity-forward, all-reduce-backward
    function, so the replicated layers that feed it get whole gradients."""

    group = None

    def forward(self, x):
        from alg_tpu_torch.sharding.collectives import copy_to

        return super().forward(copy_to(x, self.group))


class RowParallelLinear(Linear):
    """A linear whose input features are sharded over ``group``: this rank
    holds ``in / tp`` columns of the weight and the whole bias. The partial
    products are summed by Megatron's all-reduce-forward,
    identity-backward function before the bias is added once."""

    group = None

    def forward(self, x):
        from alg_tpu_torch.sharding.collectives import reduce_from

        if self.lora_A is not None:
            raise NotImplementedError("adapters attach to unsharded linears only (merge them before sharding)")
        y = reduce_from(F.linear(x, self.weight), self.group)
        return y if self.bias is None else y + self.bias


class ColumnParallelQuantizedLinear(QuantizedLinear):
    """:class:`QuantizedLinear` with its output features (codes, scales and
    bias) sharded over ``group``; the activation rows are whole, so each
    rank quantizes them as the unsharded linear does."""

    group = None

    def forward(self, x):
        from alg_tpu_torch.sharding.collectives import copy_to

        return super().forward(copy_to(x, self.group))


class RowParallelQuantizedLinear(QuantizedLinear):
    """:class:`QuantizedLinear` with its input features sharded over
    ``group`` (W4: whole 128-element groups a rank). The activation scale is
    the all-reduced max over the whole row and the int32 accumulators are
    summed before the epilogue, so the result is the unsharded linear's."""

    group = None

    def forward(self, x):
        from alg_tpu_torch.ops.quant import quantized_linear_forward

        if self.lora_A is not None or (torch.is_grad_enabled() and x.requires_grad):
            raise NotImplementedError("a row-parallel quantized linear runs forward only, without adapters")
        return quantized_linear_forward(x, self.int8_weight(), self.w_scale, self.bias, group=self.group)


class LayerNorm(nn.Module):
    """``affine=False`` holds no parameters (the JAX package's ``{}`` norm)."""

    def __init__(self, dim: int, eps: float = 1e-5, affine: bool = True, device=None, dtype=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device, dtype=dtype)) if affine else None
        self.bias = nn.Parameter(torch.zeros(dim, device=device, dtype=dtype)) if affine else None

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.eps)


class RMSNorm(nn.Module):
    """T5-style RMS norm over the last dim (no bias, no mean subtraction)."""

    def __init__(self, dim: int, eps: float = 1e-6, device=None, dtype=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device, dtype=dtype))

    def forward(self, x):
        return t5_layer_norm(x, self.weight, self.eps)


class TensorParallelRMSNorm(RMSNorm):
    """An RMS norm over ``full_dim`` features of which this rank holds a
    slice (and that slice of the scale): the sum of squares is all-reduced
    over ``group`` in both directions (Wan's q/k norm over a tp-sharded
    inner dim)."""

    group = None
    full_dim = 0

    def forward(self, x):
        from alg_tpu_torch.sharding.collectives import all_reduce

        xf = x.float()
        ms = all_reduce(xf.square().sum(-1, keepdim=True), self.group) / self.full_dim
        return (xf * torch.rsqrt(ms + self.eps) * self.weight.float()).to(x.dtype)


class GroupNorm(nn.Module):
    def __init__(self, channels: int, groups: int, eps: float = 1e-6, device=None, dtype=None):
        super().__init__()
        self.groups, self.eps = groups, eps
        self.weight = nn.Parameter(torch.ones(channels, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(channels, device=device, dtype=dtype))

    def forward(self, x):
        return group_norm(x, self.weight, self.bias, self.groups, self.eps)


class MLP(nn.Module):
    """``fc_out(act(fc_in(x)))``, ``act`` the tanh GELU unless given."""

    def __init__(self, dim: int, inner_dim: int, act=gelu_tanh, device=None, dtype=None):
        super().__init__()
        self.act = act
        self.fc_in = Linear(dim, inner_dim, device=device, dtype=dtype)
        self.fc_out = Linear(inner_dim, dim, device=device, dtype=dtype)

    def forward(self, x):
        return self.fc_out(self.act(self.fc_in(x)))


class TimestepEmbedding(nn.Module):
    """diffusers ``TimestepEmbedding``: linear -> silu -> linear."""

    def __init__(self, in_dim: int, dim: int, device=None, dtype=None):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, dim, device=device, dtype=dtype)
        self.linear_2 = nn.Linear(dim, dim, device=device, dtype=dtype)

    def forward(self, x):
        return self.linear_2(silu(self.linear_1(x)))


def table(shape, init_std: float, device=None, dtype=None) -> nn.Parameter:
    """A parameter that is a plain table (modulation table, class or
    position embedding), drawn N(0, ``init_std``²) by :func:`init_random_`."""
    p = nn.Parameter(torch.zeros(shape, device=device, dtype=dtype))
    p.init_std = init_std
    return p


@torch.no_grad()
def init_random_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random weights drawn like the JAX package's ``init_*`` functions
    (same distributions, not the same numbers): linear and conv weights
    N(0, 1/fan_in), biases 0, norm scales 1, embeddings and tables
    N(0, ``init_std``²). ``generator`` must live on the parameters' device."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d, nn.Conv3d)):
            m.weight.normal_(0.0, m.weight[0].numel() ** -0.5, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, getattr(m, "init_std", 1.0), generator=generator)
        elif isinstance(m, (LayerNorm, RMSNorm, GroupNorm)) and m.weight is not None:
            m.weight.fill_(1.0)
            if getattr(m, "bias", None) is not None:
                m.bias.zero_()
    for p in module.parameters():
        if hasattr(p, "init_std"):
            p.normal_(0.0, p.init_std, generator=generator)
    return module
