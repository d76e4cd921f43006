"""Shared building blocks (PyTorch counterpart of ``alg_tpu/models/layers.py``).

Parameters are named after the JAX package's parameter tree (``kernel`` ->
``weight``, ``scale`` -> ``weight``) so :mod:`alg_tpu_torch.io.jax_params`
can carry a tree across. Compute policy follows the JAX package: matmuls in
the activation dtype, norms with fp32 statistics and an fp32 affine, cast
back once.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last dim: fp32 mean/var, fp32 affine, cast back."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)


def t5_layer_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """T5 RMS norm: mean square in fp32, fp32 scale, cast back."""
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


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


def sinusoidal_timestep_embedding(timesteps: torch.Tensor, dim: int) -> torch.Tensor:
    """diffusers ``get_timestep_embedding`` as CogVideoX calls it
    (``flip_sin_to_cos=True``, ``downscale_freq_shift=0``): fp32
    ``[cos, sin]`` of ``t·exp(-log(10000)·i/half)``."""
    half = dim // 2
    exponent = -math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=timesteps.device)
    emb = torch.exp(exponent / half)[None, :] * timesteps.float()[:, None]
    out = torch.cat([torch.cos(emb), torch.sin(emb)], dim=-1)
    return F.pad(out, (0, 1)) if dim % 2 == 1 else out


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5, device=None, dtype=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(dim, device=device, dtype=dtype))

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.eps)


class RMSNorm(nn.Module):
    """T5-style RMS norm (no bias, no mean subtraction)."""

    def __init__(self, dim: int, eps: float = 1e-6, device=None, dtype=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device, dtype=dtype))

    def forward(self, x):
        return t5_layer_norm(x, self.weight, self.eps)


class GroupNorm(nn.Module):
    def __init__(self, channels: int, groups: int, eps: float = 1e-6, device=None, dtype=None):
        super().__init__()
        self.groups, self.eps = groups, eps
        self.weight = nn.Parameter(torch.ones(channels, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(channels, device=device, dtype=dtype))

    def forward(self, x):
        return group_norm(x, self.weight, self.bias, self.groups, self.eps)


class MLP(nn.Module):
    """``fc_out(gelu_tanh(fc_in(x)))``."""

    def __init__(self, dim: int, inner_dim: int, device=None, dtype=None):
        super().__init__()
        self.fc_in = nn.Linear(dim, inner_dim, device=device, dtype=dtype)
        self.fc_out = nn.Linear(inner_dim, dim, device=device, dtype=dtype)

    def forward(self, x):
        return self.fc_out(gelu_tanh(self.fc_in(x)))


class TimestepEmbedding(nn.Module):
    """diffusers ``TimestepEmbedding``: linear -> silu -> linear."""

    def __init__(self, in_dim: int, dim: int, device=None, dtype=None):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, dim, device=device, dtype=dtype)
        self.linear_2 = nn.Linear(dim, dim, device=device, dtype=dtype)

    def forward(self, x):
        return self.linear_2(silu(self.linear_1(x)))


@torch.no_grad()
def init_random_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random weights drawn like the JAX package's ``init_*`` functions
    (same distributions, not the same numbers): linear and conv weights
    N(0, 1/fan_in), biases 0, norm scales 1, embeddings N(0, ``init_std``²).
    ``generator`` must live on the parameters' device."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d, nn.Conv3d)):
            m.weight.normal_(0.0, m.weight[0].numel() ** -0.5, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, getattr(m, "init_std", 1.0), generator=generator)
        elif isinstance(m, (LayerNorm, RMSNorm, GroupNorm)):
            m.weight.fill_(1.0)
            if getattr(m, "bias", None) is not None:
                m.bias.zero_()
    return module
