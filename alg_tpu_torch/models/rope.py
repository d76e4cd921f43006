"""Rotary position embedding (counterpart of ``alg_tpu/models/rope.py``).

Tables are numpy, built on the host once per run; the rotation is the
interleaved-pair convention of CogVideoX (diffusers ``apply_rotary_emb``
with ``use_real_unbind_dim=-1``).
"""

from __future__ import annotations

import numpy as np
import torch


def rope_frequencies(dim: int, positions: np.ndarray, theta: float = 10000.0) -> np.ndarray:
    """Angles ``[N, dim/2]``: outer(pos, 1/theta^(arange(0,dim,2)/dim))."""
    inv = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
    return np.outer(positions.astype(np.float64), inv)


def cos_sin_interleaved(angles: np.ndarray, dtype=np.float32):
    """(cos, sin) with each angle repeated twice: ``[N, dim]``."""
    c = np.repeat(np.cos(angles), 2, axis=-1).astype(dtype)
    s = np.repeat(np.sin(angles), 2, axis=-1).astype(dtype)
    return c, s


def apply_rope_interleaved(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """``x·cos + rot(x)·sin`` with rot: (x0, x1) -> (-x1, x0) on each pair.

    ``x``: [..., S, D]; ``cos``/``sin``: [S, D]. The tables are cast to the
    activation dtype and the arithmetic runs in it, as in the JAX package."""
    c = cos.to(x.dtype)
    s = sin.to(x.dtype)
    pairs = x.unflatten(-1, (-1, 2))
    rot = torch.stack((-pairs[..., 1], pairs[..., 0]), dim=-1).flatten(-2)
    return x * c + rot * s
