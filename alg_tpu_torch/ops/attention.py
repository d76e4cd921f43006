"""Attention entry point (counterpart of ``alg_tpu/ops/attention.py:attention``).

Every attention of the slice comes through here: the DiT's dense joint
self-attention (``stable=False``) and T5's attention with its
relative-position bias (``scale=1.0``, ``stable=True``). The call goes to
:func:`alg_tpu_torch.ops.flash_attention.flash_attention`, which picks the
CUDA kernel or, for CPU tensors, the plain version.
"""

from __future__ import annotations

from typing import Optional

import torch

from alg_tpu_torch.ops.flash_attention import flash_attention


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None,
              bias: Optional[torch.Tensor] = None, stable: bool = True) -> torch.Tensor:
    """Scaled dot-product attention over ``[B, H, S, D]``; ``scale``
    defaults to ``D**-0.5``, ``bias`` is an additive fp32 logit bias
    ``[1|B, H, Sq, Sk]``."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), scale, bias=bias, stable=stable)
