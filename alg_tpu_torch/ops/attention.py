"""Attention entry point (counterpart of ``alg_tpu/ops/attention.py:attention``).

Every attention of the slices comes through here: the DiTs' self- and
cross-attention (``stable=False``; the Hunyuan DiT's joint [video; text]
sequence with ``kv_len``), T5's and UMT5's attention with the
relative-position bias (``scale=1.0``, ``stable=True``; UMT5 with the
prompt's ``kv_len``), the CLIP vision towers', the Hunyuan token refiner's
(``kv_len``), and the causal ones: Llama's (with ``kv_len``) and the CLIP
text encoder's. A call that needs no gradient goes straight to
:func:`alg_tpu_torch.ops.flash_attention.flash_attention`, which picks the
CUDA kernel or, for CPU tensors, the plain version, and launches exactly
what an inference call launches. A call with an input that requires a
gradient goes through
:class:`alg_tpu_torch.ops.flash_attention_bwd.FlashAttentionFunction`: the
same forward kernel with its LSE output, and the dq and dkv kernels in the
backward (the counterpart of the JAX package's ``_pallas_diff``).
"""

from __future__ import annotations

from typing import Optional

import torch

from alg_tpu_torch.ops._autograd import needs_grad
from alg_tpu_torch.ops.flash_attention import flash_attention
from alg_tpu_torch.ops.flash_attention_bwd import FlashAttentionFunction


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None,
              causal: bool = False, kv_len: Optional[torch.Tensor] = None,
              bias: Optional[torch.Tensor] = None, stable: bool = True) -> torch.Tensor:
    """Scaled dot-product attention over ``[B, H, S, D]``; ``scale``
    defaults to ``D**-0.5``, ``causal`` hides from query ``i`` the keys past
    ``i + (Sk - Sq)``, ``kv_len`` is an int32 ``[B]`` count of the keys each
    batch row attends to (a prefix mask), ``bias`` an additive fp32 logit
    bias ``[1|B, H, Sq, Sk]``."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if needs_grad(q, k, v, bias):
        return FlashAttentionFunction.apply(q, k, v, kv_len, bias, scale, causal, stable)
    return flash_attention(q, k, v, scale, bias=bias, stable=stable, kv_len=kv_len, causal=causal)
