"""Attention entry point (counterpart of ``alg_tpu/ops/attention.py:attention``).

Every attention of the slices comes through here: the DiTs' self- and
cross-attention (``stable=False``; the Hunyuan DiT's joint [video; text]
sequence with ``kv_len``), T5's and UMT5's attention with the
relative-position bias (``scale=1.0``, ``stable=True``; UMT5 with the
prompt's ``kv_len``), the CLIP vision towers', the Hunyuan token refiner's
(``kv_len``), and the causal ones: Llama's (with ``kv_len``) and the CLIP
text encoder's. A call that needs no gradient goes straight to
:func:`alg_tpu_torch.ops.flash_attention.flash_attention`, which picks a
CUDA kernel (bf16 on the tensor cores, fp32 on the CUDA cores) or, for CPU
tensors, the plain version, and launches exactly what an inference call
launches. A call with an input that requires a
gradient goes through
:class:`alg_tpu_torch.ops.flash_attention_bwd.FlashAttentionFunction`: the
same forward kernel with its LSE output, and the dq and dkv kernels in the
backward (the counterpart of the JAX package's ``_pallas_diff``).

Two opt-in variants, with the JAX package's names and conditions:

* :func:`set_attention_int8` sends the DiT blocks' self-attention through
  the int8 kernel (:mod:`alg_tpu_torch.ops.flash_attention_int8`). A call
  qualifies when it asked for the bounded-logit path (``stable=False``, which
  only the DiT blocks do), is not causal, has no bias and no prolog, and
  Sq == Sk; ``kv_len`` goes along. Text and vision encoders pass
  ``stable=True`` and never reach it. A qualifying call at another head dim
  than 64 or 128 raises on the card, and one whose input requires a gradient
  raises everywhere: the int8 path has no backward (the JAX package routes
  such a call to a kernel that cannot be differentiated, without saying so).
* ``prolog`` applies the per-head qk norm and RoPE of the JAX kernel's
  prolog to q and k. On the card, for a call without a gradient, that is one
  launch of the qk prolog kernel over q and k ahead of the forward kernel
  (``ops/flash_attention.py:qk_prolog``). On CPU tensors, and whenever an
  input needs a gradient, it is the plain, differentiable composition
  :func:`apply_prolog_plain`. Either way the attention is then a call
  without a prolog.
"""

from __future__ import annotations

from typing import Optional

import torch

from alg_tpu_torch.ops._autograd import needs_grad
from alg_tpu_torch.ops.flash_attention import apply_prolog_plain, flash_attention
from alg_tpu_torch.ops.flash_attention_bwd import FlashAttentionFunction
from alg_tpu_torch.ops.flash_attention_int8 import flash_attention_int8

_INT8_QK: Optional[str] = None  # None | "qk" | "full"


def set_attention_int8(enabled) -> None:
    """Route qualifying DiT self-attention through the int8 flash kernel:
    ``True`` or ``"qk"`` takes the logits as an int8 product (per-block
    scales, K mean-centred), ``"full"`` the P·V product as well (per-row P
    scales, per-channel V scales); ``False`` or ``None`` switches it off.

    Opt-in and for inference only: int8 logits move the outputs by about
    1e-2 of their size (``tests/test_torch_port_int8.py`` holds the bounds)
    and must be judged per checkpoint. The module docstring says which calls
    qualify. The mode is one setting for the process."""
    global _INT8_QK
    if enabled in (False, None):
        _INT8_QK = None
    elif enabled in (True, "qk"):
        _INT8_QK = "qk"
    elif enabled == "full":
        _INT8_QK = "full"
    else:
        raise ValueError(f"set_attention_int8: {enabled!r} (want bool, 'qk' or 'full')")


def get_attention_int8() -> Optional[str]:
    return _INT8_QK


_PROLOG_KEYS = ("norm", "eps", "q_scale", "q_bias", "k_scale", "k_bias", "cos", "sin")


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None,
              causal: bool = False, kv_len: Optional[torch.Tensor] = None,
              bias: Optional[torch.Tensor] = None, stable: bool = True,
              prolog: Optional[dict] = None) -> torch.Tensor:
    """Scaled dot-product attention over ``[B, H, S, D]``; ``scale``
    defaults to ``D**-0.5``, ``causal`` hides from query ``i`` the keys past
    ``i + (Sk - Sq)``, ``kv_len`` is an int32 ``[B]`` count of the keys each
    batch row attends to (a prefix mask), ``bias`` an additive fp32 logit
    bias ``[1|B, H, Sq, Sk]``.

    ``prolog``: an optional fused qk prolog, a dict with the keys ``norm``
    (``"layer"``, ``"rms"`` or None), ``eps``, ``q_scale``/``q_bias``/
    ``k_scale``/``k_bias`` (``[D]`` per-head norm affines) and ``cos``/``sin``
    (``[S, D]`` interleaved RoPE tables); absent keys count as None."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if (_INT8_QK and not stable and not causal and bias is None and prolog is None
            and q.shape[2] == k.shape[2]):
        return flash_attention_int8(q, k, v, scale, pv_int8=_INT8_QK == "full", kv_len=kv_len)
    fused = {}
    if prolog is not None:
        unknown = set(prolog) - set(_PROLOG_KEYS)
        if unknown:
            raise ValueError(f"attention prolog: unknown keys {sorted(unknown)} (want {_PROLOG_KEYS})")
        tensors = [prolog.get(name) for name in _PROLOG_KEYS[2:]]
        if q.device.type == "cpu" or needs_grad(q, k, v, bias, *tensors):
            q, k = apply_prolog_plain(q, k, prolog)
        else:
            fused = dict(qk_norm=prolog.get("norm"), norm_eps=prolog.get("eps", 1e-6),
                         q_norm_scale=prolog.get("q_scale"), q_norm_bias=prolog.get("q_bias"),
                         k_norm_scale=prolog.get("k_scale"), k_norm_bias=prolog.get("k_bias"),
                         rope_cos=prolog.get("cos"), rope_sin=prolog.get("sin"))
    if needs_grad(q, k, v, bias):
        return FlashAttentionFunction.apply(q, k, v, kv_len, bias, scale, causal, stable)
    return flash_attention(q, k, v, scale, bias=bias, stable=stable, kv_len=kv_len, causal=causal, **fused)
