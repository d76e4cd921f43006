"""Flash-attention forward: the CUDA kernel and its plain PyTorch version.

``flash_attention`` launches ``csrc/flash_attention.cu`` for CUDA tensors
and runs :func:`attention_plain` for CPU tensors; any other device raises.
The kernel replaces the TPU kernel
``alg_tpu/ops/flash_attention.py:_fwd_kernel`` at head dims 64, 80 and 128:
``stable`` (running max) or not (bounded logits, the DiTs' fast path),
Sq != Sk (cross-attention), an optional additive fp32 bias
``[1|B, H, Sq, Sk]`` (T5's relative-position bias), an optional per-batch
key count ``kv_len`` ``[B]`` (the prefix mask of UMT5, Llama, the Hunyuan
token refiner and the Hunyuan DiT's joint [video; text] sequence) and
``causal`` (Llama with ``kv_len`` at head dim 128, the CLIP text encoder at
64): query i sees key j iff ``j <= i + (Sk - Sq)``. The options compose.
``return_residuals=True`` also returns the base-2 row log-sum-exp of the
scaled, biased, masked logits, fp32 ``[B, H, Sq]``, ``-inf`` on a row with no
visible key: what the backward kernels (``ops/flash_attention_bwd``) and a
ring merge need. The in-kernel qk prolog is not ported yet.

``flash_attention`` itself records no autograd graph; differentiable calls go
through :func:`alg_tpu_torch.ops.attention.attention`.

The plain version mirrors ``alg_tpu/ops/attention.py:_xla_attention``:
fp32 logits times ``scale`` plus ``bias``, keys past the causal diagonal or
at or past ``kv_len`` masked to -inf, an fp32 softmax, probabilities cast to
the value dtype, then ``P·V``. A row with no visible key (``kv_len`` 0, or a
causal row when Sq > Sk) comes out as zeros, as from the kernels on both
machines; ``_xla_attention`` gives NaN there. The kernel keeps P in fp32, so
in bf16 the two differ by the rounding of P and of the output.
:func:`attention_plain_residuals` mirrors ``_xla_attention_residuals`` (base-2
logits, explicit max, the LSE beside the output), with ``causal`` and ``bias``
as well.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from alg_tpu_torch.ops import _build
from alg_tpu_torch.ops._autograd import needs_grad

HEAD_DIMS = (64, 80, 128)  # the variants csrc/flash_attention.cu declares, one entry point each
LOG2E = 1.4426950408889634


def mask_logits(logits, kv_len: Optional[torch.Tensor] = None, causal: bool = False):
    """``logits`` ``[B, H, Sq, Sk]`` with -inf where query i may not see key
    j (``j >= kv_len[b]``, or ``j > i + (Sk - Sq)`` when causal), and the rows
    with no visible key as a mask broadcastable to ``[B, 1, Sq, 1]`` (None
    when there is no mask at all)."""
    sq, sk = logits.shape[-2:]
    col = torch.arange(sk, device=logits.device)
    empty = None
    if causal:
        row = torch.arange(sq, device=logits.device)[:, None] + (sk - sq)
        logits = logits.masked_fill(col[None, :] > row, float("-inf"))
        empty = (row < 0)[None, None]
    if kv_len is not None:
        logits = logits.masked_fill((col[None, :] >= kv_len[:, None])[:, None, None, :], float("-inf"))
        no_keys = (kv_len <= 0)[:, None, None, None]
        empty = no_keys if empty is None else empty | no_keys
    return logits, empty


def attention_plain(q, k, v, scale: float, bias: Optional[torch.Tensor] = None,
                    kv_len: Optional[torch.Tensor] = None, causal: bool = False) -> torch.Tensor:
    """Softmax attention over ``[B, H, S, D]`` with an fp32 softmax."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        logits = logits + bias.float()
    logits, empty = mask_logits(logits, kv_len, causal)
    probs = torch.softmax(logits, dim=-1)
    if empty is not None:  # a fully masked row is 0/0 above
        probs = probs.masked_fill(empty, 0.0)
    return torch.matmul(probs.to(v.dtype), v)


def attention_plain_residuals(q, k, v, scale: float, bias: Optional[torch.Tensor] = None,
                              kv_len: Optional[torch.Tensor] = None, causal: bool = False):
    """``(out, lse)``: attention through base-2 logits and an explicit max,
    and the fp32 ``[B, H, Sq]`` base-2 log-sum-exp of the scaled (biased,
    masked) logits; a row with no visible key gives zeros and ``-inf``."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (scale * LOG2E)
    if bias is not None:
        s = s + bias.float() * LOG2E
    s, _ = mask_logits(s, kv_len, causal)
    m = s.amax(dim=-1, keepdim=True)
    m_safe = torch.where(torch.isneginf(m), torch.zeros_like(m), m)  # fully masked rows
    p = torch.exp2(s - m_safe)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.matmul((p / torch.where(l == 0.0, torch.ones_like(l), l)).to(v.dtype), v)
    return out, (m_safe + torch.log2(l))[..., 0]  # log2(0) = -inf


@functools.cache
def _entry(head_dim: int):
    fn = getattr(_build.load(), f"alg_flash_attention_fwd_d{head_dim}")
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_void_p] * 3 + [
        ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, bias, kv_len=None):
    if q.dtype not in _build.DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash kernel takes float32 or bfloat16 q/k/v of one dtype, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"flash kernel takes [B, H, S, D] with D in {HEAD_DIMS}, got q {tuple(q.shape)}")
    b, h, sq, d = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, h) or k.shape[-1] != d:
        raise ValueError(f"k/v {tuple(k.shape)}/{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if sq == 0 or k.shape[2] == 0 or b * h > 65535:
        raise ValueError(f"flash kernel cannot take q {tuple(q.shape)}, k {tuple(k.shape)}")
    operands = [q, k, v]
    if bias is not None:
        want = (h, sq, k.shape[2])
        if bias.dtype != torch.float32 or bias.dim() != 4 or tuple(bias.shape[1:]) != want \
                or bias.shape[0] not in (1, b):
            raise ValueError(f"flash bias: want float32 [1|{b}, {h}, {sq}, {k.shape[2]}], got "
                             f"{bias.dtype} {tuple(bias.shape)}")
        operands.append(bias)
    if kv_len is not None:
        if kv_len.dtype != torch.int32 or tuple(kv_len.shape) != (b,):
            raise ValueError(f"flash kv_len: want int32 [{b}], got {kv_len.dtype} {tuple(kv_len.shape)}")
        operands.append(kv_len)
    for t in operands:
        if t.device != q.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("flash operands must be contiguous, 16-byte aligned and on one device")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                    bias: Optional[torch.Tensor] = None, stable: bool = True,
                    kv_len: Optional[torch.Tensor] = None, causal: bool = False,
                    return_residuals: bool = False):
    """``softmax(q·kᵀ·scale + bias)·v`` over ``[B, H, S, D]``, D in 64, 80,
    128; batch row ``b`` attends to its first ``kv_len[b]`` keys only, and
    with ``causal`` query ``i`` to no key past ``i + (Sk - Sq)``. With
    ``return_residuals`` the result is ``(out, lse)``, ``lse`` the fp32
    ``[B, H, Sq]`` base-2 log-sum-exp of the scaled logits.

    ``stable=False`` skips the running max: exact in fp32 while
    |logit·log2e| stays well below 126, which trained DiT attention does.
    CPU tensors take the plain version; CUDA tensors the kernel, or raise.
    No autograd graph is recorded here (see ``ops/attention.py``)."""
    if q.device.type == "cpu":
        if return_residuals:
            return attention_plain_residuals(q, k, v, scale, bias, kv_len, causal)
        return attention_plain(q, k, v, scale, bias, kv_len, causal)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention: no kernel for device {q.device}")
    _check(q, k, v, bias, kv_len)
    if needs_grad(q, k, v, bias):
        raise RuntimeError("flash_attention records no autograd graph: call ops.attention.attention, which "
                           "differentiates through the backward kernels")
    b, h, sq, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device) if return_residuals else None
    bias_ptr, bias_b_stride = None, 0
    if bias is not None:
        bias_ptr = bias.data_ptr()
        bias_b_stride = 0 if bias.shape[0] == 1 else h * sq * k.shape[2]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _entry(d)(
            _build.DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_ptr, bias_b_stride,
            None if kv_len is None else kv_len.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), b, h, sq, k.shape[2],
            float(scale), int(stable), int(causal), stream,
        )
    _build.check(rc, "flash-attention kernel")
    flash_attention.launches += 1
    if return_residuals:
        flash_attention.residual_launches += 1
        return out, lse
    return out


flash_attention.launches = 0  # every launch of the forward kernel
flash_attention.residual_launches = 0  # those of them that also wrote the LSE
