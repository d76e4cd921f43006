"""Flash-attention forward: the CUDA kernel and its plain PyTorch version.

``flash_attention`` launches ``csrc/flash_attention.cu`` for CUDA tensors
and runs :func:`attention_plain` for CPU tensors; any other device raises.
The kernel replaces the TPU kernel
``alg_tpu/ops/flash_attention.py:_fwd_kernel`` in its dense variants:
``stable`` (running max) or not (bounded logits, the DiT's fast path), with
an optional additive fp32 bias ``[1|B, H, Sq, Sk]`` broadcast over the
batch (T5's relative-position bias). Causal masking, ``kv_len``, head dim
128, the base-2 LSE residuals and the in-kernel qk prolog are not ported
yet.

The plain version mirrors ``alg_tpu/ops/attention.py:_xla_attention``:
fp32 logits times ``scale`` plus ``bias``, an fp32 softmax, probabilities
cast to the value dtype, then ``P·V``. The kernel keeps P in fp32, so in
bf16 the two differ by the rounding of P and of the output.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from alg_tpu_torch.ops import _build

HEAD_DIM = 64


def attention_plain(q, k, v, scale: float, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dense softmax attention over ``[B, H, S, D]`` with an fp32 softmax."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        logits = logits + bias.float()
    probs = torch.softmax(logits, dim=-1)
    return torch.matmul(probs.to(v.dtype), v)


@functools.cache
def _entry():
    fn = _build.load().alg_flash_attention_fwd
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_void_p] + [
        ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, bias):
    if q.dtype not in _build.DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash kernel takes float32 or bfloat16 q/k/v of one dtype, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or q.shape[-1] != HEAD_DIM:
        raise ValueError(f"flash kernel takes [B, H, S, {HEAD_DIM}], got q {tuple(q.shape)}")
    b, h, sq, _ = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, h) or k.shape[-1] != HEAD_DIM:
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
    for t in operands:
        if t.device != q.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("flash operands must be contiguous, 16-byte aligned and on one device")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                    bias: Optional[torch.Tensor] = None, stable: bool = True) -> torch.Tensor:
    """``softmax(q·kᵀ·scale + bias)·v`` over ``[B, H, S, 64]``.

    ``stable=False`` skips the running max: exact in fp32 while
    |logit·log2e| stays well below 126, which trained DiT attention does.
    CPU tensors take the plain version; CUDA tensors the kernel, or raise."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, scale, bias)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention: no kernel for device {q.device}")
    _check(q, k, v, bias)
    b, h, sq, _ = q.shape
    out = torch.empty_like(q)
    bias_ptr, bias_b_stride = None, 0
    if bias is not None:
        bias_ptr = bias.data_ptr()
        bias_b_stride = 0 if bias.shape[0] == 1 else h * sq * k.shape[2]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _entry()(
            _build.DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_ptr, bias_b_stride,
            out.data_ptr(), b, h, sq, k.shape[2], HEAD_DIM, float(scale), int(stable), stream,
        )
    _build.check(rc, "flash-attention kernel")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
