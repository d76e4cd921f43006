"""Flash-attention backward: the CUDA kernels, their plain PyTorch
version, and the differentiable attention ``torch.autograd.Function``.

``flash_attention_bwd`` launches the dq and dkv kernels through their
wrappers ``flash_attention_bwd_dq`` and ``flash_attention_bwd_dkv`` for CUDA
tensors, and those run their plain versions for CPU tensors; any other
device raises. Each wrapper picks its kernel by its route
(:func:`dq_route`, :func:`dkv_route`): bf16 the tensor-core kernels
``csrc/flash_attention_bwd_dq_tc.cu`` and ``csrc/flash_attention_bwd_tc.cu``
(``mma.sync`` with ``ldmatrix`` and ``cp.async``), fp32 the CUDA-core ones of
``csrc/flash_attention_bwd.cu``; there is no fallback between them. The
kernels replace the TPU kernels
``alg_tpu/ops/flash_attention_bwd.py:_dq_kernel`` and ``:_dkv_kernel`` at head
dims 64, 80 and 128: dense, ``causal``, ``kv_len``, Sq != Sk. From q, k, v,
the forward's output ``o`` and base-2 row log-sum-exp ``lse`` and the output
cotangent ``do``::

    s  = (q·kᵀ)·scale·log2e, masked like the forward      p  = exp2(s - lse)
    dp = do·vᵀ         delta = rowsum(do ⊙ o)              ds = p ⊙ (dp - delta)
    dq = scale·ds·k    dk = scale·dsᵀ·q                    dv = pᵀ·do

``delta`` is one fp32 PyTorch reduction outside the kernels, as the JAX
package computes it outside its Pallas kernels. A row with no visible key
(``lse = -inf``) gets ``dq = 0`` and adds nothing to ``dk``/``dv``. The
kernels and their plain versions round dS (and for dv P) to the input dtype
before the products that make dq, dk and dv, as the JAX package's kernels
do; in fp32 that is an identity.

:class:`FlashAttentionFunction` is the counterpart of
``alg_tpu/ops/flash_attention_bwd.py:flash_attention_diff``: its forward is
the forward kernel (with the LSE output only when a gradient is needed), its
backward the two kernels above. An additive ``bias`` (T5's relative
positions; text encoders are frozen in every training mode) takes a
recompute VJP through the plain version instead, as the JAX package's does
through its XLA reference. ``kv_len`` gets no gradient. On CPU tensors the
forward is the plain version and the backward ``flash_attention_bwd_plain``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from alg_tpu_torch.ops import _build
from alg_tpu_torch.ops._autograd import plain_vjp
from alg_tpu_torch.ops.flash_attention import (LOG2E, _check, attention_plain, attention_plain_residuals,
                                               flash_attention, mask_logits)


def _p_ds_plain(q, k, v, do, lse, delta, scale, causal, kv_len):
    """fp32 ``(p, ds)`` ``[B, H, Sq, Sk]``: the tile arithmetic both kernels share."""
    s, _ = mask_logits(torch.matmul(q.float(), k.float().transpose(-1, -2)) * (scale * LOG2E), kv_len, causal)
    lse_safe = torch.where(torch.isneginf(lse), torch.full_like(lse, 1e30), lse)
    p = torch.exp2(s - lse_safe[..., None])
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    return p, p * (dp - delta[..., None])


def flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, scale: float, causal: bool = False,
                                 kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The dq kernels' arithmetic, step by step in fp32. dS is rounded to the
    dtype of ``q`` before its product with k, as ``alg_tpu``'s ``_dq_kernel``
    casts it."""
    _, ds = _p_ds_plain(q, k, v, do, lse, delta, scale, causal, kv_len)
    return (torch.matmul(ds.to(q.dtype).float(), k.float()) * scale).to(q.dtype)


def flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, scale: float, causal: bool = False,
                                  kv_len: Optional[torch.Tensor] = None):
    """The dkv kernel's arithmetic, step by step in fp32: ``(dk, dv)``. P and
    dS are rounded to the dtype of ``do`` and ``q`` before their products, as
    ``alg_tpu``'s ``_dkv_kernel`` casts them."""
    p, ds = _p_ds_plain(q, k, v, do, lse, delta, scale, causal, kv_len)
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), q.float()) * scale
    return dk.to(k.dtype), torch.matmul(p.to(do.dtype).float().transpose(-1, -2), do.float()).to(v.dtype)


def row_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """``rowsum(do ⊙ o)`` in fp32, ``[B, H, Sq]``: what both kernels subtract from ``dp``."""
    return (do.float() * o.float()).sum(dim=-1)


def flash_attention_bwd_plain(q, k, v, o, lse, do, scale: float, causal: bool = False,
                              kv_len: Optional[torch.Tensor] = None):
    """``(dq, dk, dv)`` by the kernels' arithmetic (not autograd through the plain forward)."""
    delta = row_delta(o, do)
    return (flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, scale, causal, kv_len),
            *flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, scale, causal, kv_len))


# the C entry point of each kernel by the route of dq_route / dkv_route, "{d}" the head dim
_ENTRY_NAMES = {"dq_tc": "alg_flash_attention_bwd_dq_tc_d{d}", "dq_cuda_core": "alg_flash_attention_bwd_dq_d{d}",
                "dkv_tc": "alg_flash_attention_bwd_dkv_tc_d{d}", "dkv_cuda_core": "alg_flash_attention_bwd_dkv_d{d}"}


def _route(q: torch.Tensor, what: str) -> str:
    if q.device.type == "cpu":
        return "plain"
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention_bwd_{what}: no kernel for device {q.device}")
    if q.dtype not in _build.DTYPE_CODE:
        raise TypeError(f"flash backward kernels take float32 or bfloat16, got {q.dtype}")
    return "tc" if q.dtype == torch.bfloat16 else "cuda_core"


def dq_route(q: torch.Tensor) -> str:
    """Which implementation a dq call on ``q`` takes: ``"plain"`` for a CPU
    tensor; on a CUDA tensor ``"tc"`` (the tensor-core kernel) for bf16 and
    ``"cuda_core"`` for fp32. Raises for any other device or dtype."""
    return _route(q, "dq")


def dkv_route(q: torch.Tensor) -> str:
    """As :func:`dq_route`, for a dkv call."""
    return _route(q, "dkv")


@functools.cache
def _entry(head_dim: int, which: str):
    """The C entry point of a head dim: a key of ``_ENTRY_NAMES``."""
    fn = getattr(_build.load(), _ENTRY_NAMES[which].format(d=head_dim))
    n_out = 1 if which.startswith("dq") else 2
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * (7 + n_out) + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_bwd(q, k, v, do, lse, delta, kv_len):
    _check(q, k, v, None, kv_len)
    b, h, sq, _ = q.shape
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"do {do.dtype} {tuple(do.shape)} does not match q {q.dtype} {tuple(q.shape)}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or tuple(t.shape) != (b, h, sq):
            raise ValueError(f"{name}: want float32 {(b, h, sq)}, got {t.dtype} {tuple(t.shape)}")
    for t in (do, lse, delta):
        if t.device != q.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("flash backward operands must be contiguous, 16-byte aligned and on one device")


def _launch(which, outs, q, k, v, do, lse, delta, scale, causal, kv_len):
    b, h, sq, d = q.shape
    entry = _entry(d, which)
    with torch.cuda.device(q.device):
        rc = entry(_build.DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                   lse.data_ptr(), delta.data_ptr(), None if kv_len is None else kv_len.data_ptr(),
                   *(t.data_ptr() for t in outs), b, h, sq, k.shape[2], float(scale), int(causal),
                   torch.cuda.current_stream().cuda_stream)
    _build.check(rc, f"flash-attention {which} kernel")


def flash_attention_bwd_dq(q, k, v, do, lse, delta, scale: float, causal: bool = False,
                           kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``dq`` from ``lse`` and ``delta`` (:func:`row_delta`), fp32 ``[B, H, Sq]``.
    CPU tensors take the plain version; CUDA tensors a kernel (see
    :func:`dq_route`), or raise."""
    which = dq_route(q)
    if which == "plain":
        return flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, scale, causal, kv_len)
    _check_bwd(q, k, v, do, lse, delta, kv_len)
    dq = torch.empty_like(q)
    _launch("dq_" + which, (dq,), q, k, v, do, lse, delta, scale, causal, kv_len)
    flash_attention_bwd_dq.launches += 1
    flash_attention_bwd_dq.launches_by_route[which] += 1
    return dq


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale: float, causal: bool = False,
                            kv_len: Optional[torch.Tensor] = None):
    """``(dk, dv)`` from ``lse`` and ``delta``. CPU tensors take the plain
    version; CUDA tensors a kernel (see :func:`dkv_route`), or raise."""
    which = dkv_route(q)
    if which == "plain":
        return flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, scale, causal, kv_len)
    _check_bwd(q, k, v, do, lse, delta, kv_len)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("dkv_" + which, (dk, dv), q, k, v, do, lse, delta, scale, causal, kv_len)
    flash_attention_bwd_dkv.launches += 1
    flash_attention_bwd_dkv.launches_by_route[which] += 1
    return dk, dv


flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dq.launches_by_route = {"tc": 0, "cuda_core": 0}  # the same launches by dq_route()
flash_attention_bwd_dkv.launches = 0
flash_attention_bwd_dkv.launches_by_route = {"tc": 0, "cuda_core": 0}  # the same launches by dkv_route()


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
                        do: torch.Tensor, scale: float, causal: bool = False,
                        kv_len: Optional[torch.Tensor] = None):
    """``(dq, dk, dv)`` of ``flash_attention(q, k, v, scale, causal=causal,
    kv_len=kv_len)`` for the output cotangent ``do``; ``o`` and ``lse`` are
    that call's output and residual (``return_residuals=True``)."""
    if o.shape != q.shape or o.dtype != q.dtype:
        raise ValueError(f"o {o.dtype} {tuple(o.shape)} does not match q {q.dtype} {tuple(q.shape)}")
    delta = row_delta(o, do)
    return (flash_attention_bwd_dq(q, k, v, do, lse, delta, scale, causal, kv_len),
            *flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale, causal, kv_len))


class FlashAttentionFunction(torch.autograd.Function):
    """``apply(q, k, v, kv_len, bias, scale, causal, stable)``: attention whose
    forward is the flash kernel and whose backward is the dq and dkv kernels
    (plain versions for CPU tensors). With a ``bias`` the backward recomputes
    through :func:`attention_plain` instead: the backward kernels take no
    bias, and only the frozen text encoders pass one."""

    @staticmethod
    def forward(ctx, q, k, v, kv_len, bias, scale, causal, stable):
        ctx.scale, ctx.causal = scale, causal
        need_grad = any(ctx.needs_input_grad)
        want_lse = need_grad and bias is None  # the bias case recomputes in its backward
        from_kernel = want_lse and q.device.type != "cpu"
        res = flash_attention(q, k, v, scale, bias=bias, stable=stable, kv_len=kv_len, causal=causal,
                              return_residuals=from_kernel)
        out, lse = res if from_kernel else (res, None)
        if want_lse and not from_kernel:  # on the CPU the output stays bit for bit that of a call without a gradient
            lse = attention_plain_residuals(q, k, v, scale, None, kv_len, causal)[1]
        if need_grad:
            ctx.save_for_backward(q, k, v, kv_len, bias, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, kv_len, bias, out, lse = ctx.saved_tensors
        if bias is None:
            dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do.contiguous(), ctx.scale, ctx.causal, kv_len)
            return dq, dk, dv, None, None, None, None, None
        scale, causal = ctx.scale, ctx.causal
        dq, dk, dv, dbias = plain_vjp(lambda q_, k_, v_, b_: attention_plain(q_, k_, v_, scale, b_, kv_len, causal),
                                      (q, k, v, bias), ctx.needs_input_grad[:3] + ctx.needs_input_grad[4:5], do)
        return dq, dk, dv, None, dbias, None, None, None
