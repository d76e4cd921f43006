"""Interleaved-pair RoPE on q and k (no norm): Wan's self-attention.

``rope_interleaved`` launches the CUDA kernel ``csrc/rope.cu`` for a CUDA
tensor and runs the plain PyTorch version
:func:`alg_tpu_torch.models.rope.apply_rope_interleaved` for a CPU tensor;
any other device raises. The kernel replaces the TPU kernel
``alg_tpu/ops/qk_prep.py:_rope_kernel``.

The kernel reads ``x`` through its strides, so the models pass the
``[B, S, H, D]`` projection viewed as ``[B, H, S, D]`` without a
``.contiguous()`` copy; the result is a new contiguous ``[B, H, S, D]``
tensor. Only the last dim must have unit stride, and every row must start on
a 16-byte boundary.

The kernel rounds once, after the rotation, where the plain version rounds
after each multiply and after the add: in bf16 the two differ by up to about
two bf16 ulps (atol 2e-2 + rtol 1e-2). In fp32 they differ by the fused
multiply-add (a few ulps).

The call is differentiable. On a CUDA tensor that needs a gradient the
forward is still the kernel, and the backward differentiates the plain
version on the saved inputs, as the JAX package does
(``alg_tpu/ops/qk_prep.py:_rope_diff_bwd``: XLA, not a kernel).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from alg_tpu_torch.models.rope import apply_rope_interleaved
from alg_tpu_torch.ops import _build
from alg_tpu_torch.ops._autograd import needs_grad, plain_vjp


@functools.cache
def _entry():
    fn = _build.load().alg_rope_interleaved
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_longlong] * 3 + [ctypes.c_void_p] * 3 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(x, cos, sin):
    if x.dtype not in _build.DTYPE_CODE:
        raise TypeError(f"rope kernel takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4 or x.numel() == 0 or max(x.shape[0] * x.shape[1], x.shape[2] * x.shape[3]) > 2 ** 31 - 256:
        raise ValueError(f"rope kernel takes a non-empty [B, H, S, D] with B·H and S·D at most 2^31 - 256, got "
                         f"{tuple(x.shape)}")
    s, d = x.shape[2:]
    vec = 16 // x.element_size()
    if d % 8 != 0:
        raise ValueError(f"rope kernel takes a head dim that is a multiple of 8, got {d}")
    if x.stride(3) != 1 or any(st % vec for st in x.stride()[:3]) or x.data_ptr() % 16:
        raise ValueError(f"rope kernel takes x with unit stride along D and 16-byte aligned rows, got strides "
                         f"{x.stride()}")
    for name, t in (("cos", cos), ("sin", sin)):
        if tuple(t.shape) != (s, d) or t.dtype != torch.float32:
            raise ValueError(f"rope {name}: want float32 {(s, d)}, got {t.dtype} {tuple(t.shape)}")
        if t.device != x.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("rope tables must be contiguous, 16-byte aligned and on x's device")


class _RopeFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, cos, sin):
        ctx.save_for_backward(x, cos, sin)
        return _launch(x, cos, sin)

    @staticmethod
    def backward(ctx, grad_out):
        return plain_vjp(apply_rope_interleaved, ctx.saved_tensors, ctx.needs_input_grad, grad_out)


def rope_interleaved(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """``x·cos + rot(x)·sin`` with rot: (x0, x1) -> (-x1, x0) on each pair;
    ``x`` [B, H, S, D] (any strides with a unit last stride), ``cos``/``sin``
    [S, D] fp32, rounded to ``x``'s dtype before use.

    CPU tensors take the plain version; CUDA tensors the kernel, or raise."""
    if x.device.type == "cpu":
        return apply_rope_interleaved(x, cos, sin)
    if x.device.type != "cuda":
        raise RuntimeError(f"rope_interleaved: no kernel for device {x.device}")
    if needs_grad(x, cos, sin):
        return _RopeFunction.apply(x, cos, sin)
    return _launch(x, cos, sin)


def _launch(x, cos, sin):
    _check(x, cos, sin)
    b, h, s, d = x.shape
    out = torch.empty((b, h, s, d), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _entry()(
            _build.DTYPE_CODE[x.dtype], x.data_ptr(), x.stride(0), x.stride(1), x.stride(2), cos.data_ptr(),
            sin.data_ptr(), out.data_ptr(), b * h * s, h, s, d, stream,
        )
    _build.check(rc, "rope kernel")
    rope_interleaved.launches += 1
    return out


rope_interleaved.launches = 0
