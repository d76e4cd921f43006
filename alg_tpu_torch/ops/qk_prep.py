"""Fused per-head LayerNorm + interleaved RoPE on q and k.

``qk_norm_rope`` launches the CUDA kernel ``csrc/qk_prep.cu`` for a CUDA
tensor and runs the plain PyTorch version :func:`qk_norm_rope_plain` for a
CPU tensor; any other device raises. The kernel replaces the TPU kernel
``alg_tpu/ops/qk_prep.py:_kernel``; the plain version mirrors that
package's ``_xla_compose`` op for op (LayerNorm with fp32 statistics, cast
to the activation dtype, then the rotation in the activation dtype).

The kernel reads ``x`` through its strides, so the DiT passes the
``[B, S, H, D]`` projection viewed as ``[B, H, S, D]`` without a
``.contiguous()`` copy; the result is a new contiguous ``[B, H, S, D]``
tensor. Only the last dim must have unit stride, and every row must start on
a 16-byte boundary.

The kernel rounds once, after the rotation, where the plain version rounds
after each multiply-add: in bf16 the two differ by up to about two bf16
ulps (atol 2e-2 at unit scale). Identity rows (cos 1, sin 0), which the DiT
uses over the text prefix, reduce to the LayerNorm output in both.

The call is differentiable. On a CUDA tensor that needs a gradient the
forward is still the kernel, and the backward differentiates the plain
composition on the saved inputs, as the JAX package does
(``alg_tpu/ops/qk_prep.py:_qk_prep_diff_bwd``: its backward is XLA, not a
kernel): gradients for ``x``, ``scale`` and ``bias``, and for the tables only
if they require one.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from alg_tpu_torch.models import layers as L
from alg_tpu_torch.models import rope as R
from alg_tpu_torch.ops import _build
from alg_tpu_torch.ops._autograd import needs_grad, plain_vjp

HEAD_DIM = 64


def qk_norm_rope_plain(x, scale, bias, cos, sin, eps: float) -> torch.Tensor:
    """Reference composition: ``rope(layer_norm(x))`` in PyTorch ops."""
    return R.apply_rope_interleaved(L.layer_norm(x, scale, bias, eps), cos, sin)


@functools.cache
def _entry():
    fn = _build.load().alg_qk_prep
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_longlong] * 3 + [ctypes.c_void_p] * 5 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def _check(x, scale, bias, cos, sin):
    if x.dtype not in _build.DTYPE_CODE:
        raise TypeError(f"qk_prep kernel takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4 or x.shape[-1] != HEAD_DIM:
        raise ValueError(f"qk_prep kernel takes [B, H, S, {HEAD_DIM}], got {tuple(x.shape)}")
    if x.numel() == 0 or max(x.shape[0] * x.shape[1], x.shape[2] * HEAD_DIM) > 2 ** 31 - 256:
        raise ValueError(f"qk_prep kernel takes a non-empty [B, H, S, {HEAD_DIM}] with B·H and S·D at most "
                         f"2^31 - 256, got {tuple(x.shape)}")
    vec = 16 // x.element_size()
    if x.stride(3) != 1 or any(st % vec for st in x.stride()[:3]) or x.data_ptr() % 16:
        raise ValueError(f"qk_prep kernel takes x with unit stride along D and 16-byte aligned rows, got strides "
                         f"{x.stride()}")
    s = x.shape[2]
    for name, t, shape in (("scale", scale, (HEAD_DIM,)), ("bias", bias, (HEAD_DIM,)),
                           ("cos", cos, (s, HEAD_DIM)), ("sin", sin, (s, HEAD_DIM))):
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"qk_prep {name}: want float32 {shape}, got {t.dtype} {tuple(t.shape)}")
        if t.device != x.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("qk_prep scale, bias and tables must be contiguous, 16-byte aligned and on x's device")


class _QkNormRopeFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, cos, sin, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, scale, bias, cos, sin)
        return _launch(x, scale, bias, cos, sin, eps)

    @staticmethod
    def backward(ctx, grad_out):
        eps = ctx.eps
        return plain_vjp(lambda *t: qk_norm_rope_plain(*t, eps), ctx.saved_tensors, ctx.needs_input_grad[:5],
                         grad_out) + (None,)


def qk_norm_rope(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, cos: torch.Tensor,
                 sin: torch.Tensor, eps: float) -> torch.Tensor:
    """Per-head LayerNorm (affine ``scale``/``bias`` [64]) then RoPE with
    ``cos``/``sin`` [S, 64] on ``x`` [B, H, S, 64] (any strides with a unit
    last stride); the result is contiguous.

    CPU tensors take the plain version; CUDA tensors the kernel (fp32
    ``scale``/``bias``/``cos``/``sin``, contiguous), or raise."""
    if x.device.type == "cpu":
        return qk_norm_rope_plain(x, scale, bias, cos, sin, eps)
    if x.device.type != "cuda":
        raise RuntimeError(f"qk_norm_rope: no kernel for device {x.device}")
    if needs_grad(x, scale, bias, cos, sin):
        return _QkNormRopeFunction.apply(x, scale, bias, cos, sin, eps)
    return _launch(x, scale, bias, cos, sin, eps)


def _launch(x, scale, bias, cos, sin, eps):
    _check(x, scale, bias, cos, sin)
    b, h, s, d = x.shape
    out = torch.empty((b, h, s, d), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _entry()(
            _build.DTYPE_CODE[x.dtype], x.data_ptr(), x.stride(0), x.stride(1), x.stride(2), scale.data_ptr(),
            bias.data_ptr(), cos.data_ptr(), sin.data_ptr(), out.data_ptr(), b * h * s, h, s, HEAD_DIM, eps, stream,
        )
    _build.check(rc, "qk_prep kernel")
    qk_norm_rope.launches += 1
    return out


qk_norm_rope.launches = 0
