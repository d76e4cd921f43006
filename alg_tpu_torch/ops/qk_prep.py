"""Fused per-head LayerNorm + interleaved RoPE on q and k.

``qk_norm_rope`` launches the CUDA kernel ``csrc/qk_prep.cu`` for a CUDA
tensor and runs the plain PyTorch version :func:`qk_norm_rope_plain` for a
CPU tensor; any other device raises. The kernel replaces the TPU kernel
``alg_tpu/ops/qk_prep.py:_kernel``; the plain version mirrors that
package's ``_xla_compose`` op for op (LayerNorm with fp32 statistics, cast
to the activation dtype, then the rotation in the activation dtype).

The kernel rounds once, after the rotation, where the plain version rounds
after each multiply-add: in bf16 the two differ by up to about two bf16
ulps (atol 2e-2 at unit scale). Identity rows (cos 1, sin 0), which the DiT
uses over the text prefix, reduce to the LayerNorm output in both.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from alg_tpu_torch.models import layers as L
from alg_tpu_torch.models import rope as R
from alg_tpu_torch.ops import _build

HEAD_DIM = 64


def qk_norm_rope_plain(x, scale, bias, cos, sin, eps: float) -> torch.Tensor:
    """Reference composition: ``rope(layer_norm(x))`` in PyTorch ops."""
    return R.apply_rope_interleaved(L.layer_norm(x, scale, bias, eps), cos, sin)


@functools.cache
def _entry():
    fn = _build.load().alg_qk_prep
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 6 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def _check(x, scale, bias, cos, sin):
    if x.dtype not in _build.DTYPE_CODE:
        raise TypeError(f"qk_prep kernel takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4 or x.shape[-1] != HEAD_DIM:
        raise ValueError(f"qk_prep kernel takes [B, H, S, {HEAD_DIM}], got {tuple(x.shape)}")
    s = x.shape[2]
    for name, t, shape in (("scale", scale, (HEAD_DIM,)), ("bias", bias, (HEAD_DIM,)),
                           ("cos", cos, (s, HEAD_DIM)), ("sin", sin, (s, HEAD_DIM))):
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"qk_prep {name}: want float32 {shape}, got {t.dtype} {tuple(t.shape)}")
    for t in (x, scale, bias, cos, sin):
        if t.device != x.device or not t.is_contiguous() or t.data_ptr() % 8:
            raise ValueError("qk_prep operands must be contiguous, 8-byte aligned and on one device")
    if x.numel() == 0:
        raise ValueError("qk_prep got an empty tensor")


def qk_norm_rope(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, cos: torch.Tensor,
                 sin: torch.Tensor, eps: float) -> torch.Tensor:
    """Per-head LayerNorm (affine ``scale``/``bias`` [64]) then RoPE with
    ``cos``/``sin`` [S, 64] on ``x`` [B, H, S, 64].

    CPU tensors take the plain version; CUDA tensors the kernel (fp32
    ``scale``/``bias``/``cos``/``sin``, contiguous), or raise."""
    if x.device.type == "cpu":
        return qk_norm_rope_plain(x, scale, bias, cos, sin, eps)
    if x.device.type != "cuda":
        raise RuntimeError(f"qk_norm_rope: no kernel for device {x.device}")
    _check(x, scale, bias, cos, sin)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _entry()(
            _build.DTYPE_CODE[x.dtype], x.data_ptr(), scale.data_ptr(), bias.data_ptr(), cos.data_ptr(),
            sin.data_ptr(), out.data_ptr(), x.numel() // HEAD_DIM, x.shape[2], HEAD_DIM, eps, stream,
        )
    _build.check(rc, "qk_prep kernel")
    qk_norm_rope.launches += 1
    return out


qk_norm_rope.launches = 0
