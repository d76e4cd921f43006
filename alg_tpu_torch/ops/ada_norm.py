"""The DiT blocks' AdaLN chain in one pass: gated residual, LayerNorm with
fp32 statistics and modulation.

``ada_norm`` launches the CUDA kernel ``csrc/ada_norm.cu`` for CUDA tensors
and runs the plain PyTorch version :func:`ada_norm_plain` for CPU tensors;
any other device raises. The kernel replaces no TPU kernel (XLA fused this
chain on the TPU); the plain version is the composition the CogVideoX and Wan
blocks ran before it, op for op.

The rows come in one or two streams (CogVideoX: the text rows, then the video
rows), each a residual ``[B, R, d]`` with its own gate, scale and shift
``[B, 1, d]``. In one call, by the arguments given:

* with ``o`` (the branch output ``[B, ΣR, d]``, the streams' rows one after
  the other), each stream's residual becomes ``x + gate * o_rows``, or
  ``x + o_rows`` without gates;
* with ``norm`` (the default), the residuals are LayerNormed (fp32 mean and
  variance, the fp32 ``weight``/``bias`` affine when given, cast back) and,
  with ``scales``/``shifts``, modulated ``· (1 + scale) + shift``; the
  streams' rows come back as one joint ``[B, ΣR, d]`` tensor, the input the
  attention or the MLP takes.

The kernel rounds where the plain ops round, in their order, and differs
only in the order of the two row sums: the residuals are bit for bit the
plain ones, the normed rows within one rounding of the activation dtype at
the norm. It reads every tensor through its strides (unit stride along d,
16-byte aligned rows), so ``o`` may be a slice of a larger tensor; d is a
multiple of 8, at most 5,120.

The call is differentiable. On CUDA tensors that need a gradient the forward
is still the kernel, and the backward differentiates the plain composition
on the saved inputs (LoRA steps, remat's recomputation).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from alg_tpu_torch.models import layers as L
from alg_tpu_torch.ops import _build
from alg_tpu_torch.ops._autograd import needs_grad, plain_vjp

MAX_DIM = 5120  # the kernel keeps a row in the registers of at most 640 threads, 8 values each
MAX_STREAMS = 2
# mode bits of the C entry (csrc/ada_norm.cu)
_ADD, _GATE, _NORM, _AFFINE, _MOD = 1, 2, 4, 8, 16


def ada_norm_plain(xs, o=None, *, gates=None, scales=None, shifts=None, weight=None, bias=None, eps=1e-5,
                   norm=True):
    """Reference composition: the residual adds, ``layer_norm`` and the
    modulation in PyTorch ops, as the DiT blocks wrote them."""
    xs = tuple(xs)
    if o is not None:
        added, row0 = [], 0
        for i, x in enumerate(xs):
            rows = o[:, row0:row0 + x.shape[1]]
            row0 += x.shape[1]
            added.append(x + rows if gates is None else x + gates[i] * rows)
        xs = tuple(added)
    if not norm:
        return xs, None
    ys = [L.layer_norm(x, weight, bias, eps) for x in xs]
    if scales is not None:
        ys = [y * (1 + scale) + shift for y, scale, shift in zip(ys, scales, shifts)]
    return xs, ys[0] if len(ys) == 1 else torch.cat(ys, dim=1)


class _Spec(NamedTuple):
    """What a call does: the streams, and which parts of the chain it runs."""

    streams: int
    add: bool
    gated: bool
    modulated: bool
    affine: bool
    norm: bool
    eps: float


def _spec(xs, o, gates, scales, shifts, weight, bias, eps, norm) -> _Spec:
    """The call's :class:`_Spec`, after the arguments' checks on any device."""
    n = len(xs)
    if not 1 <= n <= MAX_STREAMS:
        raise ValueError(f"ada_norm takes 1 or {MAX_STREAMS} streams, got {n}")
    if o is None and not norm:
        raise ValueError("ada_norm with neither a branch output nor a norm does nothing")
    if gates is not None and o is None:
        raise ValueError("ada_norm gates need a branch output o")
    if (scales is None) != (shifts is None) or (weight is None) != (bias is None):
        raise ValueError("ada_norm takes scales with shifts and weight with bias")
    if not norm and (scales is not None or weight is not None):
        raise ValueError("ada_norm's scales and affine need norm=True")
    for name, vecs in (("gates", gates), ("scales", scales), ("shifts", shifts)):
        if vecs is not None and len(vecs) != n:
            raise ValueError(f"ada_norm {name}: one a stream, want {n}, got {len(vecs)}")
    return _Spec(n, o is not None, gates is not None, scales is not None, weight is not None, bool(norm), float(eps))


def _flat(xs, o, gates, scales, shifts, weight, bias) -> tuple:
    n = len(xs)
    return (*xs, o, *(gates or (None,) * n), *(scales or (None,) * n), *(shifts or (None,) * n), weight, bias)


def _unflat(spec: _Spec, t):
    """(xs, o, gates, scales, shifts, weight, bias) from :func:`_flat`'s tuple."""
    n = spec.streams
    gates, scales, shifts = (tuple(t[n + 1 + k * n:n + 1 + (k + 1) * n]) for k in range(3))
    return tuple(t[:n]), t[n], gates if spec.gated else None, scales if spec.modulated else None, \
        shifts if spec.modulated else None, t[-2], t[-1]


def _outputs(spec: _Spec, xs, y) -> tuple:
    """The call's tensors: the new residuals with a branch output, then the joint normed rows with ``norm``."""
    return (*(xs if spec.add else ()), *((y,) if spec.norm else ()))


def _plain_flat(spec: _Spec, *t) -> tuple:
    xs, o, gates, scales, shifts, weight, bias = _unflat(spec, t)
    return _outputs(spec, *ada_norm_plain(xs, o, gates=gates, scales=scales, shifts=shifts, weight=weight,
                                          bias=bias, eps=spec.eps, norm=spec.norm))


class _Stream(ctypes.Structure):
    _fields_ = [(name, ctypes.c_void_p) for name in ("x", "x_out", "gate", "scale", "shift")] + [
        (name, ctypes.c_longlong) for name in ("x_sb", "x_sr", "xo_sb", "xo_sr", "gate_sb", "scale_sb", "shift_sb",
                                               "rows", "row0", "blocks")]


class _Args(ctypes.Structure):
    _fields_ = [("st", _Stream * MAX_STREAMS)] + [(name, ctypes.c_void_p) for name in ("o", "weight", "bias", "y")] + [
        (name, ctypes.c_longlong) for name in ("o_sb", "o_sr", "y_sb", "y_sr", "batch", "d", "n_streams")] + [
        ("eps", ctypes.c_float)]


@functools.cache
def _entry():
    fn = _build.load().alg_ada_norm
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(_Args), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _rows_ok(t: torch.Tensor) -> bool:
    """Unit stride along d and 16-byte aligned rows (a stride over a dim of one element is never stepped)."""
    vec = 16 // t.element_size()
    return t.stride(-1) == 1 and t.data_ptr() % 16 == 0 and all(
        st % vec == 0 for st, size in zip(t.stride()[:-1], t.shape[:-1]) if size > 1)


def _check(xs, o, gates, scales, shifts, weight, bias):
    x0 = xs[0]
    if x0.dtype not in _build.DTYPE_CODE:
        raise TypeError(f"ada_norm kernel takes float32 or bfloat16, got {x0.dtype}")
    if x0.dim() != 3:
        raise ValueError(f"ada_norm kernel takes residuals [B, R, d], got {tuple(x0.shape)}")
    b, d = x0.shape[0], x0.shape[2]
    if d % 8 or not 8 <= d <= MAX_DIM or b < 1:
        raise ValueError(f"ada_norm kernel takes a width d that is a multiple of 8 and at most {MAX_DIM} (a row "
                         f"lives in the registers of d/8 threads), and B >= 1; got B = {b}, d = {d}")
    rows = sum(x.shape[1] for x in xs)
    if rows < 1:
        raise ValueError("ada_norm kernel takes at least one row")
    vecs = [v for group in (gates, scales, shifts) if group is not None for v in group]
    named = [("x", x, (b, x.shape[1], d)) for x in xs] + [("v", v, (b, 1, d)) for v in vecs]
    if o is not None:
        named.append(("o", o, (b, rows, d)))
    for name, t, shape in named:
        if t.dim() != 3 or tuple(t.shape) != shape:
            raise ValueError(f"ada_norm kernel {name}: want shape {shape}, got {tuple(t.shape)}")
        if t.dtype != x0.dtype or t.device != x0.device:
            raise TypeError(f"ada_norm kernel {name}: want {x0.dtype} on {x0.device}, got {t.dtype} on {t.device}")
        if not _rows_ok(t):
            raise ValueError(f"ada_norm kernel {name}: want unit stride along d and 16-byte aligned rows, got "
                             f"strides {t.stride()}")
    for name, t in (("weight", weight), ("bias", bias)):
        if t is not None and (tuple(t.shape) != (d,) or not t.is_floating_point() or t.device != x0.device):
            raise ValueError(f"ada_norm kernel {name}: want a float [{d}] on {x0.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


def _launch(spec: _Spec, *t) -> tuple:
    xs, o, gates, scales, shifts, weight, bias = _unflat(spec, t)
    _check(xs, o, gates, scales, shifts, weight, bias)
    n, add, gated, modulated, affine, norm, eps = spec
    x0 = xs[0]
    b, d, dev = x0.shape[0], x0.shape[2], x0.device
    rows = sum(x.shape[1] for x in xs)
    new_xs = tuple(torch.empty(x.shape, dtype=x.dtype, device=dev) for x in xs) if add else ()
    y = torch.empty((b, rows, d), dtype=x0.dtype, device=dev) if norm else None
    if affine:  # the fp32 affine, as layer_norm takes it
        weight, bias = weight.float().contiguous(), bias.float().contiguous()
    args = _Args(batch=b, d=d, n_streams=n, eps=eps)
    row0 = 0
    for z, x in enumerate(xs):
        st = args.st[z]
        st.x, st.x_sb, st.x_sr, st.rows, st.row0 = x.data_ptr(), x.stride(0), x.stride(1), x.shape[1], row0
        row0 += x.shape[1]
        if add:
            st.x_out, st.xo_sb, st.xo_sr = new_xs[z].data_ptr(), new_xs[z].stride(0), new_xs[z].stride(1)
        if gated:
            st.gate, st.gate_sb = gates[z].data_ptr(), gates[z].stride(0)
        if modulated:
            st.scale, st.scale_sb = scales[z].data_ptr(), scales[z].stride(0)
            st.shift, st.shift_sb = shifts[z].data_ptr(), shifts[z].stride(0)
    if add:
        args.o, args.o_sb, args.o_sr = o.data_ptr(), o.stride(0), o.stride(1)
    if affine:
        args.weight, args.bias = weight.data_ptr(), bias.data_ptr()
    if norm:
        args.y, args.y_sb, args.y_sr = y.data_ptr(), y.stride(0), y.stride(1)
    mode = (_ADD * add) | (_GATE * gated) | (_NORM * norm) | (_AFFINE * affine) | (_MOD * modulated)
    with torch.cuda.device(dev):
        rc = _entry()(_build.DTYPE_CODE[x0.dtype], mode, ctypes.byref(args), torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "ada_norm kernel")
    ada_norm.launches += 1
    return _outputs(spec, new_xs, y)


class _AdaNormFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, spec, *t):
        ctx.spec = spec
        ctx.save_for_backward(*t)
        return _launch(spec, *t)

    @staticmethod
    def backward(ctx, *grads):
        spec = ctx.spec
        return (None,) + plain_vjp(lambda *t: _plain_flat(spec, *t), ctx.saved_tensors, ctx.needs_input_grad[1:],
                                   grads)


def ada_norm(xs, o=None, *, gates=None, scales=None, shifts=None, weight=None, bias=None, eps: float = 1e-5,
             norm: bool = True):
    """The residual streams ``xs`` (``[B, R_i, d]`` each, in the order of
    the joint rows) after adding ``o`` (``[B, ΣR_i, d]``; times the stream's
    gate ``[B, 1, d]`` with ``gates``), and, with ``norm``, their LayerNorm
    (affine ``weight``/``bias`` [d] when given, ``eps``) modulated by each
    stream's ``scales``/``shifts`` ``[B, 1, d]`` when given.

    Returns ``(residuals, y)``: the tuple of new residuals (``xs`` itself
    without ``o``) and the joint normed rows ``[B, ΣR_i, d]`` (None without
    ``norm``). CPU tensors take the plain version; CUDA tensors the kernel,
    one launch a call, or raise."""
    xs = tuple(xs)
    spec = _spec(xs, o, gates, scales, shifts, weight, bias, eps, norm)
    device = xs[0].device
    if device.type == "cpu":
        return ada_norm_plain(xs, o, gates=gates, scales=scales, shifts=shifts, weight=weight, bias=bias, eps=eps,
                              norm=norm)
    if device.type != "cuda":
        raise RuntimeError(f"ada_norm: no kernel for device {device}")
    t = _flat(xs, o, gates, scales, shifts, weight, bias)
    out = _AdaNormFunction.apply(spec, *t) if needs_grad(*t) else _launch(spec, *t)
    return (tuple(out[:spec.streams]) if spec.add else xs), (out[-1] if spec.norm else None)


ada_norm.launches = 0
