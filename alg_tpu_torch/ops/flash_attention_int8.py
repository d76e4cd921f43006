"""Int8 flash attention for DiT self-attention (opt-in): the CUDA kernel, its
quantizers and its plain PyTorch version.

Counterpart of ``alg_tpu/ops/flash_attention_int8.py``. Q and K are quantized
to int8 with one scale per (batch·head, block of rows) and the logits are an
exact int32 product of the codes; the softmax stays in fp32, in base 2 and
without a running max (the bounded-logit path the DiTs ask for with
``stable=False``). ``pv_int8=False`` (mode ``"qk"``) takes P·V in fp32 from V
as it came; ``pv_int8=True`` (mode ``"full"``) also quantizes P, per (query
row, key block), and V, per (batch·head, channel), so that both products are
integer products. The accuracy scheme is the JAX package's (per-block scales
and K mean-centring over the sequence, which softmax is invariant to).

``flash_attention_int8`` picks its implementation in :func:`route`: CUDA
tensors launch the tensor-core kernel ``csrc/flash_attention_int8_tc.cu``
(Q·Kᵀ, and ``"full"`` mode's P·V, on the int8 tensor cores), through its bf16
entry point for bf16 and its fp32 entry point for fp32 (there ``"qk"`` mode's
P·V is exact fp32 FMAs), and CPU tensors run
:func:`flash_attention_int8_plain`; any other device raises. Self-attention
only, head dims 64 and 128, fp32 or bf16 inputs, any S >= 1, an optional
per-batch key count ``kv_len``; no autograd (an input that requires a
gradient raises). The quantizers are PyTorch ops on the
tensors' device, as they are XLA ops in the JAX package.

``block_q`` and ``block_k`` are part of the numerical contract: they set the
rows that share a Q scale, the keys that share a K scale and, in ``"full"``
mode, the keys that share one P scale a query row. The defaults are the JAX
package's, 512 and 1024, so results compare wherever ``S % 1024 == 0``. The
last block of a sequence that is no multiple is short (the JAX package pads
to whole blocks instead, a TPU memory-layout need; the zeros it adds change no
scale and are masked, so the two agree there too). The kernel takes any
``block_q`` and any ``block_k`` that is a multiple of its key tile,
:data:`KEY_TILE`.

Where this differs from the JAX package, on purpose:

* the K mean, the K block scales and the V channel scales are taken over the
  keys below ``kv_len[b]`` only (the tail is zeroed first), so what lies past
  ``kv_len`` cannot reach the output; there the tail enters all three;
* a (query row, key block) with no visible key adds nothing and no NaN
  arises on the way: a P code is 0 wherever ``p == 0``; there the same case
  is ``0 · inf`` and leans on what a NaN converts to;
* the denominator of ``"qk"`` mode is ``Σ p`` in fp32 at both head dims, and
  of ``"full"`` mode the sum of the same codes as the numerator's at both;
* ``"qk"`` mode rounds P to the value dtype before P·V, as the JAX package
  does, in the plain version and in the kernel alike (in fp32 the rounding
  is the identity, so the fp32 instantiation keeps P as it is).

For ``"full"`` mode the kernel, in both types, takes V's codes transposed,
``[B·H, D, keys]``, and with the keys of every 32-key chunk in the order in
which its P codes arrive from the Q·Kᵀ product (:func:`int8_pv_key_order`):
the wrapper makes that copy once a call.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from alg_tpu_torch.ops import _build
from alg_tpu_torch.ops._autograd import needs_grad
from alg_tpu_torch.ops.flash_attention import LOG2E

HEAD_DIMS = (64, 128)  # the variants the int8 source declares, two entry points each (bf16, fp32)
KEY_TILE = 64  # keys the kernels stage at a time: block_k must be a multiple

# the C entry point of each route, "{d}" the head dim
_ENTRY_NAMES = {"tc": "alg_flash_attention_int8_tc_d{d}", "tc_fp32": "alg_flash_attention_int8_tc_fp32_d{d}"}


def _valid_keys(kv_len: torch.Tensor, s: int) -> torch.Tensor:
    """``[B, 1, S, 1]`` mask of the keys below ``kv_len[b]``."""
    return (torch.arange(s, device=kv_len.device)[None, :] < kv_len[:, None])[:, None, :, None]


def _blocked_codes(x: torch.Tensor, block: int):
    """``x`` fp32 ``[BH, S, D]`` -> (int8 codes ``[BH, S, D]``, fp32 scales
    ``[BH, ceil(S / block)]``): ``amax / 127`` over each block of rows and all
    of D, at least ``1e-6 / 127``; the last block may be short."""
    bh, s, d = x.shape
    full, nblk = s // block, -(-s // block)
    amax = x.new_empty((bh, nblk))
    if full:
        amax[:, :full] = x[:, :full * block].unflatten(1, (full, block)).abs().amax((2, 3))
    if full < nblk:
        amax[:, full] = x[:, full * block:].abs().amax((1, 2))
    sc = amax.clamp_min(1e-6) / 127.0
    per_row = sc.repeat_interleave(block, dim=1)[:, :s, None]
    return torch.round(x / per_row).clamp_(-127, 127).to(torch.int8), sc


def quantize_qk_int8(q: torch.Tensor, k: torch.Tensor, scale: float, block_q: int, block_k: int,
                     kv_len: Optional[torch.Tensor] = None):
    """Quantize q and k ``[B, H, S, D]`` for the int8 kernel.

    Returns ``(q_int8, k_int8, sq_blk, sk_blk)``: codes ``[B·H, S, D]`` and
    fp32 block scales ``[B·H, ceil(S / block)]``; ``sq_blk`` carries
    ``scale · log2(e)``, so the kernel's exponent is ``logit_int · sq · sk``.
    K is mean-centred over the sequence first; with ``kv_len`` (int ``[B]``)
    its keys at or past ``kv_len[b]`` are zeroed before the mean and stay zero
    after it, so they reach no statistic. Rounding is half to even."""
    b, h, s, d = q.shape
    kf = k.float()
    if kv_len is None:
        kf = kf - kf.mean(dim=2, keepdim=True)
    else:
        valid = _valid_keys(kv_len, s)
        kf = kf * valid
        mean = kf.sum(dim=2, keepdim=True) / kv_len.clamp(1, s).to(kf.dtype)[:, None, None, None]
        kf = (kf - mean) * valid
    q_int, sq_blk = _blocked_codes(q.float().reshape(b * h, s, d), block_q)
    k_int, sk_blk = _blocked_codes(kf.reshape(b * h, s, d), block_k)
    return q_int, k_int, sq_blk * (scale * LOG2E), sk_blk


def quantize_v_int8(v: torch.Tensor, kv_len: Optional[torch.Tensor] = None):
    """Per-(batch·head, channel) int8 codes of ``v`` ``[B, H, S, D]`` for the
    int8 P·V product: ``(v_int8 [B·H, S, D], sv [B·H, D] fp32)``. With
    ``kv_len`` the values at or past ``kv_len[b]`` are zeroed first. (The JAX
    package's ``d_aug`` ones column is a trick for its matrix unit's idle
    lanes and has no counterpart here.)"""
    b, h, s, d = v.shape
    vf = v.float()
    if kv_len is not None:
        vf = vf * _valid_keys(kv_len, s)
    vf = vf.reshape(b * h, s, d)
    sv = vf.abs().amax(dim=1).clamp_min(1e-6) / 127.0
    return torch.round(vf / sv[:, None, :]).clamp_(-127, 127).to(torch.int8), sv


def _exact_product(a: torch.Tensor, b: torch.Tensor, largest_sum: int) -> torch.Tensor:
    """``a @ b`` of integer-valued float tensors, exact: in fp32 while every
    sum stays below 2**24, else in fp64."""
    if largest_sum < 2 ** 24:
        return torch.matmul(a, b)
    return torch.matmul(a.double(), b.double())


def flash_attention_int8_plain(q, k, v, scale: float, block_q: int = 512, block_k: int = 1024,
                               pv_int8: bool = False, kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch ops: the same codes, scales, masks
    and denominators (see the module docstring). The inputs are quantized
    whole, as the kernel's wrapper does; the logits are then taken one block
    of query rows and one group of batch·heads at a time (at most 2**28 of
    them, 1 GiB in fp32). The key blocks of ``"full"`` mode are taken side by
    side and summed at the end, where the kernel adds them one after another."""
    b, h, s, d = q.shape
    if k.shape[2] != s:
        raise ValueError("int8 kernel is self-attention only")
    q_int, k_int, sq_blk, sk_blk = quantize_qk_int8(q, k, scale, block_q, block_k, kv_len)
    sk_key = sk_blk.repeat_interleave(block_k, dim=1)[:, :s]  # [BH, S]
    bound = torch.full((b,), s, device=q.device) if kv_len is None else kv_len.clamp(0, s)
    visible = (torch.arange(s, device=q.device)[None, :] < bound[:, None]).repeat_interleave(h, dim=0)[:, None, :]
    vf = v.reshape(b * h, s, d)
    nk = sk_blk.shape[1]
    if pv_int8:
        v_int, sv = quantize_v_int8(v, kv_len)
    out = torch.empty((b * h, s, d), dtype=q.dtype, device=q.device)
    group = max(1, 2 ** 28 // (min(block_q, s) * s))
    for g0 in range(0, b * h, group):
        g = slice(g0, g0 + group)
        kt = k_int[g].float().transpose(1, 2)  # [G, D, S]
        if pv_int8:
            v_blocks = torch.nn.functional.pad(v_int[g].float(), (0, 0, 0, nk * block_k - s)).unflatten(1, (nk, block_k))
        for i, r0 in enumerate(range(0, s, block_q)):
            rows = slice(r0, min(s, r0 + block_q))
            s32 = _exact_product(q_int[g, rows].float(), kt, 127 * 127 * d)  # [G, rows, S], integer-valued
            p = torch.exp2(s32.float() * (sq_blk[g, i, None] * sk_key[g])[:, None, :])
            p = torch.where(visible[g], p, torch.zeros_like(p))
            if not pv_int8:
                acc = torch.matmul(p.to(vf.dtype), vf[g]).float()
                l = p.sum(-1, keepdim=True)
            else:
                pt = torch.nn.functional.pad(p, (0, nk * block_k - s)).unflatten(2, (nk, block_k))
                srow = pt.amax(-1, keepdim=True).clamp_min(1e-37)  # [G, rows, nk, 1]
                codes = torch.round(pt * (127.0 / srow)).clamp_max(127.0)
                codes = torch.where(pt > 0, codes, torch.zeros_like(codes))  # also where 127 / srow overflowed
                acc32 = _exact_product(codes.transpose(1, 2), v_blocks, 127 * 127 * block_k).float()  # [G, nk, rows, D]
                w = (srow * (1.0 / 127.0)).transpose(1, 2)  # [G, nk, rows, 1]
                acc = (acc32 * w * sv[g, None, None, :]).sum(1)
                l = (codes.sum(-1, keepdim=True).transpose(1, 2) * w).sum(1)
            out[g, rows] = (acc / torch.where(l == 0.0, torch.ones_like(l), l)).to(q.dtype)
    return out.reshape(b, h, s, d)


def route(q: torch.Tensor, pv_int8: bool = False) -> str:
    """Which implementation a call on ``q`` takes, in either mode: ``"plain"``
    for a CPU tensor; on a CUDA tensor the tensor-core kernel, ``"tc"`` (its
    bf16 entry point) for bf16 and ``"tc_fp32"`` (its fp32 one) for fp32.
    Raises for any other device or dtype."""
    del pv_int8  # both modes take the same route
    if q.device.type == "cpu":
        return "plain"
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention_int8: no kernel for device {q.device}")
    if q.dtype not in _build.DTYPE_CODE:
        raise TypeError(f"int8 flash kernel takes float32 or bfloat16, got {q.dtype}")
    return "tc" if q.dtype == torch.bfloat16 else "tc_fp32"


def int8_pv_key_order(n_keys: int, device=None) -> torch.Tensor:
    """The key at each position of V's codes as the tensor-core kernel reads
    them, for ``n_keys`` a multiple of 32. The Q·Kᵀ accumulator of lane
    ``4g + t`` of a warp holds keys ``2t, 2t+1, 8+2t, 9+2t`` and the same
    plus 16 of each 32-key chunk; the A operand of the next int8 product
    wants them at positions ``4t..4t+3`` and ``16+4t..16+4t+3``. Position
    ``16h + 4t + e`` of a chunk therefore holds key
    ``16h + 2t + (e & 1) + 8 (e >> 1)``."""
    j = torch.arange(n_keys, device=device)
    within = j % 32
    t, e = (within % 16) // 4, within % 4
    return j - within + 16 * (within // 16) + 2 * t + (e & 1) + 8 * (e >> 1)


def pv_codes_for_tc(v_int: torch.Tensor) -> torch.Tensor:
    """V's codes ``[B·H, S, D]`` as the tensor-core kernel's ``"full"`` mode
    reads them: ``[B·H, D, S']``, S' the next multiple of :data:`KEY_TILE`,
    zero past S, the keys of every 32-key chunk in :func:`int8_pv_key_order`."""
    s = v_int.shape[1]
    keys = -(-s // KEY_TILE) * KEY_TILE
    order = int8_pv_key_order(keys, v_int.device)
    out = v_int.transpose(1, 2)[:, :, order.clamp(max=s - 1)].contiguous()  # one gather
    if keys > s:
        out.index_fill_(2, torch.nonzero(order >= s).flatten(), 0)
    return out


@functools.cache
def _entry(head_dim: int, which: str):
    """The C entry point of a head dim for a route of :func:`route`."""
    fn = getattr(_build.load(), _ENTRY_NAMES[which].format(d=head_dim))
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, block_q, block_k, kv_len):
    if q.dtype not in _build.DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"int8 flash kernel takes float32 or bfloat16 q/k/v of one dtype, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"int8 flash kernel takes [B, H, S, D] with D in {HEAD_DIMS}, got q {tuple(q.shape)}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"int8 flash kernel: k/v {tuple(k.shape)}/{tuple(v.shape)} do not match q {tuple(q.shape)}")
    b, h, s, _ = q.shape
    if s == 0 or b * h == 0 or b * h > 65535:
        raise ValueError(f"int8 flash kernel cannot take q {tuple(q.shape)}")
    if block_q < 1 or block_k < KEY_TILE or block_k % KEY_TILE:
        raise ValueError(f"int8 flash kernel takes block_q >= 1 and block_k a multiple of {KEY_TILE}, got "
                         f"{block_q}, {block_k}")
    if kv_len is not None and (kv_len.dtype != torch.int32 or tuple(kv_len.shape) != (b,)
                               or not kv_len.is_contiguous()):
        raise ValueError(f"int8 flash kv_len: want contiguous int32 [{b}], got {kv_len.dtype} {tuple(kv_len.shape)}")
    for t in (k, v) + (() if kv_len is None else (kv_len,)):
        if t.device != q.device:
            raise ValueError("int8 flash operands must be on one device")


def flash_attention_int8(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, block_q: int = 512,
                         block_k: int = 1024, pv_int8: bool = False,
                         kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dense self-attention over ``[B, H, S, D]`` with an int8 ``Q·Kᵀ``; with
    ``pv_int8`` an int8 ``P·V`` as well. Batch row ``b`` attends to its first
    ``kv_len[b]`` keys only (int32 ``[B]``); a row with none gives zeros.

    CPU tensors take the plain version; CUDA tensors a kernel (see
    :func:`route`), or raise (another head dim than 64 or 128, Sq != Sk, a
    ``block_k`` that is no multiple of :data:`KEY_TILE`). An input that
    requires a gradient raises: the int8 path has no backward."""
    if k.shape[2] != q.shape[2]:
        raise ValueError("int8 kernel is self-attention only")
    if needs_grad(q, k, v):
        raise RuntimeError("flash_attention_int8 is inference only: an input requires a gradient and the int8 "
                           "kernel has no backward (switch the mode off with set_attention_int8(False))")
    which = route(q, pv_int8)
    if which == "plain":
        return flash_attention_int8_plain(q, k, v, scale, block_q, block_k, pv_int8, kv_len)
    _check(q, k, v, block_q, block_k, kv_len)
    b, h, s, d = q.shape
    q_int, k_int, sq_blk, sk_blk = quantize_qk_int8(q, k, scale, block_q, block_k, kv_len)
    if pv_int8:
        v_int, sv = quantize_v_int8(v, kv_len)
        v_arg = pv_codes_for_tc(v_int)
        v_keys = v_arg.shape[-1]  # the keys of a row of V's transposed codes
    else:
        v_arg, sv, v_keys = v.contiguous(), None, 0
    out = torch.empty((b, h, s, d), dtype=q.dtype, device=q.device)
    for t in (q_int, k_int, v_arg, out):
        if t.data_ptr() % 16:
            raise ValueError("int8 flash operands must be 16-byte aligned")
    with torch.cuda.device(q.device):
        rc = _entry(d, which)(
            _build.DTYPE_CODE[q.dtype], q_int.data_ptr(), k_int.data_ptr(), v_arg.data_ptr(), sq_blk.data_ptr(),
            sk_blk.data_ptr(), None if sv is None else sv.data_ptr(),
            None if kv_len is None else kv_len.data_ptr(), out.data_ptr(), b, h, s, block_q, block_k, int(pv_int8),
            v_keys, torch.cuda.current_stream().cuda_stream,
        )
    _build.check(rc, f"int8 flash-attention kernel ({which})")
    flash_attention_int8.launches += 1
    flash_attention_int8.launches_by_route[which] += 1
    return out


flash_attention_int8.launches = 0  # every launch of the int8 kernels
flash_attention_int8.launches_by_route = {"tc": 0, "tc_fp32": 0}  # the same launches by route()
