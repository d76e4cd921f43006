"""Flash-attention forward: the CUDA kernels and their plain PyTorch version.

``flash_attention`` picks its implementation in :func:`route`: CPU tensors
run :func:`attention_plain`; on CUDA tensors :func:`kernel_route` decides by
dtype, head dim and whether a bias is given: bf16 at D = 64 or 128 without a
bias (every CogVideoX DiT self-attention; the Wan DiT's self- and
cross-attention, the HunyuanVideo DiT's, Llama's) launches the Hopper kernel
``csrc/flash_attention_wgmma.cu`` (``wgmma``, TMA, warp specialisation),
other bf16 calls (with a bias: T5, UMT5; at D = 80) the tensor-core kernel
``csrc/flash_attention_tc.cu`` (``mma.sync`` with ``ldmatrix`` and
``cp.async``), fp32 calls the register-tiled CUDA-core kernel
``csrc/flash_attention.cu``; anything else raises. There is no fallback
between them: a kernel that fails to build or launch raises.
The kernels replace the TPU kernel
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
ring merge need.

The qk prolog (``qk_norm``, ``rope_cos``/``rope_sin``, ``prolog_k``; the JAX
package's names) applies a per-head LayerNorm or RMS norm over D (fp32
statistics, fp32 affine, cast back to the activation dtype) and then
interleaved RoPE (tables cast to the activation dtype) to q and, unless
``prolog_k=False``, to k. The JAX kernel does it inside the attention kernel,
on the q rows once and on every K tile in every query block; on the card
:func:`qk_prolog` does it once, in one launch of ``csrc/qk_prolog.cu`` over q
and k into new tensors, and the call goes on to the forward kernel of its
dtype as a call without a prolog (``qk_prolog.launches`` counts those
launches). It composes with every option above. Its plain version is
:func:`apply_prolog_plain` (counterpart of
``alg_tpu/ops/attention.py:_apply_prolog_xla``) followed by the plain
attention. The kernel rounds the norm's result, the tables, each product of
the rotation and their sum to the activation dtype, as the plain version's
ops in that dtype do, so in bf16 the two give the same q and k but for a
norm result on a rounding tie.

``flash_attention`` itself records no autograd graph; differentiable calls go
through :func:`alg_tpu_torch.ops.attention.attention`.

The plain version mirrors ``alg_tpu/ops/attention.py:_xla_attention``:
fp32 logits times ``scale`` plus ``bias``, keys past the causal diagonal or
at or past ``kv_len`` masked to -inf, an fp32 softmax, probabilities cast to
the value dtype, then ``P·V``. A row with no visible key (``kv_len`` 0, or a
causal row when Sq > Sk) comes out as zeros, as from the kernels on both
machines; ``_xla_attention`` gives NaN there. The bf16 kernels round the
unnormalised P to bf16 before P·V and take the TPU kernel's denominator (at
D = 64 and 80 the sum of the rounded p, at 128 of the fp32 p); the plain
version rounds the normalised probabilities, so in bf16 the two differ by
those roundings and that of the output. The two bf16 kernels differ only in
their key tiles (``KEY_TILE``), against which a ``stable`` call's running
max moves, and at D = 128 in the order of the denominator's fp32 sums.
:func:`attention_plain_residuals` mirrors ``_xla_attention_residuals`` (base-2
logits, explicit max, the LSE beside the output), with ``causal`` and ``bias``
as well.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from alg_tpu_torch.models import layers as L
from alg_tpu_torch.models import rope as R
from alg_tpu_torch.ops import _build
from alg_tpu_torch.ops._autograd import needs_grad
from alg_tpu_torch.utils.profiling import annotate

HEAD_DIMS = (64, 80, 128)  # the variants csrc/flash_attention*.cu and csrc/qk_prolog.cu declare
LOG2E = 1.4426950408889634
NORM_CODE = {None: 0, "layer": 1, "rms": 2}  # the prolog's norm modes (csrc/qk_prolog.cu)


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


def tensor_core_lse_plain(q, k, scale: float, bias: Optional[torch.Tensor] = None,
                          kv_len: Optional[torch.Tensor] = None, causal: bool = False, stable: bool = True,
                          key_tile: int = 64):
    """``(lse, tie)``, fp32 ``[B, H, Sq]``: the base-2 LSE that the bf16
    tensor-core forwards write (``csrc/flash_attention_tc.cu`` with 64-key
    tiles, ``csrc/flash_attention_wgmma.cu`` with 128: ``KEY_TILE``), step by
    step in fp32, and the most that one p on a bf16 rounding tie can move it. The
    denominator is the TPU kernel's: at D = 64 and 80 the sum of the
    bf16-rounded p, taken over ``key_tile``-key tiles against the running
    max when ``stable`` (else against 0), at D = 128 the sum of the fp32 p
    (then the LSE is :func:`attention_plain_residuals`' up to the order of
    the sums, and ``tie`` is 0). The kernel sums its logits in another
    order, so a p on a tie may round the other way, which moves the sum by
    at most 2^-7 of that p: ``tie`` is log2(1 + 2^-7 · max p / sum). A row
    with no visible key gives -inf and 0."""
    rounded = q.shape[-1] % 128 != 0
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (scale * LOG2E)
    if bias is not None:
        s = s + bias.float() * LOG2E
    s, _ = mask_logits(s, kv_len, causal)
    m = torch.full(s.shape[:-1], float("-inf"), device=s.device)
    l = torch.zeros(s.shape[:-1], device=s.device)
    step = key_tile if stable else s.shape[-1]  # without a running max the tiles sum alike
    for k0 in range(0, s.shape[-1], step):
        t = s[..., k0:k0 + step]
        base = torch.zeros_like(m)
        if stable:
            m_new = torch.maximum(m, t.amax(dim=-1))
            base = torch.where(torch.isneginf(m_new), base, m_new)  # no visible key yet: p = exp2(-inf) = 0
            l, m = l * torch.exp2(m - base), m_new
        p = torch.exp2(t - base[..., None])
        l = l + (p.bfloat16().float() if rounded else p).sum(dim=-1)
    base = torch.where(torch.isneginf(m), torch.zeros_like(m), m) if stable else torch.zeros_like(m)
    seen = l > 0
    lse = torch.where(seen, base + torch.log2(l), torch.full_like(l, float("-inf")))
    p_max = torch.exp2(s.amax(dim=-1) - base)
    tie = torch.log2(1.0 + 2.0 ** -7 * p_max / torch.where(seen, l, torch.ones_like(l)))
    return lse, torch.where(seen & rounded, tie, torch.zeros_like(tie))


def tensor_core_attention_plain(q, k, v, scale: float, bias: Optional[torch.Tensor] = None,
                                kv_len: Optional[torch.Tensor] = None, causal: bool = False, stable: bool = True,
                                key_tile: int = 64, rounded_sum: Optional[bool] = None):
    """``(out, lse)``: the bf16 tensor-core forwards' arithmetic
    (``csrc/flash_attention_tc.cu``, ``csrc/flash_attention_wgmma.cu``) step by
    step, over ``key_tile``-key tiles (``KEY_TILE`` of the kernel): fp32
    logits of the inputs times scale·log2e (plus bias·log2e, masked);
    p = exp2(logit − running max) when ``stable`` (the accumulators
    rescaled as the max moves; a max of -inf takes 0), else exp2(logit); P
    rounded to bf16 before an fp32-accumulated P·V, as ``alg_tpu``'s kernel
    does (``p.astype(v.dtype)``); the denominator the sum of the rounded p
    (``rounded_sum``, by default at D = 64 and 80, the TPU kernel's ones
    column) or of the fp32 p. The output in v's dtype (zeros for a row with
    no visible key), the base-2 LSE in fp32 (-inf there). The kernel sums in
    another order, so a p on a bf16 rounding tie may round the other way."""
    if rounded_sum is None:
        rounded_sum = q.shape[-1] % 128 != 0
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (scale * LOG2E)
    if bias is not None:
        s = s + bias.float() * LOG2E
    s, _ = mask_logits(s, kv_len, causal)
    shape = s.shape[:-1] + (1,)
    acc = torch.zeros(s.shape[:-1] + (v.shape[-1],), device=s.device)
    l = torch.zeros(shape, device=s.device)
    m = torch.full(shape, float("-inf"), device=s.device)
    step = key_tile if stable else s.shape[-1]  # without a running max the tiles add alike
    for k0 in range(0, s.shape[-1], step):
        t = s[..., k0:k0 + step]
        base = torch.zeros_like(m)
        if stable:
            m_new = torch.maximum(m, t.amax(dim=-1, keepdim=True))
            base = torch.where(torch.isneginf(m_new), base, m_new)
            alpha = torch.exp2(m - base)
            acc, l, m = acc * alpha, l * alpha, m_new
        p = torch.exp2(t - base)
        p_bf16 = p.bfloat16().float()
        acc = acc + torch.matmul(p_bf16, v[..., k0:k0 + step, :].float())
        l = l + (p_bf16 if rounded_sum else p).sum(dim=-1, keepdim=True)
    seen = l > 0
    out = torch.where(seen, acc / torch.where(seen, l, torch.ones_like(l)), torch.zeros_like(acc))
    base = torch.where(torch.isneginf(m), torch.zeros_like(m), m) if stable else torch.zeros_like(m)
    lse = torch.where(seen, base + torch.log2(l), torch.full_like(l, float("-inf")))
    return out.to(v.dtype), lse[..., 0]


def apply_prolog_plain(q, k, prolog: dict, prolog_k: bool = True):
    """``(q, k)`` through the qk prolog in PyTorch ops: the per-head norm
    ``prolog["norm"]`` (``"layer"``, ``"rms"`` or None; ``eps``, affines
    ``q_scale``/``q_bias``/``k_scale``/``k_bias`` ``[D]``, the biases
    LayerNorm's only; ``eps`` defaults to 1e-6) with fp32 statistics and a cast back, then interleaved
    RoPE with the ``[S, D]`` tables ``cos``/``sin`` (absent: no RoPE) in the
    activation dtype. ``prolog_k=False`` leaves k as it came. Differentiable."""
    mode, eps = prolog.get("norm"), prolog.get("eps", 1e-6)
    if mode not in NORM_CODE:
        raise ValueError(f"unknown prolog norm {mode!r}")

    def transform(x, scale, bias):
        if mode == "layer":
            x = L.layer_norm(x, scale, bias, eps)
        elif mode == "rms":
            x = L.t5_layer_norm(x, scale, eps)
        if prolog.get("cos") is not None:
            n = x.shape[-2]
            x = R.apply_rope_interleaved(x, prolog["cos"][:n], prolog["sin"][:n])
        return x

    q = transform(q, prolog.get("q_scale"), prolog.get("q_bias"))
    return q, (transform(k, prolog.get("k_scale"), prolog.get("k_bias")) if prolog_k else k)


_PTR, _INT = ctypes.c_void_p, ctypes.c_int
# (dtype, q, k, v, bias, bias_b_stride, kv_len, out, lse, batch, heads, sq, sk, scale, stable, causal, stream)
_FWD_ARGTYPES = [_INT] + [_PTR] * 4 + [ctypes.c_longlong] + [_PTR] * 3 + [_INT] * 4 + [ctypes.c_float, _INT, _INT, _PTR]
# (dtype, q, k, q_out, k_out, n_heads, sq, sk, norm, eps, q_scale, q_bias, k_scale, k_bias, cos, sin, prolog_k, stream)
_PROLOG_ARGTYPES = [_INT] + [_PTR] * 4 + [ctypes.c_longlong, _INT, _INT, _INT, ctypes.c_float] + [_PTR] * 6 + [_INT, _PTR]

# the C entry point of each route, "{d}" the head dim
_ENTRY_NAMES = {"wgmma": "alg_flash_attention_wgmma_fwd_d{d}", "tc": "alg_flash_attention_tc_fwd_d{d}",
                "cuda_core": "alg_flash_attention_fwd_d{d}"}
PROLOG_ENTRY_NAME = "alg_qk_prolog_d{d}"  # csrc/qk_prolog.cu
WGMMA_HEAD_DIMS = (64, 128)  # the head dims csrc/flash_attention_wgmma.cu is built for
KEY_TILE = {"wgmma": 128, "tc": 64}  # keys a tile of each bf16 kernel: the steps of a stable call's running max


def kernel_route(dtype: torch.dtype, head_dim: int, has_bias: bool) -> str:
    """The kernel a CUDA call takes, from what it can observe: ``"wgmma"``
    (``csrc/flash_attention_wgmma.cu``) for bf16 at D = 64 or 128 without a
    bias, ``"tc"`` (``csrc/flash_attention_tc.cu``) for the other bf16 calls
    (a bias, D = 80), and ``"cuda_core"`` (``csrc/flash_attention.cu``) for
    fp32. Raises for any other dtype."""
    if dtype not in _build.DTYPE_CODE:
        raise TypeError(f"flash kernel takes float32 or bfloat16, got {dtype}")
    if dtype != torch.bfloat16:
        return "cuda_core"
    return "wgmma" if head_dim in WGMMA_HEAD_DIMS and not has_bias else "tc"


def route(q: torch.Tensor, prolog: bool = False, bias: Optional[torch.Tensor] = None) -> str:
    """Which implementation a call on ``q`` (with ``bias``) takes:
    ``"plain"`` for a CPU tensor, :func:`kernel_route` for a CUDA tensor. A
    qk prolog does not change it: :func:`qk_prolog` runs first, and the
    forward is a call without one. Raises for any other device or dtype."""
    del prolog  # the same route with and without a prolog
    if q.device.type == "cpu":
        return "plain"
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention: no kernel for device {q.device}")
    return kernel_route(q.dtype, q.shape[-1], bias is not None)


@functools.cache
def _entry(head_dim: int, which: str):
    """The C entry point of a head dim for a route of :func:`route`."""
    fn = getattr(_build.load(), _ENTRY_NAMES[which].format(d=head_dim))
    fn.argtypes = _FWD_ARGTYPES
    fn.restype = _INT
    return fn


@functools.cache
def _prolog_entry(head_dim: int):
    """The qk prolog's C entry point of a head dim."""
    fn = getattr(_build.load(), PROLOG_ENTRY_NAME.format(d=head_dim))
    fn.argtypes = _PROLOG_ARGTYPES
    fn.restype = _INT
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


def _check_prolog(q, k, prolog: dict, prolog_k: bool):
    """Raise on q, k or a prolog the kernel does not take; return the prolog's tensors in the entry point's
    order (q_scale, q_bias, k_scale, k_bias, cos, sin; None where not read)."""
    mode = prolog.get("norm")
    if mode not in NORM_CODE:
        raise ValueError(f"unknown prolog norm {mode!r}")
    if q.dtype not in _build.DTYPE_CODE or k.dtype != q.dtype:
        raise TypeError(f"qk prolog takes float32 or bfloat16 q/k of one dtype, got {q.dtype}/{k.dtype}")
    if q.dim() != 4 or q.shape[-1] not in HEAD_DIMS or k.dim() != 4 or k.shape[:2] != q.shape[:2] \
            or k.shape[-1] != q.shape[-1] or q.shape[2] == 0 or k.shape[2] == 0:
        raise ValueError(f"qk prolog takes [B, H, S, D] q and k with D in {HEAD_DIMS}, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}")
    d, sq = q.shape[-1], q.shape[2]
    rope = prolog.get("cos") is not None
    if rope != (prolog.get("sin") is not None):
        raise ValueError("flash prolog: rope_cos and rope_sin come together")
    if mode is None and not rope:
        raise ValueError("qk prolog: a norm, RoPE or both")
    if rope and prolog_k and k.shape[2] != sq:
        raise ValueError("fused RoPE assumes self-attention (Sq == Sk)")
    wanted = []
    for name, needed in (("q_scale", mode is not None), ("q_bias", mode == "layer"),
                         ("k_scale", mode is not None and prolog_k), ("k_bias", mode == "layer" and prolog_k)):
        t = prolog.get(name) if needed else None
        if needed and (t is None or t.dtype != torch.float32 or tuple(t.shape) != (d,)):
            raise ValueError(f"flash prolog {name}: want float32 [{d}], got "
                             f"{None if t is None else (t.dtype, tuple(t.shape))}")
        wanted.append(t)
    for name in ("cos", "sin"):
        t = prolog.get(name)
        if rope and (t.dtype != torch.float32 or t.dim() != 2 or t.shape[0] < sq or t.shape[1] != d):
            raise ValueError(f"flash prolog {name}: want float32 [S >= {sq}, {d}], got {t.dtype} {tuple(t.shape)}")
        wanted.append(t)
    for t in (q, k, *wanted):
        if t is not None and (t.device != q.device or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError("qk prolog operands must be contiguous, 16-byte aligned and on the device of q")
    return wanted


def qk_prolog(q: torch.Tensor, k: torch.Tensor, prolog: dict, prolog_k: bool = True):
    """``(q, k)`` through the qk prolog (``prolog`` as for
    :func:`apply_prolog_plain`), new tensors; ``prolog_k=False`` returns k as
    it came. CPU tensors take :func:`apply_prolog_plain`; CUDA tensors one
    launch of ``csrc/qk_prolog.cu`` over q and k (``qk_prolog.launches``
    counts them), or raise. No autograd graph is recorded (see
    ``ops/attention.py``)."""
    if route(q) == "plain":
        return apply_prolog_plain(q, k, prolog, prolog_k)
    tensors = _check_prolog(q, k, prolog, prolog_k)
    if needs_grad(q, k, *tensors):
        raise RuntimeError("qk_prolog records no autograd graph: call ops.attention.attention, which applies "
                           "the plain, differentiable composition")
    b, h, sq, d = q.shape
    q_out = torch.empty_like(q)
    k_out = torch.empty_like(k) if prolog_k else k
    with torch.cuda.device(q.device):
        rc = _prolog_entry(d)(
            _build.DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), q_out.data_ptr(),
            k_out.data_ptr() if prolog_k else None, b * h, sq, k.shape[2], NORM_CODE[prolog.get("norm")],
            float(prolog.get("eps", 1e-6)), *(None if t is None else t.data_ptr() for t in tensors), int(prolog_k),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(rc, "qk prolog kernel")
    qk_prolog.launches += 1
    return q_out, k_out


qk_prolog.launches = 0  # every launch of the qk prolog kernel


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                    bias: Optional[torch.Tensor] = None, stable: bool = True,
                    kv_len: Optional[torch.Tensor] = None, causal: bool = False,
                    return_residuals: bool = False, qk_norm: Optional[str] = None, norm_eps: float = 1e-6,
                    q_norm_scale: Optional[torch.Tensor] = None, q_norm_bias: Optional[torch.Tensor] = None,
                    k_norm_scale: Optional[torch.Tensor] = None, k_norm_bias: Optional[torch.Tensor] = None,
                    rope_cos: Optional[torch.Tensor] = None, rope_sin: Optional[torch.Tensor] = None,
                    prolog_k: bool = True):
    """``softmax(q·kᵀ·scale + bias)·v`` over ``[B, H, S, D]``, D in 64, 80,
    128; batch row ``b`` attends to its first ``kv_len[b]`` keys only, and
    with ``causal`` query ``i`` to no key past ``i + (Sk - Sq)``. With
    ``return_residuals`` the result is ``(out, lse)``, ``lse`` the fp32
    ``[B, H, Sq]`` base-2 log-sum-exp of the scaled logits.

    ``qk_norm`` (``"layer"`` or ``"rms"``, with ``norm_eps`` and the fp32
    ``[D]`` affines) and ``rope_cos``/``rope_sin`` (fp32 ``[S, D]``,
    self-attention only) are the qk prolog, applied to q and, unless
    ``prolog_k=False``, to k before the attention (see the module docstring).

    ``stable=False`` skips the running max: exact in fp32 while
    |logit·log2e| stays well below 126, which trained DiT attention does.
    CPU tensors take the plain version; CUDA tensors a kernel (see
    :func:`route`), or raise. No autograd graph is recorded here (see
    ``ops/attention.py``)."""
    if qk_norm not in NORM_CODE:
        raise ValueError(f"qk_norm must be 'layer' or 'rms', got {qk_norm!r}")
    if rope_cos is not None and q.shape[2] != k.shape[2]:
        raise ValueError("fused RoPE assumes self-attention (Sq == Sk)")
    prolog = None
    if qk_norm is not None or rope_cos is not None or rope_sin is not None:
        prolog = {"norm": qk_norm, "eps": norm_eps, "q_scale": q_norm_scale, "q_bias": q_norm_bias,
                  "k_scale": k_norm_scale, "k_bias": k_norm_bias, "cos": rope_cos, "sin": rope_sin}
    which = route(q, bias=bias)
    annotate("attention.kernel", route=which)  # the route of the DiT's attention span, when one is open
    if which == "plain":
        if prolog is not None:
            q, k = apply_prolog_plain(q, k, prolog, prolog_k)
        if return_residuals:
            return attention_plain_residuals(q, k, v, scale, bias, kv_len, causal)
        return attention_plain(q, k, v, scale, bias, kv_len, causal)
    _check(q, k, v, bias, kv_len)
    if needs_grad(q, k, v, bias):
        raise RuntimeError("flash_attention records no autograd graph: call ops.attention.attention, which "
                           "differentiates through the backward kernels")
    if prolog is not None:
        q, k = qk_prolog(q, k, prolog, prolog_k)
    b, h, sq, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device) if return_residuals else None
    bias_ptr, bias_b_stride = None, 0
    if bias is not None:
        bias_ptr = bias.data_ptr()
        bias_b_stride = 0 if bias.shape[0] == 1 else h * sq * k.shape[2]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _entry(d, which)(
            _build.DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_ptr, bias_b_stride,
            None if kv_len is None else kv_len.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), b, h, sq, k.shape[2],
            float(scale), int(stable), int(causal), stream,
        )
    _build.check(rc, f"flash-attention kernel ({which})")
    flash_attention.launches += 1
    flash_attention.launches_by_route[which] += 1
    if return_residuals:
        flash_attention.residual_launches += 1
        return out, lse
    return out


flash_attention.launches = 0  # every launch of the forward kernels
flash_attention.launches_by_route = {"wgmma": 0, "tc": 0, "cuda_core": 0}  # the same launches by route()
flash_attention.residual_launches = 0  # those of them that also wrote the LSE
