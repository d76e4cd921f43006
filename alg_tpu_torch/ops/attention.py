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

Under a device mesh (:func:`set_attention_mesh`, :func:`attention_mesh_scope`;
``alg_tpu/ops/attention.py:184-403``) q, k and v arrive as this rank's batch
rows (dp) and heads (tp), as the DiTs' column-parallel projections make
them, and replicated over sp. A call without a bias then takes the mesh
route before anything else: the prolog applied up front (the qk prolog
kernel on the card, the plain composition on the CPU or under a gradient),
never the int8 route, and with an sp axis the query tokens split over sp,
each rank's slab attended in one of three ways (``seq_mode``):

* ``"gather"``: keys and values all-gathered over sp, one kernel call;
* ``"ring"``: the key/value chunks rotate around the sp ring
  (``batch_isend_irecv``, the next chunk posted before the current chunk's
  kernel), one forward kernel call a chunk with its base-2 LSE, the partial
  outputs merged by :func:`_ring_merge`; forward only, as in ``alg_tpu``;
* ``"ulysses"``: one ``all_to_all`` trades the sequence split for a head
  split on q, k and v, one full-sequence kernel call over ``heads / sp``
  heads, and one more ``all_to_all`` on the output.

The rank's output slab is all-gathered back over sp. Cross-attention
(Sq != Sk) splits only the queries. Causal attention under sp raises; a
query length that sp does not divide, or (Ulysses) a local head count that
sp does not divide, runs that call as ``alg_tpu`` does, sequence-replicated
or gathered, with a warning.
"""

from __future__ import annotations

import contextlib
import warnings
from typing import Optional

import torch

from alg_tpu_torch.ops._autograd import needs_grad
from alg_tpu_torch.ops.flash_attention import apply_prolog_plain, flash_attention, qk_prolog
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


_MESH_CTX = None  # (mesh, seq_axis, seq_mode)
SEQ_MODES = ("gather", "ring", "ulysses")


def set_attention_mesh(mesh, seq_axis: Optional[str] = None, seq_mode: str = "gather") -> None:
    """Route the attention calls that follow over ``mesh`` (None clears it);
    ``seq_axis`` names the mesh axis that splits the query tokens (``"sp"``)
    and ``seq_mode`` how keys and values are shared along it (the module
    docstring)."""
    global _MESH_CTX
    if seq_mode not in SEQ_MODES:
        raise ValueError(f"seq_mode {seq_mode!r} (want one of {SEQ_MODES})")
    _MESH_CTX = None if mesh is None else (mesh, seq_axis, seq_mode)


def get_attention_mesh():
    return _MESH_CTX


@contextlib.contextmanager
def attention_mesh_scope(mesh, seq_axis: Optional[str] = None, seq_mode: str = "gather"):
    """:func:`set_attention_mesh` for the duration of the block (the
    pipelines wrap their DiT calls, so the text and image encoders keep the
    single-device route)."""
    global _MESH_CTX
    prev = _MESH_CTX
    set_attention_mesh(mesh, seq_axis, seq_mode)
    try:
        yield
    finally:
        _MESH_CTX = prev


def pipeline_mesh_scope(pipeline):
    """The scope of a pipeline's DiT call: its ``attn_mesh`` with
    ``sp_mode`` on the ``"sp"`` axis, or nothing without a mesh."""
    if pipeline.attn_mesh is None:
        return contextlib.nullcontext()
    return attention_mesh_scope(pipeline.attn_mesh, seq_axis="sp", seq_mode=pipeline.sp_mode)


def _ring_merge(o_a, lse_a, o_b, lse_b):
    """Merge two normalised partial outputs (fp32) by their base-2 LSEs; a
    row that no chunk has seen yet (LSE -inf on both sides) stays zeros and
    -inf, without NaNs."""
    m = torch.maximum(lse_a, lse_b)
    m_safe = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    w_a, w_b = torch.exp2(lse_a - m_safe), torch.exp2(lse_b - m_safe)
    den = w_a + w_b
    den_safe = torch.where(den == 0.0, torch.ones_like(den), den)
    o = (o_a * w_a[..., None] + o_b * w_b[..., None]) / den_safe[..., None]
    return o, m_safe + torch.log2(den)  # log2(0) = -inf keeps an unseen row unseen


def _ring_attention_local(q, k, v, kv_len, *, scale: float, stable: bool, sp: int, index: int, rotate,
                          chunk_attention=None):
    """One rank's ring attention: ``sp`` rounds, each attending the local
    queries to the key/value chunk held (``chunk_attention(q, k, v, kv_len)
    -> (out, lse)``, by default the flash forward with its LSE) and merging
    by LSE. ``rotate(round, k, v)`` posts the exchange of the held chunk and
    returns a function that waits for the next one; it is called before the
    round's kernel so the transfer overlaps it. ``index`` is this rank's
    place on the ring: the chunk held in round ``r`` came from rank
    ``index - r``, and ``kv_len`` moves into its coordinates as
    ``clip(kv_len - src·chunk, 0, chunk)``."""
    if chunk_attention is None:
        def chunk_attention(q_, k_, v_, kvl):
            return flash_attention(q_, k_, v_, scale, stable=stable, kv_len=kvl, return_residuals=True)
    chunk = k.shape[2]
    o = lse = None
    q, k_cur, v_cur = q.contiguous(), k.contiguous(), v.contiguous()
    for r in range(sp):
        wait = rotate(r, k_cur, v_cur) if r < sp - 1 else None
        src = (index - r) % sp
        kvl = None if kv_len is None else torch.clamp(kv_len - src * chunk, 0, chunk).to(torch.int32)
        o_r, lse_r = chunk_attention(q, k_cur, v_cur, kvl)
        o_r = o_r.float()
        o, lse = (o_r, lse_r) if o is None else _ring_merge(o, lse, o_r, lse_r)
        if wait is not None:
            k_cur, v_cur = (t.contiguous() for t in wait())
    return o.to(q.dtype)


def _ring_rotation(mesh, axis: str):
    """``rotate`` for :func:`_ring_attention_local` over the mesh's ``axis``
    ring: send the held chunk to the next rank, receive the previous one's."""
    import torch.distributed as dist

    ranks, i = mesh.group_ranks(axis), mesh.local_rank(axis)
    nxt, prv, group = ranks[(i + 1) % len(ranks)], ranks[(i - 1) % len(ranks)], mesh.group(axis)

    def rotate(r, k, v):
        bufs = (torch.empty_like(k), torch.empty_like(v))
        ops = [dist.P2POp(dist.isend, k, nxt, group), dist.P2POp(dist.isend, v, nxt, group),
               dist.P2POp(dist.irecv, bufs[0], prv, group), dist.P2POp(dist.irecv, bufs[1], prv, group)]
        reqs = dist.batch_isend_irecv(ops)

        def wait():
            for req in reqs:
                req.wait()
            return bufs

        return wait

    return rotate


def _local_attention(q, k, v, scale, causal, kv_len, stable):
    if needs_grad(q, k, v):
        return FlashAttentionFunction.apply(q, k, v, kv_len, None, scale, causal, stable)
    return flash_attention(q, k, v, scale, stable=stable, kv_len=kv_len, causal=causal)


def _mesh_attention(q, k, v, scale, causal, kv_len, stable):
    from alg_tpu_torch.sharding import collectives as C

    mesh, seq_axis, seq_mode = _MESH_CTX
    sp = mesh.size(seq_axis) if seq_axis is not None else 1
    sq, cross = q.shape[2], q.shape[2] != k.shape[2]
    if sp > 1:
        if causal:
            raise NotImplementedError("sequence-parallel attention is non-causal only (DiT self/joint attention)")
        if sq % sp:
            warnings.warn(f"attention seq {sq} not divisible by sp={sp}; running this call sequence-replicated")
            sp = 1
    if sp == 1:
        return _local_attention(q, k, v, scale, causal, kv_len, stable)
    mode = "cross" if cross else seq_mode
    if mode == "ulysses" and q.shape[1] % sp:
        warnings.warn(f"ulysses sp needs (heads/tp) % sp == 0; got {q.shape[1]} local heads over sp={sp} — "
                      "falling back to gathered-KV sequence parallelism")
        mode = "gather"
    group = mesh.group(seq_axis)
    q_loc = C.split(q, 2, group)
    if mode == "cross":  # keys and values stay whole: exact with no exchange
        o = _local_attention(q_loc, k, v, scale, False, kv_len, stable)
    elif mode == "ring":
        if needs_grad(q, k, v):
            raise NotImplementedError("ring attention is forward only (as in alg_tpu); use seq_mode 'gather' "
                                      "or 'ulysses' under a gradient")
        o = _ring_attention_local(q_loc, C.split(k, 2, group), C.split(v, 2, group), kv_len, scale=scale,
                                  stable=stable, sp=sp, index=mesh.local_rank(seq_axis),
                                  rotate=_ring_rotation(mesh, seq_axis))
    elif mode == "ulysses":
        qh, kh, vh = (C.all_to_all(C.split(t, 2, group), 1, 2, group) for t in (q, k, v))
        o = C.all_to_all(_local_attention(qh, kh, vh, scale, False, kv_len, stable), 2, 1, group)
    else:
        k_all = C.gather_summed(C.split(k, 2, group), 2, group)
        v_all = C.gather_summed(C.split(v, 2, group), 2, group)
        o = _local_attention(q_loc, k_all, v_all, scale, False, kv_len, stable)
    return C.gather(o.contiguous(), 2, group)


_PROLOG_KEYS = ("norm", "eps", "q_scale", "q_bias", "k_scale", "k_bias", "cos", "sin")


def _check_prolog_keys(prolog: dict) -> None:
    unknown = set(prolog) - set(_PROLOG_KEYS)
    if unknown:
        raise ValueError(f"attention prolog: unknown keys {sorted(unknown)} (want {_PROLOG_KEYS})")


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
    if _MESH_CTX is not None and bias is None:
        if prolog is not None:
            _check_prolog_keys(prolog)
            tensors = [prolog.get(name) for name in _PROLOG_KEYS[2:]]
            if q.device.type == "cpu" or needs_grad(q, k, v, *tensors):
                q, k = apply_prolog_plain(q, k, prolog)
            else:
                q, k = qk_prolog(q, k, prolog)
        return _mesh_attention(q, k, v, scale, causal, kv_len, stable)
    if (_INT8_QK and not stable and not causal and bias is None and prolog is None
            and q.shape[2] == k.shape[2]):
        return flash_attention_int8(q, k, v, scale, pv_int8=_INT8_QK == "full", kv_len=kv_len)
    fused = {}
    if prolog is not None:
        _check_prolog_keys(prolog)
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
