"""The port's attention backward, LSE residuals and differentiable kernel
wrappers on the CPU, against the JAX package.

JAX side, as its own CPU tests run it: ``flash_attention_bwd`` in Pallas
interpret mode (``block_q=128, block_k=128, interpret=True``), ``jax.vjp`` /
``jax.grad`` through ``_xla_attention``, ``_xla_attention_residuals``, and
``qk_norm_rope`` / ``rope_interleaved`` through their XLA compositions (their
backward is XLA on every platform). The port runs its plain versions: the
tensors lie on the CPU. All fp32. Gradients: atol 2e-4 plus rtol 1e-4, the
JAX tests' own bound for the same comparison (other summation orders over at
most 224 keys); LSE: atol 1e-5."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from alg_tpu.ops.attention import _xla_attention, _xla_attention_residuals
from alg_tpu.ops.attention import attention as jax_attention
from alg_tpu.ops.flash_attention_bwd import flash_attention_bwd as jax_flash_attention_bwd
from alg_tpu.ops.qk_prep import qk_norm_rope as jax_qk_norm_rope
from alg_tpu.ops.qk_prep import rope_interleaved as jax_rope_interleaved

from alg_tpu_torch.ops import flash_attention as FA
from alg_tpu_torch.ops.attention import attention
from alg_tpu_torch.ops.flash_attention_bwd import (FlashAttentionFunction, flash_attention_bwd,
                                                   flash_attention_bwd_dkv, flash_attention_bwd_dq,
                                                   flash_attention_bwd_plain)
from alg_tpu_torch.ops.qk_prep import qk_norm_rope
from alg_tpu_torch.ops.rope import rope_interleaved

from torch_port_common import one_thread


GRAD_TOL = dict(atol=2e-4, rtol=1e-4)

# name: (b, h, sq, sk, d, causal, kv_len)
CASES = {
    "dense-ragged": (1, 2, 200, 200, 64, False, None),
    "causal": (1, 2, 150, 150, 64, True, None),
    "causal-sk>sq": (1, 2, 64, 160, 64, True, None),
    "causal-sq>sk": (1, 2, 96, 40, 64, True, None),
    "kv_len": (2, 2, 130, 130, 64, False, [37, 130]),
    "cross": (1, 2, 96, 224, 64, False, None),
    "masked-row": (2, 1, 128, 128, 64, False, [0, 128]),
    "d128-causal-kv_len": (2, 2, 70, 90, 128, True, [90, 33]),
    "d128-dense": (1, 2, 131, 77, 128, False, None),
    "d80-cross-kv_len": (2, 2, 96, 160, 80, False, [160, 57]),
    "d80-causal-sk>sq": (1, 2, 70, 150, 80, True, None),
}


def _inputs(case, seed=0):
    b, h, sq, sk, d, causal, kv_len = CASES[case]
    r = np.random.RandomState(seed)
    q, do = (r.randn(b, h, sq, d).astype(np.float32) for _ in range(2))
    k, v = (r.randn(b, h, sk, d).astype(np.float32) for _ in range(2))
    return q, k, v, do, d ** -0.5, causal, None if kv_len is None else np.asarray(kv_len, np.int32)


def _t(*arrs):
    return [None if a is None else torch.from_numpy(a) for a in arrs]


def _empty_rows(case):
    """Mask [B, Sq] of the query rows that see no key."""
    b, h, sq, sk, d, causal, kv_len = CASES[case]
    keys = np.full((b, sq), sk)
    if kv_len is not None:
        keys = np.minimum(keys, np.asarray(kv_len)[:, None])
    if causal:
        keys = np.minimum(keys, np.arange(sq)[None, :] + sk - sq + 1)
    return keys <= 0


@pytest.mark.parametrize("case", list(CASES))
def test_bwd_plain_matches_jax_interpret_kernels(case):
    q, k, v, do, scale, causal, kv_len = _inputs(case)
    tq, tk, tv, tdo, tlen = _t(q, k, v, do, kv_len)
    o, lse = FA.attention_plain_residuals(tq, tk, tv, scale, None, tlen, causal)
    got = flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo, scale, causal, tlen)
    for a, b in zip(got, flash_attention_bwd(tq, tk, tv, o, lse, tdo, scale, causal, tlen)):
        assert torch.equal(a, b)  # the wrappers take the plain versions on the CPU, and count no launch
    assert flash_attention_bwd_dq.launches == 0 and flash_attention_bwd_dkv.launches == 0
    jlen = None if kv_len is None else jnp.asarray(kv_len)
    ref = jax_flash_attention_bwd(*map(jnp.asarray, (q, k, v, o.numpy(), lse.numpy(), do)), scale=scale,
                                  causal=causal, kv_len=jlen, block_q=128, block_k=128, interpret=True)
    for g, r, name in zip(got, ref, ("dq", "dk", "dv")):
        assert torch.isfinite(g).all(), name
        np.testing.assert_allclose(g.numpy(), np.asarray(r), err_msg=name, **GRAD_TOL)
    empty = _empty_rows(case)
    if empty.any():  # rows with no visible key: dq exactly 0
        assert not got[0].numpy()[np.broadcast_to(empty[:, None, :, None], got[0].shape)].any()
    if kv_len is not None and (kv_len == 0).any():  # a batch row without keys: dk, dv exactly 0
        assert not got[1].numpy()[kv_len == 0].any() and not got[2].numpy()[kv_len == 0].any()


@pytest.mark.parametrize("case", [c for c in CASES if not _empty_rows(c).any()])
def test_bwd_plain_matches_jax_vjp_of_xla_attention(case):
    """``_xla_attention`` gives NaN on a row without keys, so only the cases without one."""
    q, k, v, do, scale, causal, kv_len = _inputs(case, seed=1)
    tq, tk, tv, tdo, tlen = _t(q, k, v, do, kv_len)
    o, lse = FA.attention_plain_residuals(tq, tk, tv, scale, None, tlen, causal)
    got = flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo, scale, causal, tlen)
    jlen = None if kv_len is None else jnp.asarray(kv_len)
    _, vjp = jax.vjp(lambda q_, k_, v_: _xla_attention(q_, k_, v_, scale, causal=causal, kv_len=jlen),
                     *map(jnp.asarray, (q, k, v)))
    for g, r, name in zip(got, vjp(jnp.asarray(do)), ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("case", ["dense-ragged", "kv_len", "cross", "masked-row", "d128-dense"])
def test_lse_matches_jax_residuals(case):
    q, k, v, _, scale, causal, kv_len = _inputs(case, seed=2)
    tq, tk, tv, tlen = _t(q, k, v, kv_len)
    out, lse = FA.flash_attention(tq, tk, tv, scale, kv_len=tlen, return_residuals=True)
    jlen = None if kv_len is None else jnp.asarray(kv_len)
    ro, rlse = _xla_attention_residuals(*map(jnp.asarray, (q, k, v)), scale, kv_len=jlen)
    rlse = np.asarray(rlse)
    assert lse.dtype == torch.float32 and tuple(lse.shape) == q.shape[:3]
    np.testing.assert_array_equal(np.isneginf(lse.numpy()), np.isneginf(rlse))
    fin = np.isfinite(rlse)
    np.testing.assert_allclose(lse.numpy()[fin], rlse[fin], atol=1e-5, rtol=0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ro), atol=1e-5, rtol=0)
    # the same output as a call without residuals, to fp32 rounding of another softmax order
    np.testing.assert_allclose(out.numpy(), FA.flash_attention(tq, tk, tv, scale, kv_len=tlen).numpy(), atol=1e-6)


def _np_lse2(q, k, scale, causal, kv_len):
    """Base-2 row log-sum-exp of the scaled, masked logits in float64 (the
    reference of the JAX package's own residual tests, with the causal mask added)."""
    logits = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), k.astype(np.float64)) * scale
    sq, sk = logits.shape[-2:]
    col = np.arange(sk)
    if kv_len is not None:
        logits = np.where((col[None, :] < kv_len[:, None])[:, None, None, :], logits, -np.inf)
    if causal:
        logits = np.where(col[None, :] <= np.arange(sq)[:, None] + sk - sq, logits, -np.inf)
    mx = logits.max(-1)
    mx_safe = np.where(np.isneginf(mx), 0.0, mx)
    with np.errstate(divide="ignore"):
        return (mx_safe + np.log(np.exp(logits - mx_safe[..., None]).sum(-1))) * np.log2(np.e)


@pytest.mark.parametrize("case", ["dense-ragged", "causal-sk>sq", "causal-sq>sk", "masked-row", "d128-causal-kv_len"])
def test_lse_matches_float64_reference(case):
    """The JAX flash kernel does not lower on the CPU; its residual tests hold
    it to this float64 formula, and so does this one (atol 1e-5)."""
    q, k, v, _, scale, causal, kv_len = _inputs(case, seed=3)
    tq, tk, tv, tlen = _t(q, k, v, kv_len)
    _, lse = FA.attention_plain_residuals(tq, tk, tv, scale, None, tlen, causal)
    ref = _np_lse2(q, k, scale, causal, kv_len)
    np.testing.assert_array_equal(np.isneginf(lse.numpy()), np.isneginf(ref))
    np.testing.assert_array_equal(np.isneginf(ref).any(axis=1), _empty_rows(case))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(lse.numpy()[fin], ref[fin], atol=1e-5, rtol=0)


def test_plain_lse_with_bias_is_the_logsumexp():
    r = np.random.RandomState(4)
    q, k, v = (torch.from_numpy(r.randn(1, 2, 9, 16).astype(np.float32)) for _ in range(3))
    bias = torch.from_numpy(r.randn(1, 2, 9, 9).astype(np.float32))
    out, lse = FA.attention_plain_residuals(q, k, v, 0.25, bias, None, True)
    logits = (q @ k.transpose(-1, -2)) * 0.25 + bias
    logits = logits.masked_fill(torch.ones(9, 9).triu(1).bool(), float("-inf"))
    np.testing.assert_allclose(lse.numpy(), (torch.logsumexp(logits, -1) * FA.LOG2E).numpy(), atol=1e-5)
    np.testing.assert_allclose(out.numpy(), FA.attention_plain(q, k, v, 0.25, bias, None, True).numpy(), atol=1e-6)


def _leaves(*arrs):
    return [None if a is None else torch.from_numpy(a).requires_grad_(a.dtype == np.float32) for a in arrs]


@pytest.mark.parametrize("case", ["dense-ragged", "causal-sk>sq", "kv_len", "cross", "d128-causal-kv_len"])
def test_attention_function_gradients(case):
    """``attention`` on leaves that require a gradient goes through
    ``FlashAttentionFunction`` (plain forward, plain kernel arithmetic in the
    backward): against autograd through ``attention_plain`` (atol 1e-5: two
    formulas for one gradient) and against ``jax.grad`` through the JAX
    package's ``attention``."""
    q, k, v, do, scale, causal, kv_len = _inputs(case, seed=5)
    tq, tk, tv, tlen = _leaves(q, k, v, kv_len)
    out = attention(tq, tk, tv, causal=causal, kv_len=tlen, stable=False)
    assert isinstance(out.grad_fn, FlashAttentionFunction._backward_cls)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    ref_out = FA.attention_plain(tq, tk, tv, scale, None, tlen, causal)
    assert torch.equal(out, ref_out)
    for g, r in zip(got, torch.autograd.grad(ref_out, (tq, tk, tv), torch.from_numpy(do))):
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=1e-5, rtol=1e-5)
    jlen = None if kv_len is None else jnp.asarray(kv_len)
    jref = jax.grad(lambda q_, k_, v_: jnp.sum(jax_attention(q_, k_, v_, causal=causal, kv_len=jlen, impl="xla")
                                               * jnp.asarray(do)), argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    for g, r, name in zip(got, jref, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), err_msg=name, **GRAD_TOL)


def test_attention_function_bias_takes_the_recompute_vjp():
    r = np.random.RandomState(6)
    q, k, v = (r.randn(2, 2, 12, 16).astype(np.float32) for _ in range(3))
    bias, do = r.randn(1, 2, 12, 12).astype(np.float32), r.randn(2, 2, 12, 16).astype(np.float32)
    kv_len = np.asarray([12, 5], np.int32)
    tq, tk, tv, tb, tlen = _leaves(q, k, v, bias, kv_len)
    out = attention(tq, tk, tv, scale=1.0, bias=tb, kv_len=tlen)
    assert isinstance(out.grad_fn, FlashAttentionFunction._backward_cls)
    got = torch.autograd.grad(out, (tq, tk, tv, tb), torch.from_numpy(do))
    jref = jax.grad(lambda q_, k_, v_, b_: jnp.sum(_xla_attention(q_, k_, v_, 1.0, kv_len=jnp.asarray(kv_len), bias=b_)
                                                   * jnp.asarray(do)), argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, (q, k, v, bias)))
    for g, rr, name in zip(got, jref, ("dq", "dk", "dv", "dbias")):
        np.testing.assert_allclose(g.numpy(), np.asarray(rr), err_msg=name, **GRAD_TOL)


def test_attention_without_grad_skips_the_function():
    q, k, v = (torch.randn(1, 2, 5, 16) for _ in range(3))
    assert attention(q, k, v).grad_fn is None
    with torch.no_grad():
        assert attention(q.requires_grad_(), k, v).grad_fn is None
    only_v = attention(q.detach(), k, v.requires_grad_())
    dq_none = torch.autograd.grad(only_v.sum(), (v,))
    assert dq_none[0].shape == v.shape


def _qk_inputs(s, d, seed):
    r = np.random.RandomState(seed)
    x, g = (r.randn(2, 3, s, d).astype(np.float32) for _ in range(2))
    scale, bias = (1.0 + 0.1 * r.randn(d)).astype(np.float32), (0.1 * r.randn(d)).astype(np.float32)
    ang = r.rand(s, d // 2).astype(np.float32) * 6.28
    ang[:4] = 0.0
    return x, scale, bias, np.repeat(np.cos(ang), 2, axis=1), np.repeat(np.sin(ang), 2, axis=1), g


def test_qk_norm_rope_gradients_match_jax():
    x, scale, bias, cos, sin, g = _qk_inputs(40, 64, 7)
    tx, ts, tb = _leaves(x, scale, bias)
    out = qk_norm_rope(tx, ts, tb, torch.from_numpy(cos), torch.from_numpy(sin), 1e-6)
    got = torch.autograd.grad(out, (tx, ts, tb), torch.from_numpy(g))
    ref = jax.grad(lambda x_, s_, b_: jnp.sum(jax_qk_norm_rope(x_, {"scale": s_, "bias": b_}, jnp.asarray(cos),
                                                               jnp.asarray(sin), 1e-6, force="xla") * jnp.asarray(g)),
                   argnums=(0, 1, 2))(*map(jnp.asarray, (x, scale, bias)))
    for a, r, name in zip(got, ref, ("dx", "dscale", "dbias")):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=1e-4, rtol=1e-4, err_msg=name)


def test_rope_gradients_match_jax():
    x, _, _, cos, sin, g = _qk_inputs(33, 128, 8)
    tx, = _leaves(x)
    out = rope_interleaved(tx, torch.from_numpy(cos), torch.from_numpy(sin))
    got, = torch.autograd.grad(out, (tx,), torch.from_numpy(g))
    ref = jax.grad(lambda x_: jnp.sum(jax_rope_interleaved(x_, jnp.asarray(cos), jnp.asarray(sin), force="xla")
                                      * jnp.asarray(g)))(jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
