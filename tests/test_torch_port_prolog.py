"""The flash kernel's qk prolog on the CPU against the JAX package's.

The prolog is a per-head LayerNorm or RMS norm of q and k followed by
interleaved RoPE, applied inside the attention kernel on the card. The JAX
package's Pallas form has no interpret switch, so the JAX side here is what
its own test holds that kernel to: ``_apply_prolog_xla`` followed by
``_xla_attention``. The port side is ``flash_attention`` with the prolog
arguments and ``attention(prolog=...)`` on CPU tensors, which run
``apply_prolog_plain`` and the plain attention. fp32, atol 5e-6, the JAX
test's own bound: the same ops in another order (norms over 64 or 128 values,
softmax sums over 300 keys). Gradients against ``jax.grad`` of the JAX
composition, atol 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from alg_tpu.ops.attention import _apply_prolog_xla, _xla_attention

from alg_tpu_torch.ops import attention as A
from alg_tpu_torch.ops import flash_attention as FA

ATOL = 5e-6
MODES = [("layer", True, False, True), ("rms", True, True, True), (None, True, False, True),
         ("layer", False, False, True), ("layer", True, False, False)]
MODE_IDS = ["layer-rope", "rms-rope-stable", "rope", "layer", "layer-rope-q-only"]


def _inputs(b, h, s, d, seed=0):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(b, h, s, d).astype(np.float32) for _ in range(3))
    cos = np.cos(rng.rand(s, d) * 3).astype(np.float32)
    sin = np.sin(rng.rand(s, d) * 3).astype(np.float32)
    affines = [rng.rand(d).astype(np.float32) for _ in range(4)]
    return q, k, v, cos, sin, affines


def _prolog(mode, has_rope, cos, sin, affines, wrap):
    qs, qb, ks, kb = (wrap(a) for a in affines)
    prolog = {"norm": mode, "eps": 1e-6, "q_scale": qs, "q_bias": qb, "k_scale": ks, "k_bias": kb}
    if has_rope:
        prolog["cos"], prolog["sin"] = wrap(cos), wrap(sin)
    return prolog


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("mode,has_rope,stable,prolog_k", MODES, ids=MODE_IDS)
def test_prolog_matches_the_jax_reference(mode, has_rope, stable, prolog_k, d):
    """The five combinations of ``tests/test_attention_prolog.py`` through
    ``flash_attention``'s own arguments (the JAX names)."""
    q, k, v, cos, sin, affines = _inputs(2, 3, 300, d)
    qr, kr = _apply_prolog_xla(jnp.asarray(q), jnp.asarray(k), _prolog(mode, has_rope, cos, sin, affines, jnp.asarray))
    ref = np.asarray(_xla_attention(qr, kr, jnp.asarray(v), d ** -0.5))
    qs, qb, ks, kb = (torch.from_numpy(a) for a in affines)
    kwargs = dict(qk_norm=mode, norm_eps=1e-6, q_norm_scale=qs if mode else None,
                  q_norm_bias=qb if mode == "layer" else None, rope_cos=torch.from_numpy(cos) if has_rope else None,
                  rope_sin=torch.from_numpy(sin) if has_rope else None, prolog_k=prolog_k)
    if prolog_k:
        kwargs.update(k_norm_scale=ks if mode else None, k_norm_bias=kb if mode == "layer" else None)
    k_in = torch.from_numpy(k if prolog_k else np.asarray(kr))  # the caller brings k transformed
    before = (FA.flash_attention.launches, dict(FA.flash_attention.launches_by_route))
    out = FA.flash_attention(torch.from_numpy(q), k_in, torch.from_numpy(v), d ** -0.5, stable=stable, **kwargs)
    assert (FA.flash_attention.launches, FA.flash_attention.launches_by_route) == before  # CPU: the plain version
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)


def test_apply_prolog_plain_matches_apply_prolog_xla():
    q, k, _, cos, sin, affines = _inputs(2, 2, 70, 128, seed=1)
    for mode in ("layer", "rms", None):
        ref = _apply_prolog_xla(jnp.asarray(q), jnp.asarray(k), _prolog(mode, True, cos, sin, affines, jnp.asarray))
        out = FA.apply_prolog_plain(torch.from_numpy(q), torch.from_numpy(k),
                                    _prolog(mode, True, cos, sin, affines, torch.from_numpy))
        for got, want in zip(out, ref):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    assert A.apply_prolog_plain is FA.apply_prolog_plain


@pytest.mark.parametrize("extra", ["kv_len", "causal", "both", "lse"])
def test_prolog_composes_with_the_masks_and_the_lse(extra):
    """``attention(prolog=...)`` with ``kv_len``, ``causal`` and both, against
    the JAX composition with the same masks; and the LSE output of
    ``flash_attention`` with a prolog against the residual reference on the
    transformed q and k."""
    from alg_tpu.ops.attention import _xla_attention_residuals

    d = 64
    q, k, v, cos, sin, affines = _inputs(2, 2, 90, d, seed=2)
    kv_len = np.asarray([90, 31], np.int32)
    qr, kr = _apply_prolog_xla(jnp.asarray(q), jnp.asarray(k), _prolog("layer", True, cos, sin, affines, jnp.asarray))
    prolog = _prolog("layer", True, cos, sin, affines, torch.from_numpy)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    if extra == "lse":
        ref_o, ref_lse = _xla_attention_residuals(qr, kr, jnp.asarray(v), d ** -0.5, kv_len=jnp.asarray(kv_len))
        out, lse = FA.flash_attention(tq, tk, tv, d ** -0.5, kv_len=torch.from_numpy(kv_len), return_residuals=True,
                                      qk_norm="layer", q_norm_scale=prolog["q_scale"], q_norm_bias=prolog["q_bias"],
                                      k_norm_scale=prolog["k_scale"], k_norm_bias=prolog["k_bias"],
                                      rope_cos=prolog["cos"], rope_sin=prolog["sin"])
        np.testing.assert_allclose(out.numpy(), np.asarray(ref_o), atol=ATOL, rtol=0)
        np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), atol=1e-5, rtol=0)
        return
    causal = extra in ("causal", "both")
    lens = kv_len if extra in ("kv_len", "both") else None
    ref = _xla_attention(qr, kr, jnp.asarray(v), d ** -0.5, causal=causal, kv_len=None if lens is None else jnp.asarray(lens))
    out = A.attention(tq, tk, tv, causal=causal, kv_len=None if lens is None else torch.from_numpy(lens),
                      stable=False, prolog=prolog)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize("mode,d", [("layer", 64), ("rms", 128)], ids=["layer-d64", "rms-d128"])
def test_prolog_gradient_matches_jax_grad(mode, d):
    """A call whose inputs need a gradient applies the prolog as the plain,
    differentiable composition around the attention: gradients for q, k, v and
    the norm affines against ``jax.grad`` of the JAX composition."""
    q, k, v, cos, sin, affines = _inputs(1, 2, 50, d, seed=3)
    w = np.random.RandomState(4).randn(1, 2, 50, d).astype(np.float32)
    kv_len = np.asarray([37], np.int32)

    def jax_loss(q_, k_, v_, qs, ks):
        pro = _prolog(mode, True, cos, sin, [qs, affines[1], ks, affines[3]], jnp.asarray)
        qr, kr = _apply_prolog_xla(q_, k_, pro)
        return jnp.sum(_xla_attention(qr, kr, v_, d ** -0.5, kv_len=jnp.asarray(kv_len)) * w)

    want = jax.grad(jax_loss, argnums=(0, 1, 2, 3, 4))(*(jnp.asarray(a) for a in (q, k, v, affines[0], affines[2])))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, affines[0], affines[2])]
    pro = _prolog(mode, True, cos, sin, affines, torch.from_numpy)
    pro["q_scale"], pro["k_scale"] = leaves[3], leaves[4]
    out = A.attention(*leaves[:3], kv_len=torch.from_numpy(kv_len), stable=False, prolog=pro)
    (out * torch.from_numpy(w)).sum().backward()
    for leaf, ref in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


def test_prolog_arguments_are_checked():
    q, k, v, cos, sin, affines = (torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                                  for a in _inputs(1, 1, 40, 64, seed=5))
    with pytest.raises(ValueError, match="qk_norm"):
        FA.flash_attention(q, k, v, 0.125, qk_norm="group")
    with pytest.raises(ValueError, match="self-attention"):
        FA.flash_attention(q, k[:, :, :20], v[:, :, :20], 0.125, rope_cos=cos, rope_sin=sin)
    with pytest.raises(ValueError, match="unknown keys"):
        A.attention(q, k, v, prolog={"norm": None, "cosine": cos})
    with pytest.raises(ValueError, match="unknown prolog norm"):
        A.attention(q, k, v, prolog={"norm": "group"})
    # a norm alone takes cross-attention: nothing ties the two lengths
    qs = torch.from_numpy(affines[0])
    out = A.attention(q, k[:, :, :20], v[:, :, :20], prolog={"norm": "rms", "eps": 1e-6, "q_scale": qs, "k_scale": qs})
    assert out.shape == q.shape
