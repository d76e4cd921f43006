"""The flash kernel's qk prolog on the CPU against the JAX package's.

The prolog is a per-head LayerNorm or RMS norm of q and k followed by
interleaved RoPE; on the card ``qk_prolog`` applies it in one launch of its
own ahead of the attention kernel. The JAX side here is what its own test
holds that kernel to, ``_apply_prolog_xla`` followed by ``_xla_attention``,
and the transform inside the JAX kernel itself
(``alg_tpu/ops/flash_attention.py:138-155``), run in interpret mode with
the prolog against the same kernel without one on the port's transformed q
and k. The port side is ``flash_attention`` with the prolog arguments,
``qk_prolog`` and ``attention(prolog=...)`` on CPU tensors, which run
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

from test_torch_port_tc import BF16_STEP, interpret_jax_flash

from torch_port_common import one_thread


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


TRANSFORMS = [("layer", True), ("rms", True), (None, True), ("layer", False), ("rms", False)]


@pytest.mark.parametrize("prolog_k", [True, False], ids=["qk", "q-only"])
@pytest.mark.parametrize("mode,has_rope", TRANSFORMS, ids=["layer-rope", "rms-rope", "rope", "layer", "rms"])
@pytest.mark.parametrize("d", [64, 80, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_apply_prolog_plain_matches_the_jax_kernels_transform(dtype, d, mode, has_rope, prolog_k, monkeypatch):
    """``apply_prolog_plain`` against the transform inside ``alg_tpu``'s
    ``_fwd_kernel``: that kernel in interpret mode with the prolog, against
    the same kernel without one on the q and k that ``apply_prolog_plain``
    gives (with ``prolog_k=False`` both take k transformed by the caller).
    Equal transforms give equal outputs. bf16: bit-equal but where a norm
    result lies on a rounding tie (the two sum the statistics in another
    order; a k row on a tie moves every output of its head): at most 1% of
    the outputs differ, by at most one bf16 step of the largest. fp32: atol
    5e-6, the same ops in another order."""
    jax_fwd = interpret_jax_flash(monkeypatch)
    s = 130  # two query and key blocks of 128, the second ragged
    q, k, v, cos, sin, affines = _inputs(1, 2, s, d, seed=d + 2 * has_rope + prolog_k)
    tq, tk, tv = (torch.from_numpy(a).to(dtype) for a in (q, k, v))
    pro = _prolog(mode, has_rope, cos, sin, affines, torch.from_numpy)
    qr, kr = FA.apply_prolog_plain(tq, tk, pro, prolog_k)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32

    def j(t):
        return jnp.asarray(t.float().numpy(), jdt)

    qs, qb, ks, kb = (jnp.asarray(a) for a in affines)
    kwargs = dict(qk_norm=mode, q_norm_scale=qs if mode else None, q_norm_bias=qb if mode == "layer" else None,
                  k_norm_scale=ks if mode and prolog_k else None, k_norm_bias=kb if mode == "layer" and prolog_k else None,
                  rope_cos=jnp.asarray(cos) if has_rope else None, rope_sin=jnp.asarray(sin) if has_rope else None,
                  prolog_k=prolog_k)
    common = dict(scale=d ** -0.5, stable=True, block_q=128, block_k=128)
    fused = jax_fwd(j(tq), j(tk if prolog_k else kr), j(tv), norm_eps=1e-6, **kwargs, **common)
    bare = jax_fwd(j(qr), j(kr), j(tv), **common)
    fused, bare = (np.asarray(a.astype(jnp.float32)) for a in (fused, bare))
    if dtype == torch.float32:
        np.testing.assert_allclose(bare, fused, atol=ATOL, rtol=0)
        return
    differ = fused != bare
    assert differ.mean() <= 0.01, f"{differ.sum()} of {differ.size} outputs differ"
    np.testing.assert_allclose(bare, fused, atol=BF16_STEP * np.abs(fused).max(), rtol=0)


@pytest.mark.parametrize("prolog_k", [True, False], ids=["qk", "q-only"])
def test_qk_prolog_takes_the_plain_version_on_the_cpu(prolog_k):
    """``qk_prolog`` on CPU tensors is ``apply_prolog_plain``, and launches nothing."""
    q, k, _, cos, sin, affines = _inputs(2, 3, 40, 80, seed=6)
    pro = _prolog("layer", True, cos, sin, affines, torch.from_numpy)
    tq, tk = torch.from_numpy(q).bfloat16(), torch.from_numpy(k).bfloat16()
    before = FA.qk_prolog.launches
    got = FA.qk_prolog(tq, tk, pro, prolog_k)
    assert FA.qk_prolog.launches == before
    for g, w in zip(got, FA.apply_prolog_plain(tq, tk, pro, prolog_k)):
        assert torch.equal(g, w)
    assert got[1] is tk or prolog_k


def _prolog_on(dtype=torch.float32, d=64, sq=40, sk=40, mode="layer", rope=True):
    """q, k and a prolog of CPU tensors for ``FA._check_prolog``."""
    q, k = torch.zeros(2, 3, sq, d, dtype=dtype), torch.zeros(2, 3, sk, d, dtype=dtype)
    pro = {"norm": mode, "eps": 1e-6, **{name: torch.ones(d) for name in ("q_scale", "q_bias", "k_scale", "k_bias")}}
    if rope:
        pro["cos"], pro["sin"] = torch.ones(max(sq, sk), d), torch.zeros(max(sq, sk), d)
    return q, k, pro


@pytest.mark.parametrize("change,match", [
    (lambda q, k, p: (q.half(), k.half(), p), "float32 or bfloat16"),
    (lambda q, k, p: (q, k.bfloat16(), p), "one dtype"),
    (lambda q, k, p: (q[..., :32].contiguous(), k[..., :32].contiguous(), p), "D in"),
    (lambda q, k, p: (q, k[:1], p), "D in"),
    (lambda q, k, p: (q, k, {**p, "norm": "group"}), "unknown prolog norm"),
    (lambda q, k, p: (q, k, {**p, "sin": None}), "come together"),
    (lambda q, k, p: (q, k, {**p, "norm": None, "cos": None, "sin": None}), "a norm, RoPE or both"),
    (lambda q, k, p: (q, k[:, :, :20].contiguous(), p), "self-attention"),
    (lambda q, k, p: (q, k, {**p, "k_bias": None}), "k_bias"),
    (lambda q, k, p: (q, k, {**p, "q_scale": torch.ones(32)}), "q_scale"),
    (lambda q, k, p: (q, k, {**p, "cos": p["cos"][:20]}), "cos"),
    (lambda q, k, p: (q, k, {**p, "sin": p["sin"].double()}), "sin"),
    (lambda q, k, p: (q.new_zeros(2, 3, 64, 40).transpose(2, 3), k, p), "contiguous"),
    (lambda q, k, p: (q, k, {**p, "cos": torch.ones(41 * 64 + 1)[1:].view(41, 64)}), "16-byte aligned"),
], ids=["half", "mixed", "d32", "batch", "norm", "half-table", "nothing", "cross-rope", "k-bias", "scale-shape",
        "short-table", "table-dtype", "strided", "misaligned"])
def test_qk_prolog_checks_what_the_kernel_takes(change, match):
    """What ``csrc/qk_prolog.cu`` does not take raises before a launch; a
    norm alone takes q and k of different lengths, and without ``prolog_k``
    the k affines are not read."""
    q, k, pro = change(*_prolog_on())
    with pytest.raises((TypeError, ValueError), match=match):
        FA._check_prolog(q, k, pro, True)


def test_qk_prolog_check_passes_what_the_kernel_takes():
    q, k, pro = _prolog_on(sq=33, sk=70, rope=False)
    assert FA._check_prolog(q, k, pro, True)[4:] == [None, None]
    q, k, pro = _prolog_on(torch.bfloat16, d=80, mode="rms")
    wanted = FA._check_prolog(q, k, {**pro, "k_scale": None, "q_bias": None}, False)
    assert [t is None for t in wanted] == [False, True, True, True, False, False]
