"""The port's kernel modules on the CPU: the plain versions against the JAX
package's kernels and references, and the wrappers' refusal of what the
CUDA kernels do not take.

JAX side, as its own CPU tests run it: ``qk_norm_rope`` in Pallas interpret
mode (``force="pallas", interpret=True``) and as the XLA composition
(``force="xla"``); attention through ``_xla_attention`` (the Pallas flash
kernel does not lower on the CPU); ``rope_interleaved`` in Pallas interpret
mode and as ``apply_rope_interleaved``. All fp32, atol 1e-5: the same ops in
another order (64-wide norms, softmax sums over at most 300 keys)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from alg_tpu.models import layers as JL
from alg_tpu.ops.attention import _xla_attention, _xla_attention_residuals
from alg_tpu.ops.attention import attention as jax_attention
from alg_tpu.models import rope as JR
from alg_tpu.ops.qk_prep import qk_norm_rope as jax_qk_norm_rope
from alg_tpu.ops.qk_prep import rope_interleaved as jax_rope_interleaved

from alg_tpu_torch.models import layers as L
from alg_tpu_torch.ops import _build
from alg_tpu_torch.ops import flash_attention as FA
from alg_tpu_torch.ops.attention import attention
from alg_tpu_torch.ops.qk_prep import qk_norm_rope
from alg_tpu_torch.ops.rope import rope_interleaved

from torch_port_common import one_thread


ATOL = 1e-5


def _qk_inputs(s, d=64, b=2, h=3, seed=0, identity_rows=0):
    r = np.random.RandomState(seed)
    x = r.randn(b, h, s, d).astype(np.float32)
    scale = (1.0 + 0.1 * r.randn(d)).astype(np.float32)
    bias = (0.1 * r.randn(d)).astype(np.float32)
    ang = r.rand(s, d // 2).astype(np.float32) * 6.28
    ang[:identity_rows] = 0.0
    cos, sin = np.repeat(np.cos(ang), 2, axis=1), np.repeat(np.sin(ang), 2, axis=1)
    return x, scale, bias, cos, sin


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("s,force", [(256, "pallas"), (300, "xla"), (4276, "xla")],
                         ids=["pallas-interpret", "xla-s300", "xla-s4276"])
def test_qk_prep_matches_jax(s, force):
    x, scale, bias, cos, sin = _qk_inputs(s, b=1 if s > 300 else 2)
    ref = jax_qk_norm_rope(jnp.asarray(x), {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                           jnp.asarray(cos), jnp.asarray(sin), 1e-6, force=force,
                           interpret=force == "pallas")
    out = qk_norm_rope(*_t(x, scale, bias, cos, sin), 1e-6)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_qk_prep_identity_rows_equal_layer_norm():
    """cos=1, sin=0 rows (the DiT's text prefix) come out bit-equal to the
    LayerNorm output, and match the JAX LayerNorm."""
    x, scale, bias, cos, sin = _qk_inputs(100, identity_rows=40)
    out = qk_norm_rope(*_t(x, scale, bias, cos, sin), 1e-6)
    ln = L.layer_norm(torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias), 1e-6)
    assert torch.equal(out[:, :, :40], ln[:, :, :40])
    jax_ln = JL.layer_norm({"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}, jnp.asarray(x), 1e-6)
    np.testing.assert_allclose(out[:, :, :40].numpy(), np.asarray(jax_ln)[:, :, :40], atol=ATOL, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_qk_prep_takes_the_head_split_view(dtype):
    """The CogVideoX DiT passes the [B, S, H, D] projection viewed as
    [B, H, S, D]: the result equals the call on the contiguous copy, and
    ``alg_tpu``'s ``qk_norm_rope`` (its XLA composition, the one its CPU
    path takes) on the same values, to atol 1e-5 in fp32 and to one bf16
    step of the output's largest magnitude in bf16 (the same ops in another
    order of rounding)."""
    x, scale, bias, cos, sin = _qk_inputs(77, identity_rows=10)
    X = torch.from_numpy(x).to(dtype)
    view = X.transpose(1, 2).contiguous().transpose(1, 2)  # [B, H, S, D] over a [B, S, H, D] tensor
    assert not view.is_contiguous() and view.stride(3) == 1
    out = qk_norm_rope(view, *_t(scale, bias, cos, sin), 1e-6)
    assert torch.equal(out, qk_norm_rope(X, *_t(scale, bias, cos, sin), 1e-6))
    ref = jax_qk_norm_rope(jnp.asarray(X.float().numpy(), jnp.float32 if dtype == torch.float32 else jnp.bfloat16),
                           {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}, jnp.asarray(cos),
                           jnp.asarray(sin), 1e-6, force="xla")
    ref = np.asarray(ref.astype(jnp.float32))
    atol = ATOL if dtype == torch.float32 else 2.0 ** -7 * float(np.abs(ref).max())
    np.testing.assert_allclose(out.float().numpy(), ref, atol=atol, rtol=0)


@pytest.mark.parametrize("bad", ["strided_last_dim", "misaligned_row", "head_dim_128", "float16", "table_shape"])
def test_qk_prep_wrapper_rejects_what_the_kernel_does_not_take(bad):
    from alg_tpu_torch.ops import qk_prep as QP

    x, ones, zeros, tab = torch.zeros(2, 3, 16, 64), torch.ones(64), torch.zeros(64), torch.ones(16, 64)
    QP._check(x, ones, zeros, tab, tab)
    QP._check(torch.zeros(2, 16, 3, 64).transpose(1, 2), ones, zeros, tab, tab)  # the head-split view as it is
    if bad == "strided_last_dim":
        x = torch.zeros(2, 3, 16, 128)[..., ::2]
    elif bad == "misaligned_row":  # 8 bytes past an allocation's start: no row on a 16-byte boundary
        x = torch.zeros(2 * 3 * 16 * 64 + 2)[2:].view(2, 3, 16, 64)
    elif bad == "head_dim_128":
        x, ones, zeros, tab = torch.zeros(2, 3, 16, 128), torch.ones(128), torch.zeros(128), torch.ones(16, 128)
    elif bad == "float16":
        x = x.half()
    elif bad == "table_shape":
        tab = torch.ones(15, 64)
    with pytest.raises((TypeError, ValueError)):
        QP._check(x, ones, zeros, tab, tab)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s,force", [(256, "pallas"), (300, "xla"), (1, "xla")],
                         ids=["pallas-interpret", "xla-s300", "xla-s1"])
def test_rope_interleaved_matches_jax(s, force, d):
    """Against the Pallas kernel in interpret mode (S = 256: Mosaic's block
    rule, not the function's) and against ``apply_rope_interleaved``."""
    x, _, _, cos, sin = _qk_inputs(s, d=d)
    ref = jax_rope_interleaved(jnp.asarray(x), jnp.asarray(cos), jnp.asarray(sin), force=force,
                               interpret=force == "pallas")
    out = rope_interleaved(*_t(x, cos, sin))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    np.testing.assert_allclose(out.numpy(), np.asarray(JR.apply_rope_interleaved(jnp.asarray(x), cos, sin)),
                               atol=ATOL, rtol=0)


def test_rope_interleaved_takes_the_transposed_view():
    """The models pass the [B, S, H, D] projection viewed as [B, H, S, D]."""
    x, _, _, cos, sin = _qk_inputs(50, d=128)
    X, C, S = _t(x, cos, sin)
    view = X.transpose(1, 2).contiguous().transpose(1, 2)
    assert not view.is_contiguous()
    assert torch.equal(rope_interleaved(view, C, S), rope_interleaved(X, C, S))


def _attn_inputs(b, h, sq, sk, d, seed, with_bias):
    r = np.random.RandomState(seed)
    q, k, v = r.randn(b, h, sq, d), r.randn(b, h, sk, d), r.randn(b, h, sk, d)
    bias = r.randn(1, h, sq, sk) * 2.0 if with_bias else None
    return [a.astype(np.float32) if a is not None else None for a in (q, k, v, bias)]


@pytest.mark.parametrize("case", [
    dict(b=2, h=3, sq=300, sk=300, d=64, scale=64 ** -0.5, stable=False, with_bias=False),
    dict(b=2, h=3, sq=300, sk=300, d=64, scale=64 ** -0.5, stable=True, with_bias=False),
    dict(b=2, h=4, sq=70, sk=70, d=64, scale=1.0, stable=True, with_bias=True),  # T5: bias, scale 1
    dict(b=1, h=2, sq=45, sk=130, d=16, scale=None, stable=True, with_bias=False),  # Sq != Sk, default scale
], ids=["dit-unstable", "dit-stable", "t5-bias", "cross-small-d"])
def test_attention_plain_matches_xla_attention(case):
    q, k, v, bias = _attn_inputs(case["b"], case["h"], case["sq"], case["sk"], case["d"], 3, case["with_bias"])
    scale = case["scale"] if case["scale"] is not None else case["d"] ** -0.5
    ref = _xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale,
                         bias=None if bias is None else jnp.asarray(bias))
    out = attention(*_t(q, k, v), scale=case["scale"], stable=case["stable"],
                    bias=None if bias is None else torch.from_numpy(bias))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize("case", [
    dict(d=12, sq=40, sk=40, stable=True, with_bias=False, kv_len=[40, 13, 1]),
    dict(d=80, sq=33, sk=57, stable=True, with_bias=False, kv_len=[57, 20, 3]),
    dict(d=128, sq=40, sk=40, stable=False, with_bias=False, kv_len=[7, 40, 39]),
    dict(d=64, sq=70, sk=70, stable=True, with_bias=True, kv_len=[70, 17, 1]),  # UMT5: bias + prompt lengths
    dict(d=64, sq=70, sk=70, stable=False, with_bias=True, kv_len=[64, 65, 16]),
    dict(d=80, sq=20, sk=30, stable=False, with_bias=True, kv_len=[30, 30, 30]),
], ids=["d12", "d80-cross", "d128-unstable", "d64-bias-stable", "d64-bias-unstable", "d80-bias-full-len"])
def test_attention_kv_len_matches_xla_attention(case):
    """Keys at or past ``kv_len[b]`` add nothing, with and without a bias,
    ``stable`` both ways (the plain version has one path for both)."""
    d, sq, sk = case["d"], case["sq"], case["sk"]
    q, k, v, bias = _attn_inputs(3, 2, sq, sk, d, 5, case["with_bias"])
    scale = 1.0 / 8 if case["with_bias"] else d ** -0.5
    kv_len = np.asarray(case["kv_len"], np.int32)
    ref = _xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale, kv_len=jnp.asarray(kv_len),
                         bias=None if bias is None else jnp.asarray(bias))
    out = attention(*_t(q, k, v), scale=scale, stable=case["stable"], kv_len=torch.from_numpy(kv_len),
                    bias=None if bias is None else torch.from_numpy(bias))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    # the first kv_len keys alone give the same rows
    for i, n in enumerate(case["kv_len"]):
        alone = attention(*_t(q[i:i + 1], k[i:i + 1, :, :n], v[i:i + 1, :, :n]), scale=scale,
                          bias=None if bias is None else torch.from_numpy(bias[:, :, :, :n]))
        np.testing.assert_allclose(out[i:i + 1].numpy(), alone.numpy(), atol=ATOL, rtol=0)


@pytest.mark.parametrize("with_bias", [False, True], ids=["no-bias", "bias"])
def test_attention_kv_len_zero_gives_a_zero_row(with_bias):
    """A batch row with no key left comes out as zeros (as from the flash
    kernels; the XLA reference divides 0 by 0 there); the other rows match
    the reference."""
    q, k, v, bias = _attn_inputs(3, 2, 9, 11, 12, 6, with_bias)
    kv_len = np.asarray([5, 0, 11], np.int32)
    out = attention(*_t(q, k, v), kv_len=torch.from_numpy(kv_len),
                    bias=None if bias is None else torch.from_numpy(bias))
    assert bool(torch.isfinite(out).all()) and not out[1].any()
    ref = _xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 12 ** -0.5, kv_len=jnp.asarray(kv_len),
                         bias=None if bias is None else jnp.asarray(bias))
    np.testing.assert_allclose(out[[0, 2]].numpy(), np.asarray(ref)[[0, 2]], atol=ATOL, rtol=0)


@pytest.mark.parametrize("d", [12, 80, 128])
def test_attention_head_dims_match_xla_attention(d):
    q, k, v, _ = _attn_inputs(2, 3, 50, 37, d, 7, False)
    ref = _xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), d ** -0.5)
    for stable in (True, False):
        out = attention(*_t(q, k, v), stable=stable)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize("case", [
    dict(d=12, sq=40, sk=40, stable=True, with_bias=False, kv_len=None),
    dict(d=64, sq=77, sk=77, stable=True, with_bias=False, kv_len=None),  # CLIP text
    dict(d=128, sq=50, sk=50, stable=True, with_bias=False, kv_len=[50, 31, 1]),  # Llama: causal + prompt lengths
    dict(d=128, sq=50, sk=50, stable=False, with_bias=False, kv_len=[50, 31, 1]),
    dict(d=64, sq=33, sk=57, stable=True, with_bias=False, kv_len=None),  # Sq < Sk: the offset Sk - Sq
    dict(d=12, sq=33, sk=57, stable=False, with_bias=False, kv_len=[57, 30, 25]),
    dict(d=64, sq=70, sk=70, stable=True, with_bias=True, kv_len=None),
    dict(d=128, sq=20, sk=30, stable=False, with_bias=True, kv_len=[30, 11, 12]),
], ids=["d12", "d64-clip-text", "d128-kvlen-stable", "d128-kvlen-unstable", "d64-offset", "d12-offset-kvlen",
        "d64-bias", "d128-offset-bias-kvlen"])
def test_attention_causal_matches_xla_attention(case):
    """Query i sees key j iff j <= i + (Sk - Sq); the mask composes with
    ``kv_len``, a bias and both ``stable`` settings. Every row sees a key."""
    d, sq, sk = case["d"], case["sq"], case["sk"]
    q, k, v, bias = _attn_inputs(3, 2, sq, sk, d, 8, case["with_bias"])
    scale = 1.0 / 8 if case["with_bias"] else d ** -0.5
    kv_len = None if case["kv_len"] is None else np.asarray(case["kv_len"], np.int32)
    ref = _xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale, causal=True,
                         kv_len=None if kv_len is None else jnp.asarray(kv_len),
                         bias=None if bias is None else jnp.asarray(bias))
    out = attention(*_t(q, k, v), scale=scale, causal=True, stable=case["stable"],
                    kv_len=None if kv_len is None else torch.from_numpy(kv_len),
                    bias=None if bias is None else torch.from_numpy(bias))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    # row i alone, over the keys it sees, gives the same row
    for i in (0, sq // 2, sq - 1):
        n = min(i + sk - sq + 1, sk if kv_len is None else int(kv_len[1]))
        alone = attention(*_t(q[1:2, :, i:i + 1], k[1:2, :, :n], v[1:2, :, :n]), scale=scale,
                          bias=None if bias is None else torch.from_numpy(bias[:, :, i:i + 1, :n]))
        np.testing.assert_allclose(out[1:2, :, i:i + 1].numpy(), alone.numpy(), atol=ATOL, rtol=0)


@pytest.mark.parametrize("h,s,d,causal", [(2, 257, 80, False), (2, 77, 64, True)],
                         ids=["clip-vit-h-257x80", "clip-text-causal-77x64"])
def test_clip_calls_match_jax_attention(h, s, d, causal):
    """The two fp32 calls of the shipped paths' CLIP towers (ViT-H's 257
    tokens at D = 80, stable; CLIP text's 77 causal tokens at D = 64, stable)
    at narrow width: the port's ``attention`` and ``flash_attention`` (the
    plain version, on the CPU) against ``alg_tpu``'s ``attention`` as it runs
    on the CPU (its flash kernel has no interpret mode; its front door takes
    XLA there), and the LSE against ``_xla_attention_residuals``."""
    q, k, v, _ = _attn_inputs(1, h, s, s, d, 11, False)
    scale = d ** -0.5
    ref = np.asarray(jax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=scale, causal=causal,
                                   stable=True))
    out = attention(*_t(q, k, v), scale=scale, causal=causal, stable=True)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)
    flash, lse = FA.flash_attention(*_t(q, k, v), scale, stable=True, causal=causal, return_residuals=True)
    np.testing.assert_allclose(flash.numpy(), ref, atol=ATOL, rtol=0)
    assert bool(torch.isfinite(lse).all())
    if not causal:
        _, ref_lse = _xla_attention_residuals(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale)
        np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), atol=ATOL, rtol=0)


@pytest.mark.parametrize("stable", [True, False], ids=["stable", "unstable"])
def test_attention_causal_rows_without_a_visible_key_are_zero(stable):
    """Sq > Sk hides every key from the first Sq - Sk rows, and ``kv_len`` 0
    from a whole batch row. On such rows the port follows the Pallas body
    (``alg_tpu/ops/flash_attention.py``: a zero denominator writes zeros), not
    ``_xla_attention``, whose softmax over all -inf is NaN there. The other
    rows are held to ``_xla_attention``."""
    sq, sk, d = 40, 25, 64
    q, k, v, _ = _attn_inputs(3, 2, sq, sk, d, 9, False)
    kv_len = np.asarray([25, 0, 7], np.int32)
    ref = np.asarray(_xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), d ** -0.5, causal=True,
                                    kv_len=jnp.asarray(kv_len)))
    out = attention(*_t(q, k, v), causal=True, stable=stable, kv_len=torch.from_numpy(kv_len)).numpy()
    hidden = np.zeros((3, sq), bool)
    hidden[:, : sq - sk] = True  # rows above the diagonal's start
    hidden[1] = True  # no key at all
    assert np.isfinite(out).all() and np.isnan(ref[hidden[:, None].repeat(2, 1)]).all()
    assert not out[hidden[:, None].repeat(2, 1)].any()
    seen = ~hidden[:, None].repeat(2, 1)
    np.testing.assert_allclose(out[seen], ref[seen], atol=ATOL, rtol=0)


def test_cpu_calls_launch_nothing():
    FA.flash_attention.launches = 0
    from alg_tpu_torch.ops import qk_prep

    qk_prep.qk_norm_rope.launches = 0
    x, scale, bias, cos, sin = _qk_inputs(8)
    qk_norm_rope(*_t(x, scale, bias, cos, sin), 1e-6)
    q = torch.zeros(1, 1, 8, 64)
    FA.flash_attention(q, q, q, 0.125)
    rope_interleaved.launches = 0
    rope_interleaved(*_t(x, cos, sin))
    assert FA.flash_attention.launches == 0 and qk_prep.qk_norm_rope.launches == 0
    assert rope_interleaved.launches == 0


@pytest.mark.parametrize("which", ["flash", "qk_prep", "rope"])
def test_non_cpu_tensor_raises_instead_of_falling_back(which):
    """A tensor that is not on the CPU never takes the plain version: on a
    machine without CUDA the wrapper raises (here: a 'meta' tensor)."""
    meta = torch.empty(1, 2, 8, 64, device="meta")
    with pytest.raises(RuntimeError, match="no kernel for device"):
        if which == "flash":
            FA.flash_attention(meta, meta, meta, 0.125)
        elif which == "rope":
            rope_interleaved(meta, torch.ones(8, 64, device="meta"), torch.zeros(8, 64, device="meta"))
        else:
            qk_norm_rope(meta, torch.ones(64, device="meta"), torch.zeros(64, device="meta"),
                         torch.ones(8, 64, device="meta"), torch.zeros(8, 64, device="meta"), 1e-6)


@pytest.mark.parametrize("bad", ["head_dim_128", "float16", "non_contiguous", "bias_shape", "bias_dtype", "kv_mismatch",
                                 "head_dim_96", "kv_len_int64", "kv_len_shape"])
def test_flash_wrapper_rejects_what_the_kernel_does_not_take(bad):
    q = torch.zeros(2, 3, 16, 64)
    k = v = q
    bias = kv_len = None
    if bad == "head_dim_128":  # served since the Wan slice, like 80: the check passes
        for d in (80, 128):
            wide = torch.zeros(2, 3, 16, d)
            FA._check(wide, wide, wide, None)
        q = k = v = torch.zeros(2, 3, 16, 256)
    elif bad == "head_dim_96":
        q = k = v = torch.zeros(2, 3, 16, 96)
    elif bad == "kv_len_int64":
        kv_len = torch.zeros(2, dtype=torch.int64)
    elif bad == "kv_len_shape":
        kv_len = torch.zeros(3, dtype=torch.int32)
    elif bad == "float16":
        q = k = v = q.half()
    elif bad == "non_contiguous":
        q = torch.zeros(2, 16, 3, 64).transpose(1, 2)
    elif bad == "bias_shape":
        bias = torch.zeros(1, 3, 16, 15)
    elif bad == "bias_dtype":
        bias = torch.zeros(1, 3, 16, 16, dtype=torch.float64)
    elif bad == "kv_mismatch":
        k = v = torch.zeros(2, 2, 16, 64)
    with pytest.raises((TypeError, ValueError)):
        FA._check(q, k, v, bias, kv_len)


@pytest.mark.parametrize("bad", ["head_dim_12", "float16", "strided_last_dim", "table_shape", "table_dtype", "empty"])
def test_rope_wrapper_rejects_what_the_kernel_does_not_take(bad):
    from alg_tpu_torch.ops import rope as RO

    x, cos = torch.zeros(2, 3, 16, 64), torch.ones(16, 64)
    RO._check(x, cos, cos)
    RO._check(torch.zeros(2, 16, 3, 64).transpose(1, 2), cos, cos)  # the head-split view is taken as it is
    if bad == "head_dim_12":
        x, cos = torch.zeros(2, 3, 16, 12), torch.ones(16, 12)
    elif bad == "float16":
        x = x.half()
    elif bad == "strided_last_dim":
        x = torch.zeros(2, 3, 16, 128)[..., ::2]
    elif bad == "table_shape":
        cos = torch.ones(15, 64)
    elif bad == "table_dtype":
        cos = cos.double()
    elif bad == "empty":
        x, cos = torch.zeros(2, 3, 0, 64), torch.ones(0, 64)
    with pytest.raises((TypeError, ValueError)):
        RO._check(x, cos, cos)


def test_build_module_imports_and_raises_without_nvcc(monkeypatch, tmp_path):
    """``ops/_build`` imports with no nvcc, computes its library name from
    the sources, and refuses to build rather than falling back."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build.os.path, "isfile", lambda p: False)
    assert _build.library_path().name.startswith("libalg_kernels_")
    from alg_tpu_torch.ops import flash_attention_int8 as I8

    assert {p.name for p in _build._sources()[0]} == {"ada_norm.cu", "flash_attention.cu", "flash_attention_bwd.cu",
                                                      "flash_attention_bwd_dq_tc.cu", "flash_attention_bwd_tc.cu",
                                                      "flash_attention_int8_tc.cu", "flash_attention_tc.cu",
                                                      "flash_attention_wgmma.cu", "qk_prep.cu", "qk_prolog.cu",
                                                      "rope.cu"}
    assert {p.name for p in _build._sources()[1]} == {"common.cuh", "flash_simt.cuh", "mma.cuh"}
    # the flash sources declare their head dims in a ``// build-variants:`` line: one unit each
    assert [(u[0], u[2]) for u in _build.compile_units()] == [
        ("ada_norm", ()),
        *((f"{src}.ALG_FLASH_HEAD_DIM_{d}", (f"-DALG_FLASH_HEAD_DIM={d}",))
          for src in ("flash_attention", "flash_attention_bwd", "flash_attention_bwd_dq_tc", "flash_attention_bwd_tc")
          for d in FA.HEAD_DIMS),
        *((f"flash_attention_int8_tc.ALG_INT8_HEAD_DIM_{d}", (f"-DALG_INT8_HEAD_DIM={d}",)) for d in I8.HEAD_DIMS),
        *((f"flash_attention_tc.ALG_FLASH_HEAD_DIM_{d}", (f"-DALG_FLASH_HEAD_DIM={d}",)) for d in FA.HEAD_DIMS),
        ("flash_attention_wgmma", ()),  # one unit: D = 64 and 128 are template instantiations
        ("qk_prep", ()),
        *((f"qk_prolog.ALG_QK_HEAD_DIM_{d}", (f"-DALG_QK_HEAD_DIM={d}",)) for d in FA.HEAD_DIMS),
        ("rope", ())]
    monkeypatch.setattr(_build, "library_path", lambda: tmp_path / "missing.so")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
