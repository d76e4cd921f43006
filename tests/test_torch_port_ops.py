"""The port's kernel modules on the CPU: the plain versions against the JAX
package's kernels and references, and the wrappers' refusal of what the
CUDA kernels do not take.

JAX side, as its own CPU tests run it: ``qk_norm_rope`` in Pallas interpret
mode (``force="pallas", interpret=True``) and as the XLA composition
(``force="xla"``); attention through ``_xla_attention`` (the Pallas flash
kernel does not lower on the CPU). All fp32, atol 1e-5: the same ops in
another order (64-wide norms, softmax sums over at most 300 keys)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from alg_tpu.models import layers as JL
from alg_tpu.ops.attention import _xla_attention
from alg_tpu.ops.qk_prep import qk_norm_rope as jax_qk_norm_rope

from alg_tpu_torch.models import layers as L
from alg_tpu_torch.ops import _build
from alg_tpu_torch.ops import flash_attention as FA
from alg_tpu_torch.ops.attention import attention
from alg_tpu_torch.ops.qk_prep import qk_norm_rope

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


def test_cpu_calls_launch_nothing():
    FA.flash_attention.launches = 0
    from alg_tpu_torch.ops import qk_prep

    qk_prep.qk_norm_rope.launches = 0
    x, scale, bias, cos, sin = _qk_inputs(8)
    qk_norm_rope(*_t(x, scale, bias, cos, sin), 1e-6)
    q = torch.zeros(1, 1, 8, 64)
    FA.flash_attention(q, q, q, 0.125)
    assert FA.flash_attention.launches == 0 and qk_prep.qk_norm_rope.launches == 0


@pytest.mark.parametrize("which", ["flash", "qk_prep"])
def test_non_cpu_tensor_raises_instead_of_falling_back(which):
    """A tensor that is not on the CPU never takes the plain version: on a
    machine without CUDA the wrapper raises (here: a 'meta' tensor)."""
    meta = torch.empty(1, 2, 8, 64, device="meta")
    with pytest.raises(RuntimeError, match="no kernel for device"):
        if which == "flash":
            FA.flash_attention(meta, meta, meta, 0.125)
        else:
            qk_norm_rope(meta, torch.ones(64, device="meta"), torch.zeros(64, device="meta"),
                         torch.ones(8, 64, device="meta"), torch.zeros(8, 64, device="meta"), 1e-6)


@pytest.mark.parametrize("bad", ["head_dim_128", "float16", "non_contiguous", "bias_shape", "bias_dtype", "kv_mismatch"])
def test_flash_wrapper_rejects_what_the_kernel_does_not_take(bad):
    q = torch.zeros(2, 3, 16, 64)
    k = v = q
    bias = None
    if bad == "head_dim_128":
        q = k = v = torch.zeros(2, 3, 16, 128)
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
        FA._check(q, k, v, bias)


def test_build_module_imports_and_raises_without_nvcc(monkeypatch, tmp_path):
    """``ops/_build`` imports with no nvcc, computes its library name from
    the sources, and refuses to build rather than falling back."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build.os.path, "isfile", lambda p: False)
    assert _build.library_path().name.startswith("libalg_kernels_")
    assert {p.name for p in _build._sources()[0]} == {"flash_attention.cu", "qk_prep.cu"}
    monkeypatch.setattr(_build, "library_path", lambda: tmp_path / "missing.so")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
