"""The port's int8 attention on the CPU against the JAX package's.

JAX side, as its own CPU tests run it: ``flash_attention_int8(...,
interpret=True)`` with explicit blocks (Pallas interpret mode), and exact
attention through ``_xla_attention``. Port side: the quantizers and
``flash_attention_int8_plain`` (what ``flash_attention_int8`` runs for a CPU
tensor), and ``attention()`` under ``set_attention_int8``. Inputs come from a
numpy seed, fp32: unit-norm rows times sqrt(D) for q and k, as after a
per-head norm, with a common-mode offset on k, as
``tests/test_attention_int8.py`` makes them.

Tolerances. Quantizer codes: equal, but for at most one code on under 1e-4 of
the entries (the two frameworks sum the K mean in another order, so a value on
a rounding tie may fall the other way); scales rtol 1e-6. ``"qk"`` mode
against JAX: atol 2e-5 + rtol 2e-5, the JAX tests' own bound for the same
codes in another summation order; the inputs of these cases lie on a grid of
2**-8, which makes the codes the same in both frameworks (``_dit_like_qkv``).
``"full"`` mode: mean under 1e-5 and max under 2e-3 (a P code on a tie flips: one code is 1/127 of a row's largest p),
again the JAX tests' bounds. Drift against exact attention: the JAX tests'
bounds, relative to the output's rms.
"""

import dataclasses
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from alg_tpu.models.cogvideox import transformer as jax_cog
from alg_tpu.models.hunyuan import transformer as jax_hy
from alg_tpu.ops.attention import _xla_attention
from alg_tpu.ops.attention import attention as jax_attention
from alg_tpu.ops.flash_attention_int8 import flash_attention_int8 as jax_flash_attention_int8
from alg_tpu.ops.flash_attention_int8 import quantize_qk_int8 as jax_quantize_qk_int8
from alg_tpu.ops.flash_attention_int8 import quantize_v_int8 as jax_quantize_v_int8

from alg_tpu_torch.ops import attention as A
from alg_tpu_torch.ops import flash_attention_int8 as I8

from torch_port_common import one_thread, port_module, random_tree, tiny_hunyuan_configs


jax_attention_module = sys.modules["alg_tpu.ops.attention"]  # the package exports the function under this name


def _dit_like_qkv(seed, b, h, s, d, grid=False):
    """``grid``: every value rounded to a multiple of 2**-8. Sums of such
    values are exact in fp32 in any order, so the K mean, and with it every
    code, is the same number in both frameworks, and what is left to compare
    is the arithmetic after the quantizers. Without it a centred K value on a
    rounding tie may take the neighbouring code in one of the two, which moves
    that key's weight in every row by about 1%."""
    rng = np.random.RandomState(seed)
    q = rng.randn(b, h, s, d).astype(np.float32)
    k = rng.randn(b, h, s, d).astype(np.float32)
    q = q / np.linalg.norm(q, axis=-1, keepdims=True) * np.sqrt(d)
    k = k / np.linalg.norm(k, axis=-1, keepdims=True) * np.sqrt(d)
    k = k + 3.0 * rng.randn(b, h, 1, d).astype(np.float32)
    v = rng.randn(b, h, s, d).astype(np.float32)
    if grid:
        q, k, v = (np.round(t * 256.0) / 256.0 for t in (q, k, v))
    return tuple(t.astype(np.float32) for t in (q, k, v))


def _t(*arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


def _assert_codes_equal(got, want):
    diff = np.abs(got.numpy().astype(np.int32) - np.asarray(want).astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-4, (diff.max(), (diff > 0).mean())


@pytest.fixture
def int8_mode():
    """Switches the port's and the JAX package's int8 modes off after a test."""
    yield
    A.set_attention_int8(False)
    jax_attention_module.set_attention_int8(False)


# -- quantizers ---------------------------------------------------------------------------------------------------


@pytest.mark.parametrize("s,d,bq,bk", [(256, 64, 128, 128), (384, 64, 128, 384), (1024, 128, 512, 1024)],
                         ids=["s256", "s384", "s1024-d128-default-blocks"])
def test_quantize_qk_int8_matches_jax(s, d, bq, bk):
    q, k, _ = _dit_like_qkv(0, 2, 3, s, d)
    ref = jax_quantize_qk_int8(jnp.asarray(q), jnp.asarray(k), d ** -0.5, bq, bk)
    out = I8.quantize_qk_int8(*_t(q, k), d ** -0.5, bq, bk)
    for got, want in zip(out[:2], ref[:2]):
        assert got.dtype == torch.int8 and tuple(got.shape) == (6, s, d)
        _assert_codes_equal(got, want)
    for got, want in zip(out[2:], ref[2:]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)


def test_quantize_qk_int8_takes_a_short_last_block():
    """S = 200 with blocks of 128: the last block's scale comes from its 72
    rows alone, which is what the JAX package gets after padding with zeros."""
    q, k, _ = _dit_like_qkv(1, 1, 2, 200, 64)
    pad = [(0, 0), (0, 0), (0, 56), (0, 0)]
    # the K mean over 200 rows, then the padding: the JAX function would take the mean over 256
    kc = k - k.mean(axis=2, keepdims=True)
    ref = jax_quantize_qk_int8(jnp.asarray(np.pad(q, pad)), jnp.asarray(np.pad(kc, pad)), 0.125, 128, 128)
    out = I8.quantize_qk_int8(*_t(q, k), 0.125, 128, 128)
    for got, want in zip(out[:2], ref[:2]):
        _assert_codes_equal(got, np.asarray(want)[:, :200])
    np.testing.assert_allclose(out[2].numpy(), np.asarray(ref[2]), rtol=1e-6)
    # the padded rows pull the JAX mean, and through it the K scales, by a little: not the q scales above
    np.testing.assert_allclose(out[3].numpy(), np.asarray(ref[3]), rtol=0.25)


def test_quantize_v_int8_matches_jax():
    _, _, v = _dit_like_qkv(2, 2, 3, 256, 64)
    ref_codes, ref_sv = jax_quantize_v_int8(jnp.asarray(v.reshape(6, 256, 64)), 64)
    codes, sv = I8.quantize_v_int8(*_t(v))
    assert codes.dtype == torch.int8 and tuple(codes.shape) == (6, 256, 64) and tuple(sv.shape) == (6, 64)
    _assert_codes_equal(codes, ref_codes)
    np.testing.assert_allclose(sv.numpy(), np.asarray(ref_sv), rtol=1e-6, atol=0)


def test_quantizers_keep_the_tail_past_kv_len_out_of_every_statistic():
    """Fault R2 of the reference handled: huge keys and values at or past
    ``kv_len`` change no code of a valid row and no scale; the tail's own
    codes are zero; a batch row with ``kv_len`` 0 gives zero codes."""
    q, k, v = _dit_like_qkv(3, 3, 2, 256, 64)
    kv_len = torch.tensor([183, 256, 0], dtype=torch.int32)
    k2, v2 = k.copy(), v.copy()
    k2[0, :, 183:] = 1e4
    v2[0, :, 183:] = -1e4
    k2[2], v2[2] = 1e4, 1e4
    a = I8.quantize_qk_int8(*_t(q, k), 0.125, 128, 128, kv_len) + I8.quantize_v_int8(*_t(v), kv_len)
    b = I8.quantize_qk_int8(*_t(q, k2), 0.125, 128, 128, kv_len) + I8.quantize_v_int8(*_t(v2), kv_len)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    k_int, v_int = a[1].reshape(3, 2, 256, 64), a[4].reshape(3, 2, 256, 64)
    assert not k_int[0, :, 183:].any() and not v_int[0, :, 183:].any() and not k_int[2].any() and not v_int[2].any()
    # kv_len = S everywhere is the call without kv_len
    full = torch.full((3,), 256, dtype=torch.int32)
    for x, y in zip(I8.quantize_qk_int8(*_t(q, k), 0.125, 128, 128, full), I8.quantize_qk_int8(*_t(q, k), 0.125, 128, 128)):
        if x.dtype == torch.int8:
            _assert_codes_equal(x, y.numpy())
        else:
            np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-6)


# -- the plain version against the JAX kernel in interpret mode ---------------------------------------------------


@pytest.mark.parametrize("pv", [False, True], ids=["qk", "full"])
@pytest.mark.parametrize("s,d,bq,bk", [(256, 64, 128, 128), (384, 64, 128, 384), (256, 128, 128, 128)],
                         ids=["s256", "s384-bk384", "d128"])
def test_int8_plain_matches_the_jax_kernel(s, d, bq, bk, pv):
    q, k, v = _dit_like_qkv(5 if pv else 0, 1, 2, s, d, grid=True)
    ref = np.asarray(jax_flash_attention_int8(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), d ** -0.5, block_q=bq,
                                              block_k=bk, pv_int8=pv, interpret=True))
    out = I8.flash_attention_int8(*_t(q, k, v), d ** -0.5, block_q=bq, block_k=bk, pv_int8=pv).numpy()
    if pv:
        err = np.abs(out - ref)
        assert err.mean() < 1e-5 and err.max() < 2e-3, (err.mean(), err.max())
    else:
        np.testing.assert_allclose(out, ref, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("pv", [False, True], ids=["qk", "full"])
@pytest.mark.parametrize("d", [64, 128])
def test_int8_plain_at_a_ragged_length(d, pv):
    """S = 200 under the default blocks (512 / 1024: one short block of
    each): drift-level agreement with exact attention, the JAX tests' bounds
    for its padded call, and with the JAX kernel itself, whose K mean runs
    over the padded 1,024 rows (so its codes differ)."""
    q, k, v = _dit_like_qkv(10, 1, 1, 200, d)
    out = I8.flash_attention_int8(*_t(q, k, v), d ** -0.5, pv_int8=pv).numpy()
    assert out.shape == (1, 1, 200, d)
    exact = np.asarray(_xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), d ** -0.5))
    err = np.abs(out - exact)
    assert err.mean() < 8e-3 and err.max() < 8e-2, (err.mean(), err.max())
    ref = np.asarray(jax_flash_attention_int8(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), d ** -0.5, pv_int8=pv,
                                              interpret=True))
    assert np.abs(out - ref).mean() < 8e-3


@pytest.mark.parametrize("pv", [False, True], ids=["qk", "full"])
@pytest.mark.parametrize("d", [64, 128])
def test_int8_plain_drift_is_bounded(d, pv):
    q, k, v = _dit_like_qkv(2 if d == 64 else 9, 2, 4 if d == 64 else 2, 512, d)
    out = I8.flash_attention_int8(*_t(q, k, v), d ** -0.5, block_q=256, block_k=256, pv_int8=pv).numpy()
    exact = np.asarray(_xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), d ** -0.5))
    err, rms = np.abs(out - exact), float(np.sqrt((exact ** 2).mean()))
    mean_bound = 3e-2 if pv else 2e-2
    max_bound = {(64, False): 1.5e-1, (64, True): 2e-1, (128, False): 1.5e-1, (128, True): 3e-1}[(d, pv)]
    assert err.mean() / rms < mean_bound and err.max() / rms < max_bound, (err.mean() / rms, err.max() / rms)


@pytest.mark.parametrize("pv", [False, True], ids=["qk", "full"])
@pytest.mark.parametrize("d", [64, 128])
def test_int8_kv_len_masks_keys_and_their_statistics(d, pv):
    """``kv_len``: drift-level agreement with exact masked attention on the
    rows below it (the JAX test's bound), and fault R2 handled: huge keys and
    values past ``kv_len`` leave the output unchanged bit for bit. The JAX
    package fails the second: there the tail enters the K mean, the K block
    scales and the V channel scales, so its own test allows 2e-1."""
    s = 256
    q, k, v = _dit_like_qkv(11, 2, 2, s, d)
    kv_len = np.asarray([183, 256], np.int32)
    out = I8.flash_attention_int8(*_t(q, k, v), d ** -0.5, block_q=128, block_k=128, pv_int8=pv,
                                  kv_len=torch.from_numpy(kv_len))
    exact = np.asarray(_xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), d ** -0.5,
                                      kv_len=jnp.asarray(kv_len)))
    mask = (np.arange(s)[None, :] < kv_len[:, None])[:, None, :, None]
    err = np.abs(out.numpy() - exact) * mask
    rms = float(np.sqrt((exact ** 2 * mask).sum() / mask.sum() / d / 2))
    assert err.mean() / rms < 5e-2, (err.mean(), rms)
    k2, v2 = k.copy(), v.copy()
    k2[0, :, 183:], v2[0, :, 183:] = 1e4, -1e4
    poisoned = I8.flash_attention_int8(*_t(q, k2, v2), d ** -0.5, block_q=128, block_k=128, pv_int8=pv,
                                       kv_len=torch.from_numpy(kv_len))
    assert torch.equal(poisoned, out)


@pytest.mark.parametrize("d", [64, 128])
def test_int8_full_mode_skips_key_blocks_without_a_visible_key(d):
    """Fault R6 of the reference handled: with 128-key blocks and ``kv_len``
    100 and 0, whole key blocks lie past ``kv_len``; the output is finite,
    equals the call on the sequence cut to the keys there are (same query
    block scales: the queries are those of the first block), and a row with
    ``kv_len`` 0 is zero."""
    q, k, v = _dit_like_qkv(12, 2, 2, 384, d)
    kv_len = torch.tensor([100, 0], dtype=torch.int32)
    out = I8.flash_attention_int8(*_t(q, k, v), d ** -0.5, block_q=128, block_k=128, pv_int8=True, kv_len=kv_len)
    assert bool(torch.isfinite(out).all()) and not out[1].any()
    cut = I8.flash_attention_int8(*_t(q[:1, :, :128], k[:1, :, :128], v[:1, :, :128]), d ** -0.5, block_q=128,
                                  block_k=128, pv_int8=True, kv_len=kv_len[:1])
    torch.testing.assert_close(out[:1, :, :128], cut, atol=1e-6, rtol=1e-6)


def test_int8_refuses_gradients_and_cross_attention():
    """Fault R3 of the reference handled: an input that requires a gradient
    raises, from ``flash_attention_int8`` and from ``attention()`` when the
    int8 route would take the call; a call that does not qualify keeps its
    gradient."""
    q, k, v = _t(*_dit_like_qkv(13, 1, 1, 64, 64))
    with pytest.raises(ValueError, match="self-attention"):
        I8.flash_attention_int8(q, k[:, :, :32], v[:, :, :32], 0.125)
    with pytest.raises(RuntimeError, match="requires a gradient"):
        I8.flash_attention_int8(q.clone().requires_grad_(), k, v, 0.125)
    A.set_attention_int8("qk")
    try:
        with pytest.raises(RuntimeError, match="requires a gradient"):
            A.attention(q, k.clone().requires_grad_(), v, stable=False)
        with torch.no_grad():  # nothing records a graph: the call goes through
            A.attention(q, k.clone().requires_grad_(), v, stable=False)
        leaf = q.clone().requires_grad_()
        A.attention(leaf, k, v).sum().backward()  # stable=True does not qualify
        assert leaf.grad is not None
    finally:
        A.set_attention_int8(False)


# -- the route ----------------------------------------------------------------------------------------------------


@pytest.mark.parametrize("value,mode", [(True, "qk"), ("qk", "qk"), ("full", "full"), (False, None), (None, None)])
def test_set_attention_int8_takes_the_jax_values(value, mode, int8_mode):
    A.set_attention_int8("full" if mode is None else False)
    A.set_attention_int8(value)
    jax_attention_module.set_attention_int8(value)
    assert A.get_attention_int8() == mode == jax_attention_module.get_attention_int8()


@pytest.mark.parametrize("value", ["pv", 2, "int8", 0.5])
def test_set_attention_int8_rejects_the_rest(value, int8_mode):
    A.set_attention_int8("qk")
    with pytest.raises(ValueError, match="set_attention_int8"):
        A.set_attention_int8(value)
    assert A.get_attention_int8() == "qk"


ROUTE_CASES = {  # what each condition of the route sends the call to
    "qualifies": (dict(stable=False), "int8"),
    "qualifies-with-kv-len": (dict(stable=False, kv_len=True), "int8"),
    "stable": (dict(stable=True), "flash"),
    "causal": (dict(stable=False, causal=True), "flash"),
    "bias": (dict(stable=False, bias=True), "flash"),
    "prolog": (dict(stable=False, prolog=True), "flash"),
    "cross": (dict(stable=False, sk=48), "flash"),
}


@pytest.mark.parametrize("mode", ["qk", "full", None])
@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_attention_route(case, mode, monkeypatch, int8_mode):
    """A spy on the two functions ``attention()`` can send a call to, under
    each mode: only a call with ``stable=False``, no causal mask, no bias, no
    prolog and Sq == Sk reaches the int8 function, with the mode's
    ``pv_int8`` and the caller's ``kv_len``; with the mode off none does."""
    kw, target = ROUTE_CASES[case]
    kw = dict(kw)
    calls = []
    monkeypatch.setattr(A, "flash_attention_int8",
                        lambda q, k, v, scale, **k2: calls.append(("int8", k2)) or torch.zeros_like(q))
    monkeypatch.setattr(A, "flash_attention", lambda q, k, v, scale, **k2: calls.append(("flash", k2)) or torch.zeros_like(q))
    sk = kw.pop("sk", 64)
    q, k, v = torch.zeros(2, 2, 64, 64), torch.zeros(2, 2, sk, 64), torch.zeros(2, 2, sk, 64)
    kv_len = torch.tensor([40, 64], dtype=torch.int32) if kw.pop("kv_len", False) else None
    if kw.pop("bias", False):
        kw["bias"] = torch.zeros(1, 2, 64, sk)
    if kw.pop("prolog", False):
        kw["prolog"] = {"norm": "rms", "eps": 1e-6, "q_scale": torch.ones(64), "k_scale": torch.ones(64)}
    A.set_attention_int8(mode)
    A.attention(q, k, v, kv_len=kv_len, **kw)
    (name, passed), = calls
    assert name == (target if mode else "flash")
    assert passed["kv_len"] is kv_len
    if name == "int8":
        assert passed["pv_int8"] == (mode == "full") and set(passed) == {"pv_int8", "kv_len"}


def test_attention_under_int8_matches_the_jax_route(int8_mode):
    """``attention(stable=False)`` with the mode on: the port (plain version)
    against the JAX package's own route, forced to its kernel in interpret
    mode, at S = 1024 with the default blocks."""
    q, k, v = _dit_like_qkv(14, 1, 2, 1024, 64, grid=True)
    A.set_attention_int8("qk")
    out = A.attention(*_t(q, k, v), stable=False).numpy()
    ref = np.asarray(jax_flash_attention_int8(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 64 ** -0.5,
                                              interpret=True))
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=2e-5)
    exact = A.attention(*_t(q, k, v), stable=True).numpy()  # does not qualify: the exact path
    assert 1e-4 < np.abs(out - exact).max() < 5e-2
    assert jax_attention_module.get_attention_int8() is None  # the JAX mode was never needed


# -- the slice as a whole: DiT forwards with int8 attention on ----------------------------------------------------


def _jax_int8_attention(mode):
    """What the JAX dispatcher does for a qualifying call on a TPU, with the
    kernel in interpret mode; every other call goes to ``attention`` as it
    is. Patched over the ``attention`` name a JAX model module imported."""

    def attention(q, k, v, scale=None, causal=False, kv_len=None, bias=None, impl="auto", stable=True, prolog=None):
        if not stable and not causal and bias is None and prolog is None and q.shape[2] == k.shape[2]:
            scale = q.shape[-1] ** -0.5 if scale is None else scale
            return jax_flash_attention_int8(q, k, v, scale=scale, pv_int8=mode == "full", kv_len=kv_len,
                                            interpret=True)
        return jax_attention(q, k, v, scale=scale, causal=causal, kv_len=kv_len, bias=bias, impl=impl, stable=stable,
                             prolog=prolog)

    return attention


def _cog_case(text_len, grid):
    """A 2-layer CogVideoX DiT with one head of 64 over ``text_len`` +
    3 x grid x grid tokens, and its inputs."""
    from alg_tpu.models.cogvideox import CogVideoXTransformerConfig, cogvideox_rope, init_cogvideox_transformer

    tcfg = CogVideoXTransformerConfig(num_attention_heads=1, attention_head_dim=64, in_channels=8, out_channels=4,
                                      time_embed_dim=16, text_embed_dim=12, num_layers=2, sample_height=2 * grid,
                                      sample_width=2 * grid, max_text_seq_length=text_len)
    tree = random_tree(lambda key: init_cogvideox_transformer(key, tcfg), 41)
    r = np.random.RandomState(42)
    x = r.randn(1, 3, tcfg.in_channels, 2 * grid, 2 * grid).astype(np.float32)
    text = r.randn(1, text_len, tcfg.text_embed_dim).astype(np.float32)
    ts = np.array([700.0], np.float32)
    cos, sin = cogvideox_rope(tcfg, 16 * grid, 16 * grid, 3)
    return tcfg, tree, (x, text, ts, np.asarray(cos), np.asarray(sin))


def _hunyuan_case(text_len, valid, frames):
    """A Hunyuan DiT (one refiner, one double and one single block, one head
    of 128) over ``frames`` x 8 x 8 video tokens and ``text_len`` text
    positions of which ``valid`` count (the joint ``kv_len``)."""
    from alg_tpu.models.hunyuan import hunyuan_rope, init_hunyuan_transformer

    tcfg = dataclasses.replace(tiny_hunyuan_configs()[0], num_attention_heads=1, attention_head_dim=128,
                               rope_axes_dim=(16, 56, 56))
    tree = random_tree(lambda key: init_hunyuan_transformer(key, tcfg), 43)
    r = np.random.RandomState(44)
    x = r.randn(1, tcfg.in_channels, frames, 16, 16).astype(np.float32)
    text = r.randn(1, text_len, tcfg.text_embed_dim).astype(np.float32)
    pooled = r.randn(1, tcfg.pooled_projection_dim).astype(np.float32)
    mask = (np.arange(text_len)[None, :] < valid).astype(np.int32)
    cos, sin = hunyuan_rope(tcfg, frames, 16, 16)
    return tcfg, tree, (x, np.array([600.0], np.float32), text, mask, pooled, np.full((1,), 6000.0, np.float32),
                        np.asarray(cos), np.asarray(sin))


def _forwards(family, case, mode, monkeypatch):
    """(port forward with int8 on, JAX forward with int8 on, port forward with it off)."""
    tcfg, tree, inputs = case
    if family == "cogvideox":
        monkeypatch.setattr(jax_cog, "attention", _jax_int8_attention(mode))
        ref = jax.jit(lambda p, *a: jax_cog.cogvideox_transformer(p, tcfg, *a, *inputs[-2:]))(
            tree, *map(jnp.asarray, inputs[:-2]))
        dit = port_module("dit", tcfg, tree)
    else:
        monkeypatch.setattr(jax_hy, "attention", _jax_int8_attention(mode))
        ref = jax.jit(lambda p, *a: jax_hy.hunyuan_transformer(p, tcfg, *a, *inputs[-2:]))(
            tree, *map(jnp.asarray, inputs[:-2]))
        dit = port_module("hunyuan_dit", tcfg, tree)
    args = _t(*inputs)
    with torch.no_grad():
        exact = dit(*args)
        A.set_attention_int8(mode)
        out = dit(*args)
    return out.numpy(), np.asarray(ref), exact.numpy()


# The whole forward with int8 attention, port against JAX at S = 1,024 (one 1,024-key block, two 512-row
# blocks, no padding on the JAX side, so both quantize the same blocks). The attention outputs agree to the
# kernel tolerances above, but a q, k or v value on a rounding tie may take the neighbouring code in one of
# the two frameworks, which moves that key's weight by about 1%; two or three blocks carry that to the
# output. Bounds on (largest, mean) |port - JAX| over the rms of the output without int8, about four times
# what these seeds give (CogVideoX 2.4e-4 and 9e-7, Hunyuan at head dim 128 1.4e-3 and 6.4e-5); the int8
# modes themselves move the outputs by 3e-3 and 4e-4 (CogVideoX) and 1.7e-2 and 1e-3 (Hunyuan).
SLICE_BOUNDS = {"cogvideox": (1e-3, 2e-5), "hunyuan": (5e-3, 2e-4)}


@pytest.mark.parametrize("mode", ["qk", "full"])
@pytest.mark.parametrize("family", ["cogvideox", "hunyuan"])
def test_dit_forward_with_int8_attention_matches_jax(family, mode, monkeypatch, int8_mode):
    """S = 1,024: CogVideoX 256 text + 3 x 16 x 16 video tokens; Hunyuan
    15 x 8 x 8 video + 64 text positions, all valid (``kv_len`` = S, so that
    fault R2 of the reference, which the port does not copy, makes no
    difference; the ragged case below has padded text)."""
    case = _cog_case(256, 16) if family == "cogvideox" else _hunyuan_case(64, 64, 15)
    out, ref, exact = _forwards(family, case, mode, monkeypatch)
    rms = float(np.sqrt((exact ** 2).mean()))
    err = np.abs(out - ref)
    max_bound, mean_bound = SLICE_BOUNDS[family]
    assert err.max() / rms < max_bound and err.mean() / rms < mean_bound, (err.max() / rms, err.mean() / rms)
    moved = np.abs(out - exact).max() / rms
    assert 1e-4 < moved < 0.5, moved  # the mode was on, and it is a perturbation


@pytest.mark.parametrize("mode", ["qk", "full"])
@pytest.mark.parametrize("family", ["cogvideox", "hunyuan"])
def test_dit_forward_with_int8_attention_at_a_ragged_length(family, mode, monkeypatch, int8_mode):
    """A ragged S (CogVideoX 10 + 3 x 6 x 6 = 118; Hunyuan 3 x 8 x 8 + 20 text
    positions of which 13 count = 212 with ``kv_len`` 205): the JAX side pads
    to 1,024 and, with ``kv_len``, takes its statistics over the padded text
    too, so the two are held to the int8 drift: the mean difference of each
    from the forward without int8, and of the two from each other, under 1e-2
    of that forward's rms (these seeds give 4e-4 to 1.4e-3)."""
    case = _cog_case(10, 6) if family == "cogvideox" else _hunyuan_case(20, 13, 3)
    out, ref, exact = _forwards(family, case, mode, monkeypatch)
    rms = float(np.sqrt((exact ** 2).mean()))
    for a, b in ((out, exact), (ref, exact), (out, ref)):
        assert np.abs(a - b).mean() / rms < 1e-2, np.abs(a - b).mean() / rms
    assert np.isfinite(out).all()


# The JAX package's bounds on int8 drift against exact attention, over the exact output's rms (mean, max),
# at the default block_k of 1,024: "qk" from test_drift_vs_exact_attention_bounded, "full" the D = 64 bound
# of test_pv_drift_vs_exact_attention_bounded.
REFERENCE_DRIFT_BOUNDS = {False: (2e-2, 1.5e-1), True: (3e-2, 2e-1)}


@pytest.mark.parametrize("pv_int8", [False, True], ids=["qk", "full"])
@pytest.mark.parametrize("d", [64, 128])
def test_int8_drift_on_dit_like_inputs_is_the_reference_algorithms(d, pv_int8):
    """The on-card drift of ``"full"`` mode over the JAX package's bound
    (ROADMAP P3, now R7) is the reference's own: on the DiT-like inputs of
    ``chip_smoke.py`` phase B at S = 2,048 and ``block_k`` 1,024, the Pallas
    kernel in interpret mode and the port's plain version drift from exact
    attention by the same amount (mean and max within 2% of each other), and
    at D = 64 ``"full"`` both are over the reference's own bound on the
    largest error. One P scale a (row, 64-key block) brings the port under
    it (``block_k`` 64)."""
    q, k, v = _dit_like_qkv(0, 1, 2, 2048, d)
    scale = d ** -0.5
    exact = np.asarray(_xla_attention(*map(jnp.asarray, (q, k, v)), scale))
    rms = float(np.sqrt((exact ** 2).mean()))
    ref = np.asarray(jax_flash_attention_int8(*map(jnp.asarray, (q, k, v)), scale, block_k=1024, pv_int8=pv_int8,
                                              interpret=True))
    drift = {}
    for name, out in (("reference", ref), ("port", I8.flash_attention_int8_plain(*_t(q, k, v), scale, 512, 1024,
                                                                                  pv_int8, None).numpy()),
                      ("port_bk64", I8.flash_attention_int8_plain(*_t(q, k, v), scale, 512, 64, pv_int8,
                                                                  None).numpy())):
        err = np.abs(out - exact)
        drift[name] = (err.mean() / rms, err.max() / rms)
    np.testing.assert_allclose(drift["port"], drift["reference"], rtol=2e-2, err_msg=str(drift))
    mean_bound, max_bound = REFERENCE_DRIFT_BOUNDS[pv_int8]
    assert drift["reference"][0] < mean_bound, drift
    if pv_int8 and d == 64:
        assert drift["reference"][1] > max_bound, drift  # R7: the reference itself
    assert drift["port_bk64"][0] < mean_bound and drift["port_bk64"][1] < max_bound, drift
