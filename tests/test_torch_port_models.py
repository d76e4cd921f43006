"""The port's layers, RoPE, T5, DiT and VAE against the JAX package on the
CPU in fp32, with the same seeded weights carried across by the port's
weights bridge (``alg_tpu_torch.io.jax_params``).

Tolerances: single ops atol 1e-5 (same fp32 ops, other summation order);
whole forwards (T5, DiT, VAE) atol 1e-4, since the order differences of
many matmuls, norms and convolutions compound over the layers."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from alg_tpu.models import layers as JL
from alg_tpu.models import rope as JR

from alg_tpu_torch.io.jax_params import load_jax_params
from alg_tpu_torch.models import layers as L
from alg_tpu_torch.models import rope as R

from torch_port_common import jax_trees, port_module, random_tree, tiny_configs

OP_ATOL, FWD_ATOL = 1e-5, 1e-4


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def test_norms_and_activations():
    x = _rand(2, 5, 3, 8, 12, seed=1)
    w, b = 1 + _rand(12, seed=2, scale=0.1), _rand(12, seed=3, scale=0.1)
    jp = {"scale": jnp.asarray(w), "bias": jnp.asarray(b)}
    X, W, B = (torch.from_numpy(a) for a in (x, w, b))
    np.testing.assert_allclose(L.layer_norm(X, W, B, 1e-5).numpy(),
                               np.asarray(JL.layer_norm(jp, jnp.asarray(x), 1e-5)), atol=OP_ATOL, rtol=0)
    np.testing.assert_allclose(L.t5_layer_norm(X, W, 1e-6).numpy(),
                               np.asarray(JL.t5_layer_norm(jp, jnp.asarray(x), 1e-6)), atol=OP_ATOL, rtol=0)
    # group norm: the port is channels-first, the JAX package channels-last
    ref = np.asarray(JL.group_norm(jp, jnp.asarray(x), 4, 1e-6))
    out = L.group_norm(X.movedim(-1, 1), W, B, 4, 1e-6).movedim(1, -1)
    np.testing.assert_allclose(out.numpy(), ref, atol=OP_ATOL, rtol=0)
    np.testing.assert_allclose(L.gelu_tanh(X).numpy(), np.asarray(JL.gelu_tanh(jnp.asarray(x))), atol=OP_ATOL, rtol=0)


def test_timestep_embedding():
    t = np.array([999.0, 500.0, 1.0, 0.0], np.float32)
    ref = np.asarray(JL.sinusoidal_timestep_embedding(jnp.asarray(t), 64, flip_sin_to_cos=True))
    out = L.sinusoidal_timestep_embedding(torch.from_numpy(t), 64)
    np.testing.assert_allclose(out.numpy(), ref, atol=OP_ATOL, rtol=0)


def test_rope_tables_and_rotation():
    from alg_tpu.models.cogvideox import CogVideoXTransformerConfig, cogvideox_rope as jax_rope

    from alg_tpu_torch.models.cogvideox.transformer import CogVideoXTransformerConfig as TCfg, cogvideox_rope

    for cfg_kw, hw, f in [({}, (480, 720), 3), ({}, (480, 480), 2), (dict(sample_height=4, sample_width=4), (32, 32), 2)]:
        jc = CogVideoXTransformerConfig(**cfg_kw)
        tc = TCfg(**cfg_kw)
        for a, b in zip(cogvideox_rope(tc, *hw, f), jax_rope(jc, *hw, f)):
            np.testing.assert_array_equal(a, b)
    x = _rand(2, 3, 10, 16, seed=4)
    cos, sin = JR.cos_sin_interleaved(JR.rope_frequencies(16, np.arange(10.0)))
    ref = np.asarray(JR.apply_rope_interleaved(jnp.asarray(x), cos, sin))
    out = R.apply_rope_interleaved(torch.from_numpy(x), torch.from_numpy(cos), torch.from_numpy(sin))
    np.testing.assert_allclose(out.numpy(), ref, atol=OP_ATOL, rtol=0)


@pytest.fixture(scope="module")
def tiny():
    tcfg, vcfg, t5cfg = tiny_configs()
    return (tcfg, vcfg, t5cfg), jax_trees(tcfg, vcfg, t5cfg)


def test_t5_forward(tiny):
    from alg_tpu.models.t5 import t5_encode

    (_, _, t5cfg), (_, _, tree) = tiny
    ids = np.random.RandomState(5).randint(0, t5cfg.vocab_size, (2, 20)).astype(np.int32)
    ref = np.asarray(jax.jit(lambda p, i: t5_encode(p, t5cfg, i))(tree, jnp.asarray(ids)))
    with torch.no_grad():
        out = port_module("t5", t5cfg, tree)(torch.from_numpy(ids).long())
    np.testing.assert_allclose(out.numpy(), ref, atol=FWD_ATOL, rtol=0)


def test_dit_forward_small_cfg():
    """``__graft_entry__._small_cfgs()``: 4 heads of 64, 4 layers."""
    import __graft_entry__ as ge
    from alg_tpu.models.cogvideox import cogvideox_rope, cogvideox_transformer, init_cogvideox_transformer

    tcfg = ge._small_cfgs()
    tree = random_tree(lambda k: init_cogvideox_transformer(k, tcfg), 11)
    x = _rand(2, 2, tcfg.in_channels, 8, 8, seed=6)
    enc = _rand(2, 16, tcfg.text_embed_dim, seed=7)
    t = np.array([999.0, 321.0], np.float32)
    cos, sin = cogvideox_rope(tcfg, 64, 64, 2)
    ref = np.asarray(jax.jit(lambda p, *a: cogvideox_transformer(p, tcfg, *a))(
        tree, jnp.asarray(x), jnp.asarray(enc), jnp.asarray(t), cos, sin))
    with torch.no_grad():
        out = port_module("dit", tcfg, tree)(*(torch.from_numpy(a) for a in (x, enc, t, cos, sin)))
    assert out.shape == ref.shape == (2, 2, tcfg.out_channels, 8, 8)
    np.testing.assert_allclose(out.numpy(), ref, atol=FWD_ATOL, rtol=0)


def test_vae_encode_decode(tiny):
    from alg_tpu.models.cogvideox import cogvideox_vae_decode, cogvideox_vae_encode

    (_, vcfg, _), (_, tree, _) = tiny
    vae = port_module("vae", vcfg, tree)
    x = _rand(1, 5, 32, 32, 3, seed=8)
    z = _rand(1, 2, 4, 4, 4, seed=9)
    ref_m, ref_lv = jax.jit(lambda p, a: cogvideox_vae_encode(p, vcfg, a))(tree, jnp.asarray(x))
    ref_dec = jax.jit(lambda p, a: cogvideox_vae_decode(p, vcfg, a))(tree, jnp.asarray(z))
    with torch.no_grad():
        m, lv = vae.encode(torch.from_numpy(x))
        dec = vae.decode(torch.from_numpy(z))
    assert m.shape == ref_m.shape == (1, 2, 4, 4, 4)
    np.testing.assert_allclose(m.numpy(), np.asarray(ref_m), atol=FWD_ATOL, rtol=0)
    np.testing.assert_allclose(lv.numpy(), np.asarray(ref_lv), atol=FWD_ATOL, rtol=0)
    assert dec.shape == ref_dec.shape == (1, 5, 32, 32, 3)
    np.testing.assert_allclose(dec.numpy(), np.asarray(ref_dec), atol=FWD_ATOL, rtol=0)


def _fake_decode_jax(z):
    """A cheap position-dependent stand-in decoder (8x nearest upsample, 3
    channels, nonlinear) so the tiling assembly is checked on its own."""
    up = jnp.repeat(jnp.repeat(z[..., :3], 8, axis=2), 8, axis=3)
    return up * 0.5 + up**2


def _fake_decode_torch(z):
    up = z[..., :3].repeat_interleave(8, dim=2).repeat_interleave(8, dim=3)
    return up * 0.5 + up**2


@pytest.mark.parametrize("h,w", [(10, 14), (9, 9)])
def test_tiled_decode_multi_tile(h, w):
    from alg_tpu.models import vae_tiling as JT

    from alg_tpu_torch.models import vae_tiling as TT

    z = _rand(1, 2, h, w, 4, seed=10)
    ref = np.asarray(JT.tiled_decode(jax.jit(_fake_decode_jax), jnp.asarray(z), 8, tile_latent=6, stride_latent=4))
    calls = []

    def dec(t):
        calls.append(tuple(t.shape))
        return _fake_decode_torch(t)

    out = TT.tiled_decode(dec, torch.from_numpy(z), 8, tile_latent=6, stride_latent=4)
    assert len(calls) > 1 and out.shape == ref.shape == (1, 2, 8 * h, 8 * w, 3)
    np.testing.assert_allclose(out.numpy(), ref, atol=OP_ATOL, rtol=0)


def test_tiled_decode_real_vae(tiny):
    """The tiny VAE decoder through 2 x 2 overlapping tiles (edge tiles smaller)."""
    from alg_tpu.models import vae_tiling as JT
    from alg_tpu.models.cogvideox import cogvideox_vae_decode

    from alg_tpu_torch.models import vae_tiling as TT

    (_, vcfg, _), (_, tree, _) = tiny
    vae = port_module("vae", vcfg, tree)
    z = _rand(1, 2, 6, 6, 4, seed=12)
    jdec = jax.jit(lambda a: cogvideox_vae_decode(tree, vcfg, a))
    ref = np.asarray(JT.tiled_decode(jdec, jnp.asarray(z), 8, tile_latent=4, stride_latent=3))
    with torch.no_grad():
        out = TT.tiled_decode(vae.decode, torch.from_numpy(z), 8, tile_latent=4, stride_latent=3)
    assert out.shape == ref.shape == (1, 5, 48, 48, 3)
    np.testing.assert_allclose(out.numpy(), ref, atol=FWD_ATOL, rtol=0)


def test_tiled_encode_multi_tile():
    from alg_tpu.models import vae_tiling as JT

    from alg_tpu_torch.models import vae_tiling as TT

    x = _rand(1, 1, 40, 56, 3, seed=11)

    def enc(t):  # 8x mean-pool, returned as (mean, logvar)-like moments
        b, f, h, w, c = t.shape
        m = t.reshape(b, f, h // 8, 8, w // 8, 8, c).mean((3, 5))
        return m, m * 2.0 - 1.0

    ref = JT.tiled_encode(enc, jnp.asarray(x), 8, tile_px=24, stride_px=16)
    out = TT.tiled_encode(enc, torch.from_numpy(x), 8, tile_px=24, stride_px=16)
    for a, b in zip(out, ref):
        assert a.shape == b.shape == (1, 1, 5, 7, 3)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=OP_ATOL, rtol=0)


@pytest.mark.parametrize("defect", ["missing", "unused", "shape"])
def test_weights_bridge_rejects_mismatched_trees(tiny, defect):
    from alg_tpu_torch.models.t5 import T5Config, T5Encoder

    from torch_port_common import port_cfg

    (_, _, t5cfg), (_, _, tree) = tiny
    tree = jax.tree.map(np.array, tree)
    if defect == "missing":
        del tree["blocks"][1]["wi_0"]
    elif defect == "unused":
        tree["blocks"][0]["extra"] = {"kernel": np.zeros((2, 2), np.float32)}
    else:
        tree["final_norm"]["scale"] = np.ones(5, np.float32)
    with pytest.raises(KeyError if defect != "shape" else ValueError):
        load_jax_params(T5Encoder(port_cfg(T5Config, t5cfg)), tree)
