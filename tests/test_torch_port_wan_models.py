"""The modules of the port's Wan slice against the JAX package on the CPU in
fp32, with the same seeded weights carried across by the port's weights
bridge: layers, RoPE tables, the UniPC scheduler, UMT5, the CLIP vision
tower, the Wan DiT and the Wan VAE.

Tolerances: single ops and scheduler steps atol 1e-5 (same fp32 ops, other
summation order); whole forwards atol 1e-4, since the order differences of
many matmuls, norms and convolutions compound over the layers. The UniPC
plan tables are solved in float64 by the same numpy code and must be equal
bit for bit."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from alg_tpu.models import layers as JL
from alg_tpu.models import vae_tiling as JT
from alg_tpu.models.clip import clip_vision_hidden_states
from alg_tpu.models.t5 import t5_encode
from alg_tpu.models.wan import WanTransformerConfig, init_wan_transformer, wan_rope as jax_wan_rope
from alg_tpu.models.wan import wan_transformer, wan_vae_decode, wan_vae_encode
from alg_tpu.schedulers import unipc as JU

from alg_tpu_torch.io.jax_params import load_jax_params
from alg_tpu_torch.models import layers as L
from alg_tpu_torch.models import vae_tiling as T
from alg_tpu_torch.models.wan.transformer import WanTransformerConfig as TCfg, wan_rope
from alg_tpu_torch.schedulers import unipc as U

from torch_port_common import (one_torch_thread, port_module, random_tree, tiny_wan_configs, tokenize_mask_stub,
                               wan_trees)

OP_ATOL, FWD_ATOL = 1e-5, 1e-4


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


@pytest.fixture(scope="module")
def tiny():
    cfgs = tiny_wan_configs()
    return cfgs, wan_trees(*cfgs)


# -- layers --------------------------------------------------------------------


def test_rms_norm_affine_free_layer_norm_and_exact_gelu():
    import jax

    x = _rand(2, 5, 24, seed=1)
    w = 1 + _rand(24, seed=2, scale=0.1)
    X, W = torch.from_numpy(x), torch.from_numpy(w)
    np.testing.assert_allclose(L.t5_layer_norm(X, W, 1e-6).numpy(),
                               np.asarray(JL.rms_norm({"scale": jnp.asarray(w)}, jnp.asarray(x), 1e-6)),
                               atol=OP_ATOL, rtol=0)
    np.testing.assert_allclose(L.layer_norm(X, None, None, 1e-6).numpy(),
                               np.asarray(JL.layer_norm({}, jnp.asarray(x), 1e-6)), atol=OP_ATOL, rtol=0)
    np.testing.assert_allclose(L.LayerNorm(24, 1e-6, affine=False)(X).numpy(),
                               np.asarray(JL.layer_norm({}, jnp.asarray(x), 1e-6)), atol=OP_ATOL, rtol=0)
    assert not list(L.LayerNorm(24, affine=False).parameters())
    np.testing.assert_allclose(L.gelu(X).numpy(), np.asarray(jax.nn.gelu(jnp.asarray(x), approximate=False)),
                               atol=OP_ATOL, rtol=0)


@pytest.mark.parametrize("head_dim,grid", [(128, (3, 30, 52)), (12, (3, 4, 4)), (64, (1, 2, 6))],
                         ids=["d128-480x832", "d12", "d64-one-frame"])
def test_wan_rope_tables(head_dim, grid):
    """Axis split (d − 4⌊d/6⌋, 2⌊d/6⌋, 2⌊d/6⌋); the tables are numpy on both sides: equal."""
    f, h, w = grid
    ref = jax_wan_rope(WanTransformerConfig(attention_head_dim=head_dim), f, 2 * h, 2 * w)
    out = wan_rope(TCfg(attention_head_dim=head_dim), f, 2 * h, 2 * w)
    for a, b in zip(out, ref):
        assert a.shape == (f * h * w, head_dim) and a.dtype == np.float32
        np.testing.assert_array_equal(a, np.asarray(b))


# -- UniPC ---------------------------------------------------------------------

_PLAN_FIELDS = ("timesteps", "sigmas", "p_cx", "p_cm0", "p_cd", "c_mask", "c_cx", "c_cm0", "c_cd", "c_ct")


@pytest.mark.parametrize("cfg_kw,steps", [
    (dict(flow_shift=5.0), 6), (dict(flow_shift=5.0), 50), (dict(flow_shift=3.0, solver_order=1), 6),
    (dict(flow_shift=5.0, lower_order_final=False), 6), (dict(flow_shift=1.0, solver_type="bh1"), 4),
    (dict(flow_shift=5.0, solver_order=3), 7),
], ids=["order2-6", "order2-50", "order1", "no-lower-order-final", "bh1", "order3"])
def test_unipc_plan_tables_equal(cfg_kw, steps):
    ref = JU.make_unipc_plan(JU.UniPCConfig(**cfg_kw), steps)
    out = U.make_unipc_plan(U.UniPCConfig(**cfg_kw), steps)
    for name in _PLAN_FIELDS:
        a, b = getattr(out, name), np.asarray(getattr(ref, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert out.timesteps.dtype == np.int64 and out.solver_order == ref.solver_order


@pytest.mark.parametrize("cfg_kw", [
    dict(flow_shift=5.0), dict(flow_shift=5.0, solver_order=1), dict(flow_shift=5.0, lower_order_final=False),
    dict(flow_shift=2.0, solver_order=3),
], ids=["order2", "order1", "no-lower-order-final", "order3"])
def test_unipc_six_step_trajectory(cfg_kw):
    """Six steps on seeded model outputs: every sample and the carried
    state agree with the JAX scheduler (atol 1e-5)."""
    jplan, plan = JU.make_unipc_plan(JU.UniPCConfig(**cfg_kw), 6), U.make_unipc_plan(U.UniPCConfig(**cfg_kw), 6)
    x = _rand(2, 4, 3, 4, 4, seed=5)
    jx, jstate = jnp.asarray(x), JU.unipc_init_state(jplan, x.shape)
    tx = torch.from_numpy(x)
    tstate = U.unipc_init_state(plan, tx)
    for i in range(6):
        v = _rand(*x.shape, seed=10 + i)
        jx, jstate = JU.unipc_step(jplan, i, jnp.asarray(v), jx, jstate)
        tx, tstate = U.unipc_step(plan, i, torch.from_numpy(v), tx, tstate)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=OP_ATOL, rtol=0, err_msg=f"step {i}")
        np.testing.assert_allclose(tstate.last_sample.numpy(), np.asarray(jstate.last_sample), atol=OP_ATOL, rtol=0)
        for a, b in zip(tstate.m, jstate.m):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=OP_ATOL, rtol=0)
    assert tx.dtype == torch.float32


def test_unipc_refuses_non_flow_sigmas():
    with pytest.raises(NotImplementedError):
        U.make_unipc_plan(U.UniPCConfig(use_flow_sigmas=False), 4)


# -- UMT5, CLIP ----------------------------------------------------------------


@pytest.mark.parametrize("masked", [True, False], ids=["prefix-mask", "no-mask"])
def test_umt5_forward(tiny, masked):
    """One bias table per block; the mask becomes ``kv_len``. The rows past
    a prompt's length attend to the prefix too, so every row compares."""
    (_, _, t5cfg, _), (_, _, t5p, _) = tiny
    assert all("relative_attention_bias" in b["attn"] for b in t5p["blocks"])
    ids, mask = tokenize_mask_stub(["hello world", "", "abcdefgh ij"], 16)
    ref = t5_encode(t5p, t5cfg, jnp.asarray(ids), jnp.asarray(mask) if masked else None)
    t5 = port_module("t5", t5cfg, t5p)
    with torch.no_grad():
        out = t5(torch.from_numpy(ids).long(), torch.from_numpy(mask).long() if masked else None)
    assert out.shape == (3, 16, t5cfg.d_model)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=FWD_ATOL, rtol=0)


def test_umt5_blocks_use_their_own_bias_table(tiny):
    (_, _, t5cfg, _), (_, _, t5p, _) = tiny
    t5 = port_module("t5", t5cfg, t5p)
    ids = torch.from_numpy(tokenize_mask_stub(["hello world"], 16)[0]).long()
    with torch.no_grad():
        a = t5(ids)
        t5.blocks[1].attn.relative_attention_bias.weight.add_(1.0 * torch.arange(t5cfg.num_heads))
        t5.blocks[1].attn.relative_attention_bias.weight[0] += 3.0
        b = t5(ids)
    assert (a - b).abs().max() > 1e-4


def test_clip_vision_all_hidden_states(tiny):
    (_, _, _, ccfg), (_, _, _, cp) = tiny
    px = _rand(2, 3, 28, 28, seed=3)
    ref = clip_vision_hidden_states(cp, ccfg, jnp.asarray(px))
    clip = port_module("clip", ccfg, cp)
    with torch.no_grad():
        out = clip(torch.from_numpy(px))
    assert len(out) == len(ref) == ccfg.num_hidden_layers + 1
    for a, b in zip(out, ref):
        assert a.shape == (2, 5, ccfg.hidden_size)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=FWD_ATOL, rtol=0)


def test_clip_preprocess_matches():
    from alg_tpu.models.clip import clip_preprocess as jax_pre

    from alg_tpu_torch.models.clip import clip_preprocess

    img = np.random.RandomState(0).uniform(-1, 1, (1, 3, 40, 56)).astype(np.float32)
    out, ref = clip_preprocess(img, 28), jax_pre(img, 28)
    assert out.shape == (1, 3, 28, 28) and out.dtype == np.float32
    np.testing.assert_array_equal(out, ref)


# -- Wan DiT -------------------------------------------------------------------


def _dit_inputs(tcfg, b=2, f=3, hw=4, seed=0):
    r = np.random.RandomState(seed)
    x = r.randn(b, tcfg.in_channels, f, hw, hw).astype(np.float32)
    ts = np.array([900.0, 300.0, 17.0][:b], np.float32)
    text = r.randn(b, 7, tcfg.text_dim).astype(np.float32)
    img = None if tcfg.image_dim is None else r.randn(b, 5, tcfg.image_dim).astype(np.float32)
    return x, ts, text, img


@pytest.mark.parametrize("over", [dict(), dict(image_dim=None), dict(attention_head_dim=128, num_attention_heads=1),
                                  dict(attention_head_dim=16, num_attention_heads=2, num_layers=3)],
                         ids=["image-stream", "no-image-stream", "head-dim-128", "three-layers"])
def test_wan_dit_forward(tiny, over):
    tcfg = dataclasses.replace(tiny[0][0], **over)
    tp = tiny[1][0] if not over else random_tree(lambda k: init_wan_transformer(k, tcfg), 21)
    x, ts, text, img = _dit_inputs(tcfg)
    cos, sin = jax_wan_rope(tcfg, 3, 4, 4)
    ref = wan_transformer(tp, tcfg, jnp.asarray(x), jnp.asarray(ts), jnp.asarray(text),
                          None if img is None else jnp.asarray(img), cos, sin)
    dit = port_module("wan_dit", tcfg, tp)
    with torch.no_grad():
        out = dit(torch.from_numpy(x), torch.from_numpy(ts), torch.from_numpy(text),
                  None if img is None else torch.from_numpy(img), torch.from_numpy(cos), torch.from_numpy(sin))
    assert out.shape == (2, tcfg.out_channels, 3, 4, 4)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=FWD_ATOL, rtol=0)


def test_wan_dit_counts_kernel_calls_only_on_the_card(tiny):
    """On the CPU the wrappers run their plain versions and count nothing."""
    from alg_tpu_torch.ops.flash_attention import flash_attention
    from alg_tpu_torch.ops.rope import rope_interleaved

    tcfg, tp = tiny[0][0], tiny[1][0]
    x, ts, text, img = _dit_inputs(tcfg, b=1)
    cos, sin = wan_rope(port_module("wan_dit", tcfg, tp).cfg, 3, 4, 4)
    before = (rope_interleaved.launches, flash_attention.launches)
    with torch.no_grad():
        port_module("wan_dit", tcfg, tp)(*(torch.from_numpy(a) for a in (x, ts, text, img, cos, sin)))
    assert (rope_interleaved.launches, flash_attention.launches) == before


# -- Wan VAE -------------------------------------------------------------------


@pytest.mark.parametrize("frames", [5, 1, 9], ids=["5-frames", "single-frame", "9-frames"])
def test_wan_vae_encode(tiny, frames):
    vcfg, vp = tiny[0][1], tiny[1][1]
    v = np.random.RandomState(frames).uniform(-1, 1, (1, frames, 16, 16, 3)).astype(np.float32)
    mean, logvar = wan_vae_encode(vp, vcfg, jnp.asarray(v))
    vae = port_module("wan_vae", vcfg, vp)
    with torch.no_grad():
        tm, tlv = vae.encode(torch.from_numpy(v))
    assert tm.shape == tlv.shape == (1, (frames - 1) // 4 + 1, 2, 2, vcfg.z_dim)
    np.testing.assert_allclose(tm.numpy(), np.asarray(mean), atol=FWD_ATOL, rtol=0)
    np.testing.assert_allclose(tlv.numpy(), np.asarray(logvar), atol=FWD_ATOL, rtol=0)


@pytest.mark.parametrize("lat_frames", [3, 1], ids=["3-latent-frames", "single-frame"])
def test_wan_vae_decode(tiny, lat_frames):
    vcfg, vp = tiny[0][1], tiny[1][1]
    z = _rand(2, lat_frames, 3, 2, vcfg.z_dim, seed=4)
    ref = wan_vae_decode(vp, vcfg, jnp.asarray(z))
    vae = port_module("wan_vae", vcfg, vp)
    with torch.no_grad():
        out = vae.decode(torch.from_numpy(z))
    assert out.shape == (2, 4 * lat_frames - 3, 24, 16, 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=FWD_ATOL, rtol=0)


def test_wan_vae_tiled_encode_matches_tiled_encode(tiny):
    """A 40x56 clip in 32-pixel tiles at stride 24 (2 x 3 tiles, ragged
    edges), the mean only, as the pipeline encodes its condition video. The
    reference encoder is jitted: one compile a tile shape, where op-by-op
    dispatch compiles each of its ops at each."""
    import jax

    vcfg, vp = tiny[0][1], tiny[1][1]
    v = np.random.RandomState(8).uniform(-1, 1, (1, 5, 40, 56, 3)).astype(np.float32)
    ref = JT.tiled_encode(jax.jit(lambda xt: wan_vae_encode(vp, vcfg, xt)[0]), jnp.asarray(v), vcfg.spatial_scale,
                          tile_px=32, stride_px=24)
    vae = port_module("wan_vae", vcfg, vp)
    with one_torch_thread(), torch.no_grad():
        (out,) = T.tiled_encode(lambda xt: vae.encode(xt)[:1], torch.from_numpy(v), vcfg.spatial_scale,
                                tile_px=32, stride_px=24)
    assert out.shape == (1, 2, 5, 7, vcfg.z_dim)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=FWD_ATOL, rtol=0)


@pytest.mark.parametrize("args", [(9, 480, 832, None), (1, 720, 1280, None), (5, 480, 832, None),
                                  (1, 64, 64, True), (81, 480, 832, False)],
                         ids=["9f-480p", "single-frame-720p", "5f-480p", "forced-on", "forced-off"])
def test_auto_tile_encode_policy(args):
    assert T.auto_tile_encode(*args) == JT.auto_tile_encode(*args)


# -- weights bridge --------------------------------------------------------------


def test_bridge_names_wan_leaves(tiny):
    from alg_tpu_torch.io.jax_params import flatten_jax_tree

    (tcfg, vcfg, t5cfg, ccfg), (tp, vp, t5p, cp) = tiny
    dit = dict(flatten_jax_tree(tp))
    assert dit["scale_shift_table"].shape == (2, tcfg.inner_dim)
    assert dit["blocks.1.scale_shift_table"].shape == (6, tcfg.inner_dim)
    assert not any(k.startswith("norm_out") for k in dit)  # the empty dict holds nothing
    vae = dict(flatten_jax_tree(vp))
    assert vae["encoder.down.0.resnets.0.norm1.gamma"].shape == (8,)
    assert vae["encoder.down.0.downsample.conv.weight"].shape == (8, 8, 3, 3)  # HWIO -> OIHW
    assert vae["encoder.down.1.downsample.time_conv.weight"].shape == (16, 16, 3, 1, 1)  # DHWIO -> OIDHW
    clip = dict(flatten_jax_tree(cp))
    assert clip["class_embedding"].shape == (10,) and clip["position_embedding"].shape == (5, 10)
    assert clip["patch_embedding.weight"].shape == (10, 3, 14, 14) and "patch_embedding.bias" not in clip
    t5 = dict(flatten_jax_tree(t5p))
    assert all(f"blocks.{i}.attn.relative_attention_bias.weight" in t5 for i in range(t5cfg.num_layers))


@pytest.mark.parametrize("kind,idx,drop", [("wan_dit", 0, "scale_shift_table"), ("wan_vae", 1, "quant_conv"),
                                           ("clip", 3, "class_embedding"), ("wan_dit", 0, "+extra")],
                         ids=["dit-missing-table", "vae-missing-conv", "clip-missing-class", "dit-unused-key"])
def test_bridge_rejects_mismatched_wan_trees(tiny, kind, idx, drop):
    cfg, tree = tiny[0][idx], dict(tiny[1][idx])
    if drop == "+extra":
        tree["extra"] = {"kernel": np.zeros((2, 2), np.float32)}
    else:
        del tree[drop]
    with pytest.raises(KeyError, match="parameter trees differ"):
        port_module(kind, cfg, tree)


def test_init_random_fills_tables():
    """``init_random_`` draws the plain tables (N(0, init_std²)) and leaves
    the norm scales at 1."""
    from alg_tpu_torch.models.clip import CLIPVisionConfig, CLIPVisionModel
    from alg_tpu_torch.models.wan.transformer import WanTransformer
    from alg_tpu_torch.models.wan.vae import WanVAE, WanVAEConfig

    gen = torch.Generator().manual_seed(0)
    dit = L.init_random_(WanTransformer(TCfg(num_attention_heads=2, attention_head_dim=64, num_layers=1, ffn_dim=32,
                                             text_dim=8, image_dim=10)), gen)
    assert 0.5 < dit.scale_shift_table.std() * 128 ** 0.5 < 1.5
    assert 0.5 < dit.blocks[0].scale_shift_table.std() * 128 ** 0.5 < 1.5
    clip = L.init_random_(CLIPVisionModel(CLIPVisionConfig(hidden_size=64, intermediate_size=64,
                                                           num_hidden_layers=1, num_attention_heads=2,
                                                           image_size=28)), gen)
    assert 0.01 < clip.position_embedding.std() < 0.03 and clip.class_embedding.abs().max() > 0
    vae = L.init_random_(WanVAE(WanVAEConfig(base_dim=8, z_dim=4, dim_mult=(1, 2), num_res_blocks=1,
                                             temperal_downsample=(True,))), gen)
    assert torch.equal(vae.encoder.norm_out.gamma, torch.ones(16))
