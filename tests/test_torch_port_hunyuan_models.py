"""The modules of the port's HunyuanVideo slice against the JAX package on
the CPU in fp32, with the same seeded weights carried across by the port's
weights bridge: half-split RoPE, per-head RMS norm, the flow-match Euler
scheduler, aspect-ratio bucketing, the CLIP text model, Llama and Llava, the
Hunyuan DiT and the Hunyuan VAE.

The JAX side's attention takes ``_xla_attention`` on the CPU (its Pallas
flash kernel does not lower there), and its ``rope_interleaved`` the XLA
composition, as in the JAX package's own CPU tests.

Tolerances: single ops and scheduler steps atol 1e-5 (same fp32 ops, other
summation order); whole forwards atol 1e-4, since the order differences of
many matmuls, norms and convolutions compound over the layers. The sigma and
timestep tables come from the same float64 numpy code and must be equal bit
for bit."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from alg_tpu.alg import hunyuan_size as JS
from alg_tpu.models import layers as JL
from alg_tpu.models import rope as JR
from alg_tpu.models import vae_tiling as JT
from alg_tpu.models.clip import clip_text_encode
from alg_tpu.models.hunyuan import hunyuan_rope as jax_hunyuan_rope
from alg_tpu.models.hunyuan import hunyuan_transformer, hunyuan_vae_decode, hunyuan_vae_encode
from alg_tpu.models.hunyuan import init_hunyuan_transformer
from alg_tpu.models.llama import llama_hidden_states, llava_hidden_states, llava_image_features
from alg_tpu.schedulers import flow_match_euler as JF

from alg_tpu_torch.alg import hunyuan_size as S
from alg_tpu_torch.models import layers as L
from alg_tpu_torch.models import rope as R
from alg_tpu_torch.models import vae_tiling as T
from alg_tpu_torch.models.hunyuan.transformer import HunyuanVideoTransformerConfig as TCfg, hunyuan_rope
from alg_tpu_torch.schedulers import flow_match_euler as F

from torch_port_common import (HY_IMG, HY_PAD, hunyuan_trees, one_torch_thread, port_module, random_tree,
                               tiny_hunyuan_configs, tokenize_clip_stub)

OP_ATOL, FWD_ATOL = 1e-5, 1e-4


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


@pytest.fixture(scope="module")
def tiny():
    cfgs = tiny_hunyuan_configs()
    return cfgs, hunyuan_trees(*cfgs)


# -- rope, norms ---------------------------------------------------------------


@pytest.mark.parametrize("d,theta", [(128, 500000.0), (8, 10000.0)], ids=["d128-llama3", "d8"])
def test_rope_half_matches_jax(d, theta):
    """Tables equal (numpy on both sides); the rotation in fp32, atol 1e-5."""
    ang = R.rope_frequencies(d, np.arange(11), theta)
    np.testing.assert_array_equal(ang, JR.rope_frequencies(d, np.arange(11), theta))
    (c, s), (jc, js) = R.cos_sin_half(ang), JR.cos_sin_half(ang)
    assert c.shape == (11, d) and c.dtype == np.float32
    np.testing.assert_array_equal(c, jc)
    np.testing.assert_array_equal(s, js)
    x = _rand(2, 3, 11, d, seed=1)
    ref = JR.apply_rope_half(jnp.asarray(x), jnp.asarray(c)[None, None], jnp.asarray(s)[None, None])
    out = R.apply_rope_half(torch.from_numpy(x), torch.from_numpy(c)[None, None], torch.from_numpy(s)[None, None])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=OP_ATOL, rtol=0)
    # computed in fp32 and cast back
    out16 = R.apply_rope_half(torch.from_numpy(x).bfloat16(), torch.from_numpy(c), torch.from_numpy(s))
    assert out16.dtype == torch.bfloat16
    np.testing.assert_array_equal(out16.float().numpy(),
                                  R.apply_rope_half(torch.from_numpy(x).bfloat16().float(), torch.from_numpy(c),
                                                    torch.from_numpy(s)).bfloat16().float().numpy())


@pytest.mark.parametrize("shape,eps", [((2, 4, 9, 128), 1e-6), ((2, 7, 32), 1e-5)], ids=["per-head-d128", "llama-eps"])
def test_rms_norm_matches_jax_rms_norm_with_offset_zero(shape, eps):
    """The port's ``RMSNorm`` is ``rms_norm(..., offset=0.0)``: fp32
    statistics, the scale applied in fp32, one cast."""
    x, w = _rand(*shape, seed=2), 1 + _rand(shape[-1], seed=3, scale=0.1)
    norm = L.RMSNorm(shape[-1], eps)
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(w))
        out = norm(torch.from_numpy(x))
    ref = JL.rms_norm({"scale": jnp.asarray(w)}, jnp.asarray(x), eps, offset=0.0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=OP_ATOL, rtol=0)


# -- flow-match Euler ----------------------------------------------------------


@pytest.mark.parametrize("cfg_kw,plan_kw", [
    (dict(shift=7.0), dict(sigmas=np.linspace(1.0, 0.0, 51)[:-1])),
    (dict(shift=7.0), dict(sigmas=np.linspace(1.0, 0.0, 5)[:-1])),
    (dict(shift=1.0), dict(sigmas=np.linspace(1.0, 0.0, 7)[:-1])),
    (dict(shift=7.0, invert_sigmas=True), dict(sigmas=np.linspace(1.0, 0.0, 7)[:-1])),
    (dict(shift=7.0), dict(num_inference_steps=6)),
    (dict(shift=1.0, invert_sigmas=True), dict(num_inference_steps=6)),
    (dict(shift=3.0, use_dynamic_shifting=True), dict(num_inference_steps=4)),
], ids=["shift7-50", "shift7-4", "shift1", "shift7-inverted", "step-count", "shift1-inverted-step-count",
        "dynamic-shifting-leaves-sigmas"])
def test_flow_match_euler_tables_equal(cfg_kw, plan_kw):
    ref = JF.make_flow_match_euler_plan(JF.FlowMatchEulerConfig(**cfg_kw), **plan_kw)
    out = F.make_flow_match_euler_plan(F.FlowMatchEulerConfig(**cfg_kw), **plan_kw)
    for name in ("timesteps", "sigmas"):
        a, b = getattr(out, name), np.asarray(getattr(ref, name))
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert len(out.sigmas) == len(out.timesteps) + 1 and out.init_noise_sigma == ref.init_noise_sigma


def test_flow_match_euler_needs_a_step_count_or_sigmas():
    with pytest.raises(ValueError, match="num_inference_steps or sigmas"):
        F.make_flow_match_euler_plan(F.FlowMatchEulerConfig())


@pytest.mark.parametrize("invert", [False, True], ids=["descending", "inverted"])
def test_flow_match_euler_six_step_trajectory(invert):
    """Six steps on seeded model outputs: every sample agrees with the JAX
    scheduler (atol 1e-5: one fp32 multiply-add a step)."""
    kw = dict(shift=7.0, invert_sigmas=invert)
    sig = np.linspace(1.0, 0.0, 7)[:-1]
    jplan = JF.make_flow_match_euler_plan(JF.FlowMatchEulerConfig(**kw), sigmas=sig)
    plan = F.make_flow_match_euler_plan(F.FlowMatchEulerConfig(**kw), sigmas=sig)
    x = _rand(2, 4, 3, 4, 4, seed=5)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    for i in range(6):
        v = _rand(*x.shape, seed=10 + i)
        jx = JF.flow_match_euler_step(jplan, i, jnp.asarray(v), jx)
        tx = F.flow_match_euler_step(plan, i, torch.from_numpy(v), tx)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=OP_ATOL, rtol=0, err_msg=f"step {i}")
    assert tx.dtype == torch.float32
    assert F.flow_match_euler_step(plan, 0, torch.from_numpy(x).bfloat16(), torch.from_numpy(x).bfloat16()).dtype \
        == torch.bfloat16


# -- bucketing -----------------------------------------------------------------


class _Image:
    """A stand-in with a PIL-style ``.size`` of (w, h)."""

    def __init__(self, w, h):
        self.size = (w, h)


@pytest.mark.parametrize("res", ["360p", "540p", "720p"])
@pytest.mark.parametrize("wh", [(1280, 720), (720, 1280), (512, 512), (641, 480), (480, 853), (1792, 1024), (100, 400)],
                         ids=lambda wh: f"{wh[0]}x{wh[1]}")
def test_hunyuan_bucket_choice_matches(res, wh):
    assert tuple(S.get_hunyuan_video_size(res, _Image(*wh))) == tuple(JS.get_hunyuan_video_size(res, _Image(*wh)))


def test_hunyuan_buckets_and_the_shipped_size():
    for base in (480, 720, 960):
        assert S.generate_crop_size_list(base, 32) == JS.generate_crop_size_list(base, 32)
    # a 1792 x 1024 landscape image in the 360p list: height 352, width 608 (the size the chip smoke runs)
    assert S.get_hunyuan_video_size("360p", _Image(1792, 1024)) == (352, 608)
    with pytest.raises(ValueError, match="Unknown i2v_resolution"):
        S.get_hunyuan_video_size("1080p", _Image(4, 3))


# -- CLIP text -----------------------------------------------------------------


def test_clip_text_hidden_state_and_pooled(tiny):
    """Causal layers, final LayerNorm, pooled at the first end-of-sequence
    token: the stub puts one in the middle of each row and one at its end,
    and a row without any pools position 0."""
    (_, _, _, ccfg), (_, _, _, cp) = tiny
    ids = tokenize_clip_stub(["a cat on a mat", "", "dog"], 10)
    ids = np.concatenate([ids, np.arange(10, dtype=np.int32)[None] + 20])  # no end-of-sequence id
    ref_h, ref_p = clip_text_encode(cp, ccfg, jnp.asarray(ids))
    clip = port_module("clip_text", ccfg, cp)
    with torch.no_grad():
        h, p = clip(torch.from_numpy(ids).long())
    assert h.shape == (4, 10, ccfg.hidden_size) and p.shape == (4, ccfg.hidden_size)
    np.testing.assert_allclose(h.numpy(), np.asarray(ref_h), atol=FWD_ATOL, rtol=0)
    np.testing.assert_allclose(p.numpy(), np.asarray(ref_p), atol=FWD_ATOL, rtol=0)
    first_eos = [int(np.argmax(row == ccfg.eos_token_id)) for row in ids]
    assert 0 < first_eos[0] < 9 and first_eos[3] == 0
    for i, pos in enumerate(first_eos):
        assert torch.equal(p[i], h[i, pos])


def test_clip_text_is_causal(tiny):
    """A change of the last token leaves the earlier positions as they were."""
    (_, _, _, ccfg), (_, _, _, cp) = tiny
    clip = port_module("clip_text", ccfg, cp)
    ids = torch.from_numpy(tokenize_clip_stub(["a cat"], 10)).long()
    other = ids.clone()
    other[0, -1] = 5
    with torch.no_grad():
        a, b = clip(ids)[0], clip(other)[0]
    assert torch.equal(a[:, :-1], b[:, :-1]) and not torch.equal(a[:, -1], b[:, -1])


# -- Llama, Llava --------------------------------------------------------------


@pytest.mark.parametrize("rope_path", ["tables", "position-ids"])
@pytest.mark.parametrize("padded", [False, True], ids=["full", "right-padded"])
def test_llama_hidden_state_list(tiny, rope_path, padded):
    """GQA 4 heads over 2 kv heads; every entry of the hidden-state list
    (the last final-normed); both rope paths; right padding as ``kv_len``.
    Under padding the rows past a prompt's length see the prefix, so every
    row compares."""
    lcfg = dataclasses.replace(tiny[0][2].text, hidden_size=32, intermediate_size=64, num_attention_heads=4,
                               num_key_value_heads=2, rms_norm_eps=1e-5)
    from alg_tpu.models.llama import init_llama

    lp = random_tree(lambda k: init_llama(k, lcfg), 41)
    ids = np.random.RandomState(4).randint(1, 120, (2, 9))
    embeds = np.asarray(lp["embed"])[ids]
    kv_len = np.asarray([9, 5], np.int32) if padded else None
    pos = None
    if rope_path == "position-ids":  # as the pipeline builds them: masked positions hold 1
        mask = np.arange(9)[None, :] < (kv_len if padded else np.asarray([9, 9]))[:, None]
        pos = np.where(mask, np.cumsum(mask, -1) - 1, 1)
    ref = llama_hidden_states(lp, lcfg, jnp.asarray(embeds), None if pos is None else jnp.asarray(pos),
                              None if kv_len is None else jnp.asarray(kv_len))
    llama = port_module("llama", lcfg, lp)
    with torch.no_grad():
        out = llama(torch.from_numpy(embeds), None if pos is None else torch.from_numpy(pos),
                    None if kv_len is None else torch.from_numpy(kv_len))
    assert len(out) == len(ref) == lcfg.num_hidden_layers + 1
    for i, (a, b) in enumerate(zip(out, ref)):
        assert a.shape == (2, 9, 32)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=FWD_ATOL, rtol=0, err_msg=f"hidden state {i}")
    with torch.no_grad():
        assert torch.equal(out[0], torch.from_numpy(embeds))
        assert torch.equal(llama.embed(torch.from_numpy(ids)), out[0])


def test_llava_scatters_the_image_span(tiny):
    """Image features (CLIP ``[-2]``, class token dropped, exact-GELU
    projector) land on the image-token span in order; the mask becomes
    ``kv_len``."""
    (_, _, lcfg, _), (_, _, lp, _) = tiny
    ids = np.array([[5, HY_IMG, HY_IMG, HY_IMG, HY_IMG, 17, 3, 2, HY_PAD, HY_PAD],
                    [9, 11, HY_IMG, HY_IMG, HY_IMG, HY_IMG, 4, 8, 6, 1]], np.int64)
    mask = (ids != HY_PAD).astype(np.int64)
    px = _rand(2, 3, 28, 28, seed=6)
    ref = llava_hidden_states(lp, lcfg, jnp.asarray(ids), jnp.asarray(px), jnp.asarray(mask))
    llava = port_module("llava", lcfg, lp)
    with torch.no_grad():
        out = llava(torch.from_numpy(ids), torch.from_numpy(px), torch.from_numpy(mask))
        feats = llava.image_features(torch.from_numpy(px))
    np.testing.assert_allclose(feats.numpy(), np.asarray(llava_image_features(lp, lcfg, jnp.asarray(px))),
                               atol=FWD_ATOL, rtol=0)
    assert feats.shape == (2, 4, lcfg.text.hidden_size)
    assert torch.equal(out[0][0, 1:5], feats[0]) and torch.equal(out[0][1, 2:6], feats[1])
    assert len(out) == lcfg.text.num_hidden_layers + 1
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=FWD_ATOL, rtol=0)


# -- Hunyuan DiT ---------------------------------------------------------------


def _dit_inputs(tcfg, b=2, f=3, hw=4, seq_t=7, seed=0):
    r = np.random.RandomState(seed)
    x = r.randn(b, tcfg.in_channels, f, hw, hw).astype(np.float32)
    ts = np.array([900.0, 300.0, 17.0][:b], np.float32)
    text = r.randn(b, seq_t, tcfg.text_embed_dim).astype(np.float32)
    pooled = r.randn(b, tcfg.pooled_projection_dim).astype(np.float32)
    return x, ts, text, pooled


@pytest.mark.parametrize("cfg_kw,grid", [(dict(), (33, 44, 76)),
                                         (dict(attention_head_dim=8, rope_axes_dim=(2, 4, 2)), (3, 4, 4))],
                         ids=["d128-129-frames-352x608", "d8"])
def test_hunyuan_rope_tables_equal(cfg_kw, grid):
    """Axes (t, h, w) of dims ``rope_axes_dim``; numpy on both sides: equal."""
    from alg_tpu.models.hunyuan import HunyuanVideoTransformerConfig as JCfg

    out, ref = hunyuan_rope(TCfg(**cfg_kw), *grid), jax_hunyuan_rope(JCfg(**cfg_kw), *grid)
    for a, b in zip(out, ref):
        assert a.shape == (grid[0] * (grid[1] // 2) * (grid[2] // 2), TCfg(**cfg_kw).attention_head_dim)
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("mode", ["padded-mask", "no-mask", "no-guidance", "t2v", "latent-concat", "head-dim-128",
                                  "two-double-two-single"])
def test_hunyuan_dit_forward(tiny, mode):
    """token_replace with a padded text mask (the joint ``kv_len``), without a
    mask, with ``guidance=None``, the T2V form (``image_condition_type``
    None: one modulation a block), the 2z + 1 input channels of
    ``latent_concat``, head dim 128, and two blocks of each kind."""
    over = {"t2v": dict(image_condition_type=None), "latent-concat": dict(in_channels=9),
            "head-dim-128": dict(num_attention_heads=1, attention_head_dim=128, rope_axes_dim=(16, 56, 56)),
            "two-double-two-single": dict(num_layers=2, num_single_layers=2, num_refiner_layers=2)}.get(mode, {})
    tcfg = dataclasses.replace(tiny[0][0], **over)
    tp = tiny[1][0] if not over else random_tree(lambda k: init_hunyuan_transformer(k, tcfg), 51)
    x, ts, text, pooled = _dit_inputs(tcfg)
    mask = None if mode == "no-mask" else np.asarray([[1] * 7, [1] * 4 + [0] * 3], np.int32)
    guidance = None if mode == "no-guidance" else np.full((2,), 6000.0, np.float32)
    cos, sin = jax_hunyuan_rope(tcfg, 3, 4, 4)
    ref = hunyuan_transformer(tp, tcfg, jnp.asarray(x), jnp.asarray(ts), jnp.asarray(text),
                              None if mask is None else jnp.asarray(mask), jnp.asarray(pooled),
                              None if guidance is None else jnp.asarray(guidance), cos, sin)
    dit = port_module("hunyuan_dit", tcfg, tp)
    with torch.no_grad():
        out = dit(torch.from_numpy(x), torch.from_numpy(ts), torch.from_numpy(text),
                  None if mask is None else torch.from_numpy(mask), torch.from_numpy(pooled),
                  None if guidance is None else torch.from_numpy(guidance), cos, sin)
    assert out.shape == (2, tcfg.out_channels, 3, 4, 4)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=FWD_ATOL, rtol=0)


def test_hunyuan_dit_padded_text_does_not_reach_the_video(tiny):
    """Text rows past a prompt's length are masked out of the refiner and of
    the joint attention: their values do not move the prediction."""
    tcfg, tp = tiny[0][0], tiny[1][0]
    x, ts, text, pooled = _dit_inputs(tcfg, b=1)
    mask = torch.tensor([[1, 1, 1, 1, 0, 0, 0]], dtype=torch.int32)
    other = text.copy()
    other[:, 4:] += 3.0
    cos, sin = hunyuan_rope(port_module("hunyuan_dit", tcfg, tp).cfg, 3, 4, 4)
    dit = port_module("hunyuan_dit", tcfg, tp)
    with torch.no_grad():
        a = dit(*(torch.from_numpy(v) for v in (x, ts, text)), mask, torch.from_numpy(pooled), None, cos, sin)
        b = dit(*(torch.from_numpy(v) for v in (x, ts, other)), mask, torch.from_numpy(pooled), None, cos, sin)
        c = dit(*(torch.from_numpy(v) for v in (x, ts, other)), None, torch.from_numpy(pooled), None, cos, sin)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=0)
    assert (a - c).abs().max() > 1e-4


def test_hunyuan_dit_counts_kernel_calls_only_on_the_card(tiny):
    """On the CPU the wrappers run their plain versions and count nothing."""
    from alg_tpu_torch.ops.flash_attention import flash_attention
    from alg_tpu_torch.ops.rope import rope_interleaved

    tcfg, tp = tiny[0][0], tiny[1][0]
    x, ts, text, pooled = _dit_inputs(tcfg, b=1)
    dit = port_module("hunyuan_dit", tcfg, tp)
    cos, sin = hunyuan_rope(dit.cfg, 3, 4, 4)
    before = (rope_interleaved.launches, flash_attention.launches)
    with torch.no_grad():
        dit(*(torch.from_numpy(v) for v in (x, ts, text)), None, torch.from_numpy(pooled), None, cos, sin)
    assert (rope_interleaved.launches, flash_attention.launches) == before


# -- Hunyuan VAE ---------------------------------------------------------------


@pytest.mark.parametrize("frames", [1, 5], ids=["single-frame", "5-frames"])
def test_hunyuan_vae_encode(tiny, frames):
    vcfg, vp = tiny[0][1], tiny[1][1]
    v = np.random.RandomState(frames).uniform(-1, 1, (1, frames, 16, 16, 3)).astype(np.float32)
    mean, logvar = hunyuan_vae_encode(vp, vcfg, jnp.asarray(v))
    vae = port_module("hunyuan_vae", vcfg, vp)
    with torch.no_grad():
        tm, tlv = vae.encode(torch.from_numpy(v))
    assert tm.shape == tlv.shape == (1, (frames - 1) // 4 + 1, 2, 2, vcfg.latent_channels)
    np.testing.assert_allclose(tm.numpy(), np.asarray(mean), atol=FWD_ATOL, rtol=0)
    np.testing.assert_allclose(tlv.numpy(), np.asarray(logvar), atol=FWD_ATOL, rtol=0)


@pytest.mark.parametrize("lat_frames", [1, 2], ids=["single-frame", "2-latent-frames"])
def test_hunyuan_vae_decode(tiny, lat_frames):
    vcfg, vp = tiny[0][1], tiny[1][1]
    z = _rand(2, lat_frames, 3, 2, vcfg.latent_channels, seed=4)
    ref = hunyuan_vae_decode(vp, vcfg, jnp.asarray(z))
    vae = port_module("hunyuan_vae", vcfg, vp)
    with torch.no_grad():
        out = vae.decode(torch.from_numpy(z))
    assert out.shape == (2, 4 * lat_frames - 3, 24, 16, 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=FWD_ATOL, rtol=0)


def test_hunyuan_vae_tiled_decode_matches_tiled_decode(tiny):
    """A 5 x 7 latent frame in 4-latent tiles at stride 3 (2 x 3 tiles,
    ragged edges), blended as the JAX package blends them. The reference
    decoder is jitted: one compile a tile shape, where op-by-op dispatch
    compiles each of its ops at each (the temporal decode is
    ``test_hunyuan_vae_decode``'s)."""
    import jax

    vcfg, vp = tiny[0][1], tiny[1][1]
    z = _rand(1, 1, 5, 7, vcfg.latent_channels, seed=8)
    ref = JT.tiled_decode(jax.jit(lambda zt: hunyuan_vae_decode(vp, vcfg, zt)), jnp.asarray(z), vcfg.spatial_scale,
                          tile_latent=4, stride_latent=3)
    vae = port_module("hunyuan_vae", vcfg, vp)
    with one_torch_thread(), torch.no_grad():
        out = T.tiled_decode(vae.decode, torch.from_numpy(z), vcfg.spatial_scale, tile_latent=4, stride_latent=3)
    assert out.shape == (1, 1, 40, 56, 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=FWD_ATOL, rtol=0)


# -- weights bridge --------------------------------------------------------------


def test_bridge_names_hunyuan_leaves(tiny):
    from alg_tpu_torch.io.jax_params import flatten_jax_tree

    (tcfg, vcfg, lcfg, ccfg), (tp, vp, lp, cp) = tiny
    dim = tcfg.inner_dim
    dit = dict(flatten_jax_tree(tp))
    # the weight-stacked containers are unstacked; the refiner's list of blocks is indexed
    assert dit["transformer_blocks.0.norm1_linear.weight"].shape == (6 * dim, dim)
    assert dit["transformer_blocks.0.attn.add_q_proj.weight"].shape == (dim, dim)
    assert dit["transformer_blocks.0.attn.norm_added_k.weight"].shape == (tcfg.attention_head_dim,)
    assert dit["single_transformer_blocks.0.proj_out.weight"].shape == (dim, dim + int(dim * tcfg.mlp_ratio))
    assert dit["single_transformer_blocks.0.norm_linear.bias"].shape == (3 * dim,)
    assert dit["context_embedder.blocks.0.ada.weight"].shape == (2 * dim, dim)
    assert dit["time_text_embed.guidance_embedder.linear_1.weight"].shape == (dim, 256)
    assert not any(".blocks.1." in k or "transformer_blocks.1." in k for k in dit)
    vae = dict(flatten_jax_tree(vp))
    assert vae["encoder.down.0.downsample.conv.weight"].shape == (8, 8, 3, 3, 3)  # DHWIO -> OIDHW
    assert vae["quant_conv.weight"].shape == (8, 8, 1, 1, 1)
    llava = dict(flatten_jax_tree(lp))
    assert llava["language_model.embed.weight"].shape == (lcfg.text.vocab_size, lcfg.text.hidden_size)
    assert llava["language_model.blocks.2.k.weight"].shape == (6, 12) and "language_model.blocks.2.k.bias" not in llava
    assert llava["vision_tower.position_embedding"].shape == (5, 8)
    clip = dict(flatten_jax_tree(cp))
    assert clip["token_embedding.weight"].shape == (ccfg.vocab_size, ccfg.hidden_size)
    assert clip["position_embedding"].shape == (ccfg.max_position_embeddings, ccfg.hidden_size)


@pytest.mark.parametrize("kind,idx,drop", [("hunyuan_dit", 0, "single_transformer_blocks"),
                                           ("hunyuan_vae", 1, "post_quant_conv"), ("llava", 2, "projector"),
                                           ("clip_text", 3, "token_embedding"), ("hunyuan_dit", 0, "+extra")],
                         ids=["dit-missing-single-blocks", "vae-missing-conv", "llava-missing-projector",
                              "clip-text-missing-embedding", "dit-unused-key"])
def test_bridge_rejects_mismatched_hunyuan_trees(tiny, kind, idx, drop):
    cfg, tree = tiny[0][idx], dict(tiny[1][idx])
    if drop == "+extra":
        tree["extra"] = {"kernel": np.zeros((2, 2), np.float32)}
    else:
        del tree[drop]
    with pytest.raises(KeyError, match="parameter trees differ"):
        port_module(kind, cfg, tree)


def test_bridge_rejects_a_dit_without_the_guidance_embedder_it_expects(tiny):
    """``guidance_embeds=False`` builds no guidance embedder on either side;
    a tree that has one does not fit a module that has none."""
    tcfg, tp = tiny[0][0], tiny[1][0]
    no_guidance = dataclasses.replace(tcfg, guidance_embeds=False)
    with pytest.raises(KeyError, match="unused"):
        port_module("hunyuan_dit", no_guidance, tp)
    tree = random_tree(lambda k: init_hunyuan_transformer(k, no_guidance), 52)
    dit = port_module("hunyuan_dit", no_guidance, tree)
    assert not hasattr(dit.time_text_embed, "guidance_embedder")
    with pytest.raises(ValueError, match="does not fit"):
        port_module("hunyuan_dit", dataclasses.replace(tcfg, mlp_ratio=3.0), tp)


def test_init_random_fills_hunyuan_modules():
    """``init_random_`` draws embeddings and tables N(0, 0.02²) and leaves
    the per-head norm scales at 1."""
    from alg_tpu_torch.models.clip import CLIPTextConfig, CLIPTextModel
    from alg_tpu_torch.models.hunyuan.transformer import HunyuanVideoTransformer
    from alg_tpu_torch.models.llama import LlamaConfig, LlamaModel

    gen = torch.Generator().manual_seed(0)
    dit = L.init_random_(HunyuanVideoTransformer(TCfg(num_attention_heads=2, attention_head_dim=64, num_layers=1,
                                                      num_single_layers=1, num_refiner_layers=1, text_embed_dim=8,
                                                      pooled_projection_dim=6, rope_axes_dim=(16, 24, 24))), gen)
    assert torch.equal(dit.transformer_blocks[0].attn.norm_added_q.weight, torch.ones(64))
    assert 0.5 < dit.single_transformer_blocks[0].proj_out.weight.std() * (128 + 512) ** 0.5 < 1.5
    llama = L.init_random_(LlamaModel(LlamaConfig(vocab_size=512, hidden_size=32, intermediate_size=64,
                                                  num_hidden_layers=1, num_attention_heads=2,
                                                  num_key_value_heads=1)), gen)
    assert 0.01 < llama.embed.weight.std() < 0.03 and llama.blocks[0].q.bias is None
    clip = L.init_random_(CLIPTextModel(CLIPTextConfig(vocab_size=256, hidden_size=32, intermediate_size=64,
                                                       num_hidden_layers=1, num_attention_heads=2)), gen)
    assert 0.01 < clip.token_embedding.weight.std() < 0.03 and 0.01 < clip.position_embedding.std() < 0.03
