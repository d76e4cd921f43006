"""The port's HunyuanVideo pipeline end to end against ``alg_tpu``'s
``HunyuanVideoPipeline.__call__`` on the CPU in fp32: the same tiny weights
(carried by the port's bridge), seed, image and prompt embeddings (or, in
one run, tokenizer stubs in front of a tiny Llava and CLIP text model),
through the argmax VAE encode, the flow-match Euler sampler in each of its
modes and the VAE decode.

The configs are those of the JAX package's tiny Hunyuan pipeline (DiT head
dim 8, one block of each kind), at the golden test's size: 32x32, 9 frames,
4 steps, interval [0, 0.4] (steps 0 and 1 filtered). Bounds are the goldens'
(``tests/test_minipipeline_wan_golden.py:303-308``): final latents within
atol 2e-3 + rtol 1e-4 and decoded frames above 40 dB PSNR: the fp32
differences of summation order compound over the sampler's steps."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_port_common import (HY_DRT, HY_IMG, HY_PAD, HY_TEMPLATE, build_hunyuan_pair, hunyuan_trees, one_thread,
                               port_module, psnr, tiny_hunyuan_configs)

LATENT_ATOL, LATENT_RTOL, MIN_PSNR_DB = 2e-3, 1e-4, 40.0
HEIGHT = WIDTH = 32


ALG_KW = dict(use_low_pass_guidance=True, lp_filter_type="down_up", lp_filter_in_latent=True, lp_resize_factor=0.625,
              lp_strength_schedule_type="interval", schedule_interval_start_time=0.0,
              schedule_interval_end_time=0.4)


@pytest.fixture(scope="module")
def pair():
    return build_hunyuan_pair()


def _inputs():
    r = np.random.RandomState(17)
    pe, ne = (r.randn(1, 7, 12).astype(np.float32) for _ in range(2))
    pooled, npooled = (r.randn(1, 6).astype(np.float32) for _ in range(2))
    mask, nmask = np.ones((1, 7), np.int32), np.ones((1, 7), np.int32)
    mask[0, 5:] = 0
    image = r.uniform(-1, 1, (1, 3, HEIGHT, WIDTH)).astype(np.float32)
    return image, dict(prompt_embeds=pe, pooled_prompt_embeds=pooled, prompt_attention_mask=mask), \
        dict(negative_prompt_embeds=ne, negative_pooled_prompt_embeds=npooled, negative_prompt_attention_mask=nmask)


def _run_both(pair, true_cfg=1.0, **over):
    jpipe, tpipe = pair
    image, pos, neg = _inputs()
    embeds = {**pos, **(neg if true_cfg > 1.0 else {})}
    kw = dict(image=image, height=HEIGHT, width=WIDTH, num_frames=9, num_inference_steps=4, guidance_scale=6.0,
              true_cfg_scale=true_cfg, seed=42, output_type="latent")
    kw.update(over)
    ref = np.asarray(jpipe(**kw, **{k: jnp.asarray(v) for k, v in embeds.items()}))
    out = tpipe(**kw, **{k: torch.from_numpy(v) for k, v in embeds.items()})
    return ref, out


def _assert_frames_agree(pair, ref, out):
    """Each package decodes its own latents."""
    jpipe, tpipe = pair
    ref_frames = np.asarray(jpipe.decode_latents(jnp.asarray(ref)))
    out_frames = tpipe.decode_latents(torch.from_numpy(out)).numpy()
    assert out_frames.shape == ref_frames.shape == (1, 3, 4 * ref.shape[2] - 3, HEIGHT, WIDTH)
    to01 = lambda v: np.clip(v / 2 + 0.5, 0, 1)
    assert psnr(to01(out_frames), to01(ref_frames)) > MIN_PSNR_DB


@pytest.mark.parametrize("kw", [
    dict(**ALG_KW),
    dict(),
    dict(true_cfg=2.0, **ALG_KW),
    dict(true_cfg=2.0, lp_on_noisy_latent=True, **ALG_KW),
    dict(true_cfg=2.0),
    dict(i2v_stable=False, **ALG_KW),
    dict(true_cfg=2.0, **{**ALG_KW, "lp_strength_schedule_type": "exponential"}, num_inference_steps=3),
], ids=["alg-single-pass", "noalg", "truecfg-alg-3pass-then-2pass", "truecfg-lp-on-noisy-latent", "truecfg-noalg",
        "not-i2v-stable", "exponential-schedule"])
def test_hunyuan_pipeline_matches_alg_tpu(pair, kw):
    """The shipped single-pass ALG (the filtered first-frame latent replaces
    the clean one), ALG off, true CFG with ALG (two 3-pass steps, then two
    2-pass), its ``lp_on_noisy_latent`` form (2-pass throughout), true CFG
    alone, no ``i2v_stable`` blend, and an exponential schedule (no 2-pass
    shortcut: every step 3-pass)."""
    ref, out = _run_both(pair, **kw)
    assert out.shape == ref.shape == (1, 4, 3, 4, 4)
    np.testing.assert_allclose(out, ref, atol=LATENT_ATOL, rtol=LATENT_RTOL)
    _assert_frames_agree(pair, ref, out)


def test_hunyuan_latent_concat_matches_alg_tpu():
    """Channels [latents, condition latents, mask] into a DiT of 2z + 1 input
    channels, a full scheduler step, the first latent frame dropped from the
    latent output and the first 4 pixel frames from the decoded one."""
    pair = build_hunyuan_pair(in_channels=9)
    ref, out = _run_both(pair, image_condition_type="latent_concat", **ALG_KW)
    assert out.shape == ref.shape == (1, 4, 2, 4, 4)
    np.testing.assert_allclose(out, ref, atol=LATENT_ATOL, rtol=LATENT_RTOL)
    _assert_frames_agree(pair, ref, out)
    image, pos, _ = _inputs()
    kw = dict(image=image, height=HEIGHT, width=WIDTH, num_frames=9, num_inference_steps=2, seed=42,
              image_condition_type="latent_concat", **ALG_KW)
    ref_v = pair[0](output_type="np", **kw, **{k: jnp.asarray(v) for k, v in pos.items()})
    out_v = pair[1](output_type="np", **kw, **{k: torch.from_numpy(v) for k, v in pos.items()})
    assert out_v.shape == np.asarray(ref_v).shape == (1, 5, HEIGHT, WIDTH, 3)
    assert psnr(out_v, np.asarray(ref_v)) > MIN_PSNR_DB
    with pytest.raises(ValueError, match="latent_concat needs a transformer"):
        build_hunyuan_pair()[1](output_type="latent", **kw, **{k: torch.from_numpy(v) for k, v in pos.items()})


@pytest.fixture(scope="module")
def encoder_pair():
    return build_hunyuan_pair(with_encoders=True)


def test_hunyuan_pipeline_through_encode_prompt(encoder_pair):
    """Prompt and negative prompt through ``encode_prompt``: tokenizer stubs,
    the tiny Llava over the expanded ``<image>`` span (the negative against a
    black image), the crop and interleave, the CLIP pooled text; then true
    CFG with ALG, so the 2- and 3-pass steps run on these embeddings."""
    jpipe, tpipe = encoder_pair
    image = _inputs()[0]
    kw = dict(image=image, prompt="a cat on a mat", negative_prompt="blurry", height=HEIGHT, width=WIDTH,
              num_frames=9, num_inference_steps=4, guidance_scale=6.0, true_cfg_scale=2.0, seed=42,
              prompt_template=HY_TEMPLATE, max_sequence_length=20, output_type="latent", **ALG_KW)
    ref, out = np.asarray(jpipe(**kw)), tpipe(**kw)
    assert out.shape == ref.shape == (1, 4, 3, 4, 4)
    np.testing.assert_allclose(out, ref, atol=LATENT_ATOL, rtol=LATENT_RTOL)
    _assert_frames_agree(encoder_pair, ref, out)


@pytest.mark.parametrize("prompts", [["a cat on a mat"], ["a cat on a mat", "dog", ""]], ids=["one", "three"])
def test_hunyuan_encode_prompt_matches(encoder_pair, prompts):
    """Embeds atol 1e-4 (a whole Llava forward), the mask equal, the pooled
    CLIP text atol 1e-4; CLIP's length clamped to its position table."""
    jpipe, tpipe = encoder_pair
    image = _inputs()[0]
    ref = jpipe.encode_prompt(image, prompts, template=HY_TEMPLATE, max_sequence_length=20)
    out = tpipe.encode_prompt(image, prompts, template=HY_TEMPLATE, max_sequence_length=20)
    n = len(prompts)
    # 2 interleaved image rows + 20 text rows less the 4 of the assistant span
    assert out[0].shape == (n, 18, 12) and out[1].shape == (n, 6) and out[2].shape == (n, 18)
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]), atol=1e-4, rtol=0)
    np.testing.assert_allclose(out[1].numpy(), np.asarray(ref[1]), atol=1e-4, rtol=0)
    assert out[2].dtype == torch.int32 and np.array_equal(out[2].numpy(), np.asarray(ref[2]))
    assert 2 < int(out[2][0].sum()) < 18  # the padded tail is masked


def test_hunyuan_image_processor_hook(encoder_pair):
    """The image processor is a pipeline field: a hook gets (image, size)
    and its pixel values go to the vision tower; by default it is
    ``clip_preprocess``."""
    import dataclasses

    from alg_tpu_torch.models.clip import clip_preprocess

    _, tpipe = encoder_pair
    image = _inputs()[0]
    seen = []

    def processor(img, size):
        seen.append((img is image, size))
        return clip_preprocess(img, size)

    base = tpipe.encode_prompt(image, "a cat", template=HY_TEMPLATE, max_sequence_length=20)
    hooked = dataclasses.replace(tpipe, image_processor=processor)
    out = hooked.encode_prompt(image, "a cat", template=HY_TEMPLATE, max_sequence_length=20)
    assert seen == [(True, 28)] and torch.equal(out[0], base[0])
    other = dataclasses.replace(tpipe, image_processor=lambda img, size: np.ones((1, 3, size, size), np.float32))
    assert not torch.equal(other.encode_prompt(image, "a cat", template=HY_TEMPLATE, max_sequence_length=20)[0],
                           base[0])


# -- the prompt path's index bookkeeping on crafted token streams -----------------


def _row(max_len, image_pos, drt_positions, seed):
    """One right-padded id row with <image> / double-return at fixed positions."""
    rng = np.random.RandomState(seed)
    n_real = max(drt_positions) + 3 if drt_positions else max_len - 2
    row = rng.randint(10, 50, size=max_len).astype(np.int64)
    row[n_real:] = HY_PAD
    if image_pos is not None:
        row[image_pos] = HY_IMG
    for p in drt_positions:
        row[p] = HY_DRT
    return row, (row != HY_PAD).astype(np.int64)


# the token streams of tests/test_llava_prompt_parity.py
CASES = {
    "standard": dict(rows=[(5, [2, 9, 14, 20])], interleave=2),
    "truncated_3drt": dict(rows=[(5, [2, 9, 14])], interleave=2),  # exactly 3 double-returns: crop at the end
    "batch2": dict(rows=[(5, [2, 9, 14, 20]), (5, [3, 8, 13, 19])], interleave=4),
    "offset_image": dict(rows=[(8, [2, 12, 16, 21])], interleave=2),  # the overwrite stomps [start:end]
    "no_image": dict(rows=[(None, [2, 9, 14, 20])], interleave=2),
    "no_interleave": dict(rows=[(5, [2, 9, 14, 20])], interleave=0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_llama_prompt_embeds_bookkeeping_matches(encoder_pair, case):
    """``_get_llama_prompt_embeds`` of both packages on the same crafted ids:
    the ``<image>`` expansion with its forced overwrite, masked position ids,
    the crop with the 3-double-return quirk, the interleave. Masks equal;
    embeds atol 1e-4 (the Llava forward between the index steps)."""
    import dataclasses

    spec = CASES[case]
    template = {**HY_TEMPLATE, "image_emb_end": 11, "image_emb_len": 6}  # that test's 6-slot image block
    max_seq = 20
    rows = [_row(max_seq + template["crop_start"], ip, dp, seed=11 + i) for i, (ip, dp) in enumerate(spec["rows"])]
    ids, mask = np.stack([r for r, _ in rows]), np.stack([m for _, m in rows])
    tok = lambda prompts, max_len: (ids, mask)
    jpipe, tpipe = (dataclasses.replace(p, tokenize_llama=tok) for p in encoder_pair)
    image = (np.random.RandomState(3).rand(40, 40, 3) * 255).astype(np.uint8)
    ref_e, ref_m = jpipe._get_llama_prompt_embeds(image, ["x"] * len(rows), template, max_seq, spec["interleave"])
    with torch.no_grad():
        out_e, out_m = tpipe._get_llama_prompt_embeds(image, ["x"] * len(rows), template, max_seq,
                                                      spec["interleave"])
    assert out_e.shape == np.asarray(ref_e).shape and out_m.shape == np.asarray(ref_m).shape
    np.testing.assert_array_equal(out_m.numpy(), np.asarray(ref_m))
    np.testing.assert_allclose(out_e.numpy(), np.asarray(ref_e), atol=1e-4, rtol=0)


# -- the port's own surface ----------------------------------------------------------


def test_hunyuan_alg_changes_the_result_and_frame_zero_is_pinned(pair):
    """ALG on and off differ, so the filtered latent reaches the DiT; under
    token_replace the first latent frame of the result is the clean image
    latent whatever the mode."""
    _, tpipe = pair
    image, pos, _ = _inputs()
    pos = {k: torch.from_numpy(v) for k, v in pos.items()}
    kw = dict(image=image, height=HEIGHT, width=WIDTH, num_frames=9, num_inference_steps=4, seed=42,
              output_type="latent")
    a, b = tpipe(**kw, **pos, **ALG_KW), tpipe(**kw, **pos)
    assert np.abs(a - b).max() > 1e-3
    with torch.no_grad():
        mean = tpipe.vae.encode(torch.from_numpy(image)[:, None].permute(0, 1, 3, 4, 2))[0]
    clean = (mean.permute(0, 4, 1, 2, 3) * tpipe.vae.cfg.scaling_factor).numpy()
    np.testing.assert_array_equal(a[:, :, :1], clean)
    np.testing.assert_array_equal(b[:, :, :1], clean)
    # given latents take the place of the draw
    given = np.random.RandomState(5).randn(1, 4, 3, 4, 4).astype(np.float32)
    c = tpipe(**kw, **pos, latents=given)
    assert np.abs(c - b).max() > 1e-3


def test_hunyuan_np_output_and_unported_modes(pair):
    _, tpipe = pair
    image, pos, _ = _inputs()
    pos = {k: torch.from_numpy(v) for k, v in pos.items()}
    kw = dict(image=image, height=HEIGHT, width=WIDTH, num_frames=9, num_inference_steps=2, seed=42, **pos)
    video = tpipe(output_type="np", **kw, **ALG_KW)
    assert video.shape == (1, 9, HEIGHT, WIDTH, 3) and np.isfinite(video).all()
    assert video.min() >= 0.0 and video.max() <= 1.0
    # pixel-space ALG and PIL frames, once refused, run: pixel mode agrees with alg_tpu
    pixel = {**ALG_KW, "lp_filter_in_latent": False}
    ref, out = _run_both(pair, **pixel)
    np.testing.assert_allclose(out, ref, atol=LATENT_ATOL, rtol=LATENT_RTOL)
    frames = tpipe(output_type="pil", **kw, **ALG_KW)
    np.testing.assert_array_equal(np.stack([np.asarray(f) for f in frames[0]]),
                                  np.round(video[0] * 255).astype(np.uint8))
    with pytest.raises(ValueError, match="output_type"):
        tpipe(output_type="pt", **kw)
    with pytest.raises(ValueError, match="divisible by 16"):
        tpipe(output_type="latent", **{**kw, "height": 40})
    with pytest.raises(ValueError, match="attention_kwargs"):
        tpipe(output_type="latent", attention_kwargs={"scale": 0.5}, **kw)
    with pytest.raises(ValueError, match="image_condition_type"):
        tpipe(output_type="latent", image_condition_type="concat", **kw)
    with pytest.raises(AssertionError, match="image embeds"):
        tpipe(output_type="latent", enable_lp_img_embeds=True, **kw)
    with pytest.raises(ValueError, match="No Llava tokenizer"):
        tpipe(output_type="latent", image=image, prompt="a cat", height=HEIGHT, width=WIDTH, num_frames=9)


def test_hunyuan_decode_tiles_above_48_by_48_latents():
    """``decode_latents`` decodes in tiles once the latent exceeds 48 x 48
    (the 360p bucket's 44 x 76 does), one tile at a time, and whole below."""
    from alg_tpu_torch.pipelines.hunyuan import HunyuanVideoPipeline

    tcfg, vcfg, lcfg, ccfg = tiny_hunyuan_configs()
    tp, vp, _, _ = hunyuan_trees(tcfg, vcfg, lcfg, ccfg)
    vae = port_module("hunyuan_vae", vcfg, vp)
    tpipe = HunyuanVideoPipeline(transformer=port_module("hunyuan_dit", tcfg, tp), vae=vae, device="cpu")
    calls = []
    inner = vae.decode
    vae.decode = lambda z: (calls.append(tuple(z.shape[2:4])), inner(z))[1]
    z = torch.from_numpy(np.random.RandomState(2).randn(1, 4, 1, 44, 76).astype(np.float32))
    frames = tpipe.decode_latents(z)
    assert frames.shape == (1, 3, 1, 352, 608) and bool(torch.isfinite(frames).all())
    assert len(calls) == 2 * 4 and calls[0] == (32, 32)  # rows at 0, 24; columns at 0, 24, 48, 72
    calls.clear()
    tpipe.decode_latents(z[:, :, :, :40, :40])
    assert calls == [(40, 40)]
