"""The port's Wan pipeline end to end against ``alg_tpu``'s
``WanPipeline.__call__`` on the CPU in fp32: the same tiny weights (carried
by the port's bridge), seed, image, tokenizer stub and image embeddings,
through UMT5 with the prompt mask, the tiled-or-whole condition encode, the
ALG UniPC sampler and the VAE decode.

The configs are those of the JAX package's tiny Wan pipeline (head dim 12),
at the golden test's size: 32x32, 9 frames, 4 steps, interval [0, 0.4] (two
3-pass steps, then two 2-pass). Bounds are its golden bounds
(``tests/test_minipipeline_wan_golden.py:303-308``): final latents within
atol 2e-3 + rtol 1e-4 and decoded frames above 40 dB PSNR: the fp32
differences of summation order compound over the sampler's steps."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_port_common import build_wan_pair, one_thread, psnr

LATENT_ATOL, LATENT_RTOL, MIN_PSNR_DB = 2e-3, 1e-4, 40.0
HEIGHT = WIDTH = 32


@pytest.fixture(scope="module")
def pair():
    return build_wan_pair()


def _kwargs(alg: bool, last: bool = False, **over):
    r = np.random.RandomState(13)
    image = r.uniform(-1, 1, (1, 3, HEIGHT, WIDTH)).astype(np.float32)
    image_embeds = r.randn(1, 5, 10).astype(np.float32)
    last_image = r.uniform(-1, 1, (1, 3, HEIGHT, WIDTH)).astype(np.float32) if last else None
    kw = dict(image=image, prompt="a cat on a mat", negative_prompt="", height=HEIGHT, width=WIDTH, num_frames=9,
              num_inference_steps=4, guidance_scale=5.0, seed=42, max_sequence_length=7, last_image=last_image,
              use_low_pass_guidance=alg, lp_filter_type="down_up", lp_filter_in_latent=True, lp_resize_factor=0.4,
              lp_strength_schedule_type="interval", schedule_interval_start_time=0.0,
              schedule_interval_end_time=0.4)
    kw.update(over)
    return kw, image_embeds


def _run_both(pair, kw, image_embeds):
    jpipe, tpipe = pair
    ref = np.asarray(jpipe(output_type="latent", image_embeds=jnp.asarray(image_embeds), **kw))
    out = tpipe(output_type="latent", image_embeds=torch.from_numpy(image_embeds), **kw)
    return ref, out


@pytest.mark.parametrize("alg,last", [(True, False), (False, False), (True, True)],
                         ids=["alg-3pass-then-2pass", "noalg", "alg-last-image"])
def test_wan_pipeline_matches_alg_tpu(pair, alg, last):
    jpipe, tpipe = pair
    kw, image_embeds = _kwargs(alg, last)
    ref, out = _run_both(pair, kw, image_embeds)
    assert out.shape == ref.shape == (1, 4, 3, 4, 4)
    np.testing.assert_allclose(out, ref, atol=LATENT_ATOL, rtol=LATENT_RTOL)

    # decoded frames: each package decodes its own latents
    ref_frames = np.asarray(jpipe.decode_latents(jnp.asarray(ref)))
    out_frames = tpipe.decode_latents(torch.from_numpy(out)).numpy()
    assert out_frames.shape == ref_frames.shape == (1, 3, 9, HEIGHT, WIDTH)
    to01 = lambda v: np.clip(v / 2 + 0.5, 0, 1)
    assert psnr(to01(out_frames), to01(ref_frames)) > MIN_PSNR_DB


def test_wan_exponential_schedule_has_no_two_pass_shortcut(pair):
    """Wan builds its plan with ``exp_shortcut=False``: every step of an
    exponential schedule is 3-pass. Both packages agree on such a run."""
    kw, image_embeds = _kwargs(True, lp_strength_schedule_type="exponential", num_inference_steps=3)
    ref, out = _run_both(pair, kw, image_embeds)
    np.testing.assert_allclose(out, ref, atol=LATENT_ATOL, rtol=LATENT_RTOL)


def test_wan_single_pass_without_cfg(pair):
    kw, image_embeds = _kwargs(True, guidance_scale=1.0)
    ref, out = _run_both(pair, kw, image_embeds)
    np.testing.assert_allclose(out, ref, atol=LATENT_ATOL, rtol=LATENT_RTOL)


def test_wan_guidance_microbatch_equals_batched(pair):
    """The CFG/ALG passes run one sample at a time give what the batched
    forward gives (batch is a parallel dim everywhere): atol 1e-5, fp32
    matrix products of another batch size sum in another order."""
    import dataclasses

    _, tpipe = pair
    kw, image_embeds = _kwargs(True)
    batched = tpipe(output_type="latent", image_embeds=torch.from_numpy(image_embeds), **kw)
    micro = dataclasses.replace(tpipe, guidance_microbatch=1)(
        output_type="latent", image_embeds=torch.from_numpy(image_embeds), **kw)
    np.testing.assert_allclose(micro, batched, atol=1e-5, rtol=0)


def test_wan_frames_coerced_and_alg_changes_the_result(pair):
    """10 frames run as 9 (4k + 1); ALG on and off differ, so the filtered
    20-channel condition reaches the DiT."""
    _, tpipe = pair
    kw, image_embeds = _kwargs(True, num_frames=10)
    emb = torch.from_numpy(image_embeds)
    a = tpipe(output_type="latent", image_embeds=emb, **kw)
    b = tpipe(output_type="latent", image_embeds=emb, **_kwargs(False)[0])
    c = tpipe(output_type="latent", image_embeds=emb, **_kwargs(True)[0])
    assert a.shape == (1, 4, 3, 4, 4) and np.array_equal(a, c)
    assert np.abs(a - b).max() > 1e-3


def test_wan_encode_prompt_masks_and_zeroes(pair):
    """UMT5 with the prefix mask; embeddings past each prompt's length are
    zero. atol 1e-5: same ops in another order."""
    jpipe, tpipe = pair
    prompts = ["a cat on a mat", "", "dog"]
    ref = np.asarray(jpipe.encode_prompt(prompts, 7))
    out = tpipe.encode_prompt(prompts, 7).numpy()
    assert out.shape == ref.shape == (3, 7, 8)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)
    assert not out[1, 1:].any() and not out[2, 4:].any() and out[2, :4].any()


def test_wan_encode_image_matches(pair):
    """``clip_preprocess`` then the tower's penultimate hidden states
    (atol 1e-4, a whole forward)."""
    import dataclasses

    from torch_port_common import port_module, tiny_wan_configs, wan_trees

    cfgs = tiny_wan_configs()
    ccfg, cp = cfgs[3], wan_trees(*cfgs)[3]
    jpipe = dataclasses.replace(pair[0], clip_cfg=ccfg, clip_params=cp)
    tpipe = dataclasses.replace(pair[1], clip=port_module("clip", ccfg, cp))
    image = np.random.RandomState(3).uniform(-1, 1, (1, 3, 40, 56)).astype(np.float32)
    ref, out = np.asarray(jpipe.encode_image(image)), tpipe.encode_image(image).numpy()
    assert out.shape == ref.shape == (1, 5, 10)
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)
    with pytest.raises(ValueError, match="CLIP"):
        pair[1].encode_image(image)


def test_wan_mask_block_matches_alg_tpu(pair):
    jpipe, tpipe = pair
    for has_last in (False, True):
        ref = jpipe._mask_block(2, 9, 3, 4, 4, last_image=object() if has_last else None)
        out = tpipe._mask_block(2, 9, 4, 4, has_last)
        assert out.shape == (2, 4, 3, 4, 4) and np.array_equal(out, ref)


def test_wan_np_output_and_unported_mode(pair):
    _, tpipe = pair
    kw, image_embeds = _kwargs(True)
    emb = torch.from_numpy(image_embeds)
    video = tpipe(output_type="np", image_embeds=emb, **kw)
    assert video.shape == (1, 9, HEIGHT, WIDTH, 3) and np.isfinite(video).all()
    assert video.min() >= 0.0 and video.max() <= 1.0
    # pixel-space ALG and PIL frames, once refused, run: pixel mode agrees with alg_tpu
    pixel = {**kw, "lp_filter_in_latent": False}
    ref = np.asarray(pair[0](output_type="latent", image_embeds=jnp.asarray(image_embeds), **pixel))
    np.testing.assert_allclose(tpipe(output_type="latent", image_embeds=emb, **pixel), ref, atol=LATENT_ATOL,
                               rtol=LATENT_RTOL)
    frames = tpipe(output_type="pil", image_embeds=emb, **kw)
    np.testing.assert_array_equal(np.stack([np.asarray(f) for f in frames[0]]),
                                  np.round(video[0] * 255).astype(np.uint8))
    with pytest.raises(ValueError, match="output_type"):
        tpipe(output_type="pt", image_embeds=emb, **kw)
    with pytest.raises(ValueError, match="divisible by 16"):
        tpipe(output_type="latent", image_embeds=emb, **{**kw, "height": 40})
    with pytest.raises(ValueError, match="attention_kwargs"):
        tpipe(output_type="latent", image_embeds=emb, attention_kwargs={"scale": 0.5}, **kw)
