"""The rest of the sampling surface in the port's HunyuanVideo pipeline
against ``alg_tpu``'s ``HunyuanVideoPipeline.__call__`` on the CPU in fp32
(the same tiny weights, seed, image and prompt embeddings as
``test_torch_port_hunyuan_pipeline.py``): pixel-space ALG with the mode of
the VAE posterior of the filtered RGB frame (single-pass, true CFG with 3-
and 2-pass steps, and ``latent_concat`` with its zero-padded frames), the
step cache, a step observer that replaces the latents, an interrupt, and a
resumed run (bit for bit against the uninterrupted one).

Bounds are the golden bounds: final latents within atol 2e-3 + rtol 1e-4."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_port_common import build_hunyuan_pair, one_thread


LATENT_ATOL, LATENT_RTOL = 2e-3, 1e-4
HEIGHT = WIDTH = 32
ALG_KW = dict(use_low_pass_guidance=True, lp_filter_type="down_up", lp_filter_in_latent=True, lp_resize_factor=0.625,
              lp_strength_schedule_type="interval", schedule_interval_start_time=0.0,
              schedule_interval_end_time=0.4)
PIXEL_KW = dict(ALG_KW, lp_filter_in_latent=False, lp_filter_type="gaussian_blur", lp_blur_sigma=2.0)


@pytest.fixture(scope="module")
def pair():
    return build_hunyuan_pair()


@pytest.fixture(scope="module")
def concat_pair():
    return build_hunyuan_pair(in_channels=9)


def _kwargs(true_cfg=1.0, **over):
    r = np.random.RandomState(17)
    pe, ne = (r.randn(1, 7, 12).astype(np.float32) for _ in range(2))
    pooled, npooled = (r.randn(1, 6).astype(np.float32) for _ in range(2))
    mask, nmask = np.ones((1, 7), np.int32), np.ones((1, 7), np.int32)
    mask[0, 5:] = 0
    image = r.uniform(-1, 1, (1, 3, HEIGHT, WIDTH)).astype(np.float32)
    embeds = dict(prompt_embeds=pe, pooled_prompt_embeds=pooled, prompt_attention_mask=mask)
    if true_cfg > 1.0:
        embeds.update(negative_prompt_embeds=ne, negative_pooled_prompt_embeds=npooled,
                      negative_prompt_attention_mask=nmask)
    kw = {**dict(image=image, height=HEIGHT, width=WIDTH, num_frames=9, num_inference_steps=4, guidance_scale=6.0,
                 true_cfg_scale=true_cfg, seed=42, output_type="latent"), **over}
    return kw, embeds


def _run(pipe, jax_side, kw, embeds, **extra):
    conv = jnp.asarray if jax_side else torch.from_numpy
    return np.asarray(pipe(**kw, **{k: conv(v) for k, v in embeds.items()}, **extra))


CASES = {
    "pixel-single-pass": dict(**PIXEL_KW),
    "pixel-true-cfg": dict(true_cfg=2.0, **PIXEL_KW),
    "pixel-latent-concat": dict(image_condition_type="latent_concat", **PIXEL_KW),
    "cache-2": dict(cache_interval=2, num_inference_steps=5, **ALG_KW),
    "cache-2-true-cfg": dict(true_cfg=2.0, cache_interval=2, num_inference_steps=5, **ALG_KW),
}


@pytest.mark.parametrize("case", list(CASES))
def test_hunyuan_surface_matches_alg_tpu(pair, concat_pair, case):
    jpipe, tpipe = concat_pair if "concat" in case else pair
    kw, embeds = _kwargs(**CASES[case])
    forwards = []
    hook = tpipe.transformer.register_forward_hook(lambda *_: forwards.append(1))
    try:
        out = _run(tpipe, False, kw, embeds)
    finally:
        hook.remove()
    ref = _run(jpipe, True, kw, embeds)
    assert out.shape == ref.shape and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, atol=LATENT_ATOL, rtol=LATENT_RTOL)
    # 5 steps, ALG on steps 0-1: the cache skips step 3
    assert len(forwards) == (4 if case.startswith("cache") else kw["num_inference_steps"])
    if case.startswith("pixel"):  # the filtered frame's encode reaches the DiT
        base = _run(tpipe, False, {**kw, "lp_filter_in_latent": True}, embeds)
        assert np.abs(out - base).max() > 1e-4


def test_hunyuan_pixel_condition_is_the_scaled_mode(pair):
    """With identity operators the pixel condition is the image latent the
    pipeline starts from (the scaled mode of the same frame), zero-padded."""
    _, tpipe = pair
    image = torch.from_numpy(_kwargs()[0]["image"])[:, None]
    eye = torch.eye(HEIGHT)
    with torch.no_grad():
        cond = tpipe._pixel_condition(image, eye, eye, 3)
        first = tpipe._encode_mode(image)
    assert cond.shape == (1, 4, 3, 4, 4) and torch.equal(cond[:, :, :1], first)
    assert not cond[:, :, 1:].any()


def test_hunyuan_observer_and_interrupt_match_alg_tpu(pair):
    jpipe, tpipe = pair
    kw, embeds = _kwargs(**ALG_KW)

    def observer(pipe):
        def obs(i, latents):
            if i == 0:
                return latents * 0.5
            if i == 2:
                pipe.interrupt = True
            return None
        return obs

    ref = _run(jpipe, True, kw, embeds, step_observer=observer(jpipe))
    out = _run(tpipe, False, kw, embeds, step_observer=observer(tpipe))
    np.testing.assert_allclose(out, ref, atol=LATENT_ATOL, rtol=LATENT_RTOL)
    assert tpipe.interrupt and np.abs(out - _run(tpipe, False, kw, embeds)).max() > 1e-3


@pytest.mark.parametrize("case", ["pixel-single-pass", "cache-2-true-cfg"])
def test_hunyuan_resume_is_bitwise(pair, tmp_path, case):
    _, tpipe = pair
    kw, embeds = _kwargs(**CASES[case])
    snap = str(tmp_path / "run.npz")

    def stop(i, _latents):
        if i == 1:
            tpipe.interrupt = True

    whole = _run(tpipe, False, kw, embeds)
    _run(tpipe, False, kw, embeds, checkpoint=snap, checkpoint_every=1, step_observer=stop)
    with np.load(snap) as z:
        assert int(z["step"]) == 2 and int(z["n_leaves"]) == (2 if "cache" in case else 1)
    resumed = _run(tpipe, False, kw, embeds, checkpoint=snap)
    assert np.array_equal(resumed, whole) and not (tmp_path / "run.npz").exists()
