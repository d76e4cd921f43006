"""The port's CogVideoX pipeline end to end against ``alg_tpu``'s
``CogVideoXPipeline.__call__`` on the CPU in fp32: the same tiny weights
(carried by the port's bridge), seed, image and tokenizer stub, through T5,
VAE encode, the ALG sampler and the tiled-or-whole VAE decode.

Bounds are the JAX package's golden bounds
(``tests/test_minipipeline_wan_golden.py:303-308``): final latents within
atol 2e-3 and decoded frames above 40 dB PSNR — the fp32 differences of
summation order compound over the sampler's steps."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_port_common import build_pair, one_thread, psnr


LATENT_ATOL, MIN_PSNR_DB = 2e-3, 40.0


@pytest.fixture(scope="module")
def pair():
    return build_pair()


def _kwargs(alg: bool):
    image = np.random.RandomState(7).uniform(-1, 1, (1, 3, 32, 32)).astype(np.float32)
    return dict(image=image, prompt="a cat", negative_prompt="", height=32, width=32, num_frames=5,
                num_inference_steps=4, guidance_scale=6.0, seed=42, max_sequence_length=4,
                use_low_pass_guidance=alg, lp_filter_type="down_up", lp_filter_in_latent=True,
                lp_resize_factor=0.25, lp_strength_schedule_type="interval",
                schedule_interval_start_time=0.0, schedule_interval_end_time=0.4)


@pytest.mark.parametrize("alg", [True, False], ids=["alg-3pass-then-2pass", "noalg"])
def test_pipeline_matches_alg_tpu(pair, alg):
    jpipe, tpipe = pair
    kw = _kwargs(alg)
    if alg:  # 4 steps at interval [0, 0.4]: steps 0-1 three-pass, 2-3 two-pass
        from alg_tpu_torch.alg.schedule import LPConfig, build_lp_plan

        plan = build_lp_plan(LPConfig(use_low_pass_guidance=True, lp_filter_type="down_up",
                                      lp_strength_schedule_type="interval", schedule_interval_end_time=0.4), 4, 4, 4)
        assert [(s.start, s.stop, s.three_pass) for s in plan.segments] == [(0, 2, True), (2, 4, False)]
    ref = jpipe(output_type="latent", **kw)
    out = tpipe(output_type="latent", **kw)
    assert out.shape == ref.shape == (1, 2, 4, 4, 4)
    np.testing.assert_allclose(out, ref, atol=LATENT_ATOL, rtol=0)

    # decoded frames: each package decodes its own latents
    ref_frames = np.asarray(jpipe.decode_latents(jnp.asarray(ref)))
    out_frames = tpipe.decode_latents(torch.from_numpy(out)).numpy()
    assert out_frames.shape == ref_frames.shape == (1, 5, 3, 32, 32)
    to01 = lambda v: np.clip(v / 2 + 0.5, 0, 1)
    assert psnr(to01(out_frames), to01(ref_frames)) > MIN_PSNR_DB


def test_alg_changes_the_result(pair):
    """ALG on and off differ: the filtered conditioning reaches the DiT."""
    _, tpipe = pair
    a = tpipe(output_type="latent", **_kwargs(True))
    b = tpipe(output_type="latent", **_kwargs(False))
    assert np.abs(a - b).max() > 1e-3


def test_np_output_and_unported_mode(pair):
    """``np`` frames in [0, 1]; pixel-space ALG and ``pil`` frames, once
    refused, now run: pixel mode agrees with ``alg_tpu`` and differs from
    latent mode, the PIL frames are the ``np`` frames in uint8."""
    jpipe, tpipe = pair
    video = tpipe(output_type="np", **_kwargs(True))
    assert video.shape == (1, 5, 32, 32, 3) and np.isfinite(video).all()
    assert video.min() >= 0.0 and video.max() <= 1.0
    pixel = {**_kwargs(True), "lp_filter_in_latent": False}
    out = tpipe(output_type="latent", **pixel)
    np.testing.assert_allclose(out, np.asarray(jpipe(output_type="latent", **pixel)), atol=LATENT_ATOL, rtol=0)
    assert np.abs(out - tpipe(output_type="latent", **_kwargs(True))).max() > 1e-3
    frames = tpipe(output_type="pil", **_kwargs(True))
    assert len(frames) == 1 and [f.size for f in frames[0]] == [(32, 32)] * 5
    np.testing.assert_array_equal(np.stack([np.asarray(f) for f in frames[0]]),
                                  np.round(video[0] * 255).astype(np.uint8))
