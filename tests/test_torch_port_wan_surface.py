"""The rest of the sampling surface in the port's Wan pipeline against
``alg_tpu``'s ``WanPipeline.__call__`` on the CPU in fp32 (the same tiny
weights, seed, image, tokenizer stub and image embeddings as
``test_torch_port_wan_pipeline.py``): pixel-space ALG, which rebuilds the
condition video from the filtered RGB frame on each 3-pass step (also with
a ``last_image``, which that rebuild leaves out in both packages, where
the reference encodes it: ROADMAP.md C, R10), the step cache, a step observer that replaces the latents, an
interrupt, and a resumed run whose carry holds the UniPC history (bit for
bit against the uninterrupted one).

Bounds are the golden bounds: final latents within atol 2e-3 + rtol 1e-4."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_port_common import build_wan_pair, one_thread


LATENT_ATOL, LATENT_RTOL = 2e-3, 1e-4
HEIGHT = WIDTH = 32


@pytest.fixture(scope="module")
def pair():
    return build_wan_pair()


def _kwargs(last=False, **over):
    r = np.random.RandomState(13)
    image = r.uniform(-1, 1, (1, 3, HEIGHT, WIDTH)).astype(np.float32)
    image_embeds = r.randn(1, 5, 10).astype(np.float32)
    last_image = r.uniform(-1, 1, (1, 3, HEIGHT, WIDTH)).astype(np.float32) if last else None
    kw = dict(image=image, prompt="a cat on a mat", negative_prompt="", height=HEIGHT, width=WIDTH, num_frames=9,
              num_inference_steps=4, guidance_scale=5.0, seed=42, max_sequence_length=7, last_image=last_image,
              use_low_pass_guidance=True, lp_filter_type="down_up", lp_filter_in_latent=True, lp_resize_factor=0.4,
              lp_strength_schedule_type="interval", schedule_interval_start_time=0.0,
              schedule_interval_end_time=0.4, output_type="latent")
    kw.update(over)
    return kw, image_embeds


def _run(pipe, jax_side, kw, image_embeds, **extra):
    emb = jnp.asarray(image_embeds) if jax_side else torch.from_numpy(image_embeds)
    return np.asarray(pipe(image_embeds=emb, **kw, **extra))


CASES = {
    "pixel": dict(lp_filter_in_latent=False),
    "pixel-gaussian": dict(lp_filter_in_latent=False, lp_filter_type="gaussian_blur", lp_blur_sigma=2.0,
                           lp_strength_schedule_type="linear", schedule_linear_end_time=0.5),
    "pixel-last-image": dict(last=True, lp_filter_in_latent=False),
    "cache-2": dict(cache_interval=2, num_inference_steps=5),
}


@pytest.mark.parametrize("case", list(CASES))
def test_wan_surface_matches_alg_tpu(pair, case):
    jpipe, tpipe = pair
    kw, emb = _kwargs(**CASES[case])
    forwards = []
    hook = tpipe.transformer.register_forward_hook(lambda *_: forwards.append(1))
    try:
        out = _run(tpipe, False, kw, emb)
    finally:
        hook.remove()
    ref = _run(jpipe, True, kw, emb)
    assert out.shape == ref.shape == (1, 4, 3, 4, 4) and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, atol=LATENT_ATOL, rtol=LATENT_RTOL)
    # 5 steps, ALG on steps 0-1: the cache skips step 3
    assert len(forwards) == (4 if case == "cache-2" else kw["num_inference_steps"])
    if case.startswith("pixel"):  # the rebuilt condition reaches the DiT
        base = _run(tpipe, False, {**kw, "lp_filter_in_latent": True}, emb)
        assert np.abs(out - base).max() > 1e-3


def test_wan_pixel_rebuild_keeps_the_mask_and_leaves_out_the_last_image(pair):
    """The rebuilt condition: the clean condition's 4 mask channels (which
    mark the last frame), then the normalised sample of [filtered first
    frame, num_frames - 1 zero frames]: the ``last_image`` does not enter."""
    _, tpipe = pair
    m = torch.eye(HEIGHT)
    image = torch.from_numpy(_kwargs()[0]["image"])[:, None]
    mask = torch.arange(4 * 3 * 16, dtype=torch.float32).reshape(1, 4, 3, 4, 4)
    eps = torch.zeros(1, 4, 3, 4, 4)
    with torch.no_grad():
        cond = tpipe._pixel_condition(image, m, m, eps, 9, mask)
        video = torch.cat([image, torch.zeros((1, 8, 3, HEIGHT, WIDTH))], dim=1)
        want = tpipe._encode_video_condition(video)  # eps = 0: the mean, which the mode is
    assert torch.equal(cond[:, :4], mask)
    torch.testing.assert_close(cond[:, 4:], want, atol=1e-6, rtol=0)


def test_wan_observer_and_interrupt_match_alg_tpu(pair):
    """A mutating observer (a dict after step 1) and an interrupt after step
    2, in both packages."""
    jpipe, tpipe = pair
    kw, emb = _kwargs()

    def observer(pipe):
        def obs(i, latents):
            if i == 1:
                return {"latents": latents * 0.5}
            if i == 2:
                pipe.interrupt = True
            return None
        return obs

    ref = _run(jpipe, True, kw, emb, step_observer=observer(jpipe))
    out = _run(tpipe, False, kw, emb, step_observer=observer(tpipe))
    np.testing.assert_allclose(out, ref, atol=LATENT_ATOL, rtol=LATENT_RTOL)
    assert tpipe.interrupt and np.abs(out - _run(tpipe, False, kw, emb)).max() > 1e-3


@pytest.mark.parametrize("over", [dict(lp_filter_in_latent=False), dict(cache_interval=2, num_inference_steps=5)],
                         ids=["pixel", "cache"])
def test_wan_resume_is_bitwise(pair, tmp_path, over):
    """Interrupted after step 1 with a snapshot every step, then resumed: the
    UniPC history (and the cached prediction) come back from the snapshot."""
    _, tpipe = pair
    kw, emb = _kwargs(**over)
    snap = str(tmp_path / "run.npz")

    def stop(i, _latents):
        if i == 1:
            tpipe.interrupt = True

    whole = _run(tpipe, False, kw, emb)
    _run(tpipe, False, kw, emb, checkpoint=snap, checkpoint_every=1, step_observer=stop)
    with np.load(snap) as z:
        assert int(z["step"]) == 2 and int(z["n_leaves"]) == (5 if "cache_interval" in over else 4)
    resumed = _run(tpipe, False, kw, emb, checkpoint=snap)
    assert np.array_equal(resumed, whole) and not (tmp_path / "run.npz").exists()


def test_wan_pil_output(pair):
    _, tpipe = pair
    kw, emb = _kwargs(lp_filter_in_latent=False, output_type="pil")
    frames = tpipe(image_embeds=torch.from_numpy(emb), **kw)
    arr = tpipe(image_embeds=torch.from_numpy(emb), **{**kw, "output_type": "np"})
    assert len(frames) == 1 and len(frames[0]) == 9 and frames[0][0].size == (WIDTH, HEIGHT)
    np.testing.assert_array_equal(np.stack([np.asarray(f) for f in frames[0]]),
                                  np.round(arr[0] * 255).astype(np.uint8))
