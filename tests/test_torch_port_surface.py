"""The rest of the sampling surface in the port's CogVideoX pipeline against
``alg_tpu``'s ``CogVideoXPipeline.__call__`` on the CPU in fp32, on the same
tiny weights, seed, image and tokenizer stub: pixel-space ALG (BASELINE
config #2's gaussian blur under the linear and the exponential schedule),
the DPM scheduler with ALG, dynamic CFG, stochastic DDIM (eta > 0), custom
timesteps and the step cache; a step observer that replaces the latents, an
interrupt, a resumed run (bit for bit against the uninterrupted one), PIL
output, the DPM checkpoint's scheduler; and each pipeline's ``__call__``
takes every keyword of ``alg_tpu``'s.

Bounds are the JAX package's golden bounds
(``tests/test_minipipeline_wan_golden.py:303-308``): final latents within
atol 2e-3, decoded frames above 40 dB PSNR."""

import dataclasses
import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from alg_tpu import pipelines as JP
from alg_tpu.io import model_zoo as JZ

from alg_tpu_torch.io import hf_checkpoint as H
from alg_tpu_torch.io import model_zoo as TZ
from alg_tpu_torch.pipelines.cogvideox import CogVideoXPipeline
from alg_tpu_torch.pipelines.hunyuan import HunyuanVideoPipeline
from alg_tpu_torch.pipelines.wan import WanPipeline

from torch_port_common import build_pair, one_thread, psnr

LATENT_ATOL, MIN_PSNR_DB = 2e-3, 40.0


PIXEL = dict(lp_filter_type="gaussian_blur", lp_filter_in_latent=False, lp_blur_sigma=3.0, lp_blur_kernel_size=0.1)
CASES = {
    "pixel-linear": ("ddim", dict(PIXEL, lp_strength_schedule_type="linear", schedule_linear_end_time=0.5)),
    "pixel-exponential": ("ddim", dict(PIXEL, lp_strength_schedule_type="exponential", schedule_exp_decay_rate=5.0,
                                       schedule_blur_kernel_size=True)),
    "dpm-alg": ("dpm", {}),
    "dyncfg": ("ddim", dict(use_dynamic_cfg=True)),
    "eta": ("ddim", dict(eta=0.5)),
    "custom-timesteps": ("ddim", dict(timesteps=[999, 700, 350, 20])),
    "cache-2": ("ddim", dict(cache_interval=2, num_inference_steps=5)),
}


def _kwargs(**over):
    image = np.random.RandomState(7).uniform(-1, 1, (1, 3, 32, 32)).astype(np.float32)
    return {**dict(image=image, prompt="a cat", negative_prompt="", height=32, width=32, num_frames=5,
                   num_inference_steps=4, guidance_scale=6.0, seed=42, max_sequence_length=4,
                   use_low_pass_guidance=True, lp_filter_type="down_up", lp_filter_in_latent=True,
                   lp_resize_factor=0.25, lp_strength_schedule_type="interval", schedule_interval_start_time=0.0,
                   schedule_interval_end_time=0.4), **over}


@pytest.fixture(scope="module")
def pair():
    return build_pair()


@pytest.fixture(scope="module")
def runs(pair):
    """{case: (alg_tpu latents, port latents, the port's DiT forwards)},
    each pair of calls made once."""
    jpipe, tpipe = pair
    done = {}

    def get(case):
        if case not in done:
            scheduler, over = CASES[case]
            forwards = []
            hook = tpipe.transformer.register_forward_hook(lambda *_: forwards.append(1))
            try:
                out = dataclasses.replace(tpipe, scheduler=scheduler)(output_type="latent", **_kwargs(**over))
            finally:
                hook.remove()
            ref = np.asarray(dataclasses.replace(jpipe, scheduler=scheduler)(output_type="latent", **_kwargs(**over)))
            done[case] = (ref, out, len(forwards))
        return done[case]

    return get


def _frames_agree(pair, ref, out):
    jpipe, tpipe = pair
    ref_frames = np.asarray(jpipe.decode_latents(jnp.asarray(ref)))
    out_frames = tpipe.decode_latents(torch.from_numpy(out)).numpy()
    assert out_frames.shape == ref_frames.shape == (1, 5, 3, 32, 32)
    to01 = lambda v: np.clip(v / 2 + 0.5, 0, 1)
    assert psnr(to01(out_frames), to01(ref_frames)) > MIN_PSNR_DB


@pytest.mark.parametrize("case", list(CASES))
def test_surface_matches_alg_tpu(pair, runs, case):
    ref, out, _ = runs(case)
    assert out.shape == ref.shape == (1, 2, 4, 4, 4) and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, atol=LATENT_ATOL, rtol=0)
    _frames_agree(pair, ref, out)


@pytest.mark.parametrize("case", ["pixel-linear", "dpm-alg", "eta", "dyncfg", "custom-timesteps"])
def test_each_option_changes_the_result(runs, pair, case):
    """Against the plain latent-ALG DDIM run: the option reaches the sampler."""
    _, tpipe = pair
    base = tpipe(output_type="latent", **_kwargs())
    assert np.abs(runs(case)[1] - base).max() > 1e-3


def test_cache_skips_the_dit(runs):
    """cache_interval 2 over 5 steps with ALG on steps 0-1: steps 0, 1, 2 and
    4 run the DiT, step 3 reuses step 2's prediction."""
    assert runs("cache-2")[2] == 4
    assert runs("pixel-linear")[2] == 4  # one forward a step without the cache


def test_mutating_observer_matches_alg_tpu(pair):
    """An observer that returns scaled latents after step 1 (as a dict) and
    the bare array after step 2 replaces the carry in both packages."""
    seen = {"jax": [], "port": []}

    def observer(key):
        def obs(i, latents):
            seen[key].append((i, latents.shape))
            if i == 1:
                return {"latents": latents * 0.5}
            if i == 2:
                return latents + 0.25
            return None
        return obs

    jpipe, tpipe = pair
    ref = np.asarray(jpipe(output_type="latent", step_observer=observer("jax"), **_kwargs()))
    out = tpipe(output_type="latent", step_observer=observer("port"), **_kwargs())
    assert seen["port"] == seen["jax"] == [(i, (1, 2, 4, 4, 4)) for i in range(4)]
    np.testing.assert_allclose(out, ref, atol=LATENT_ATOL, rtol=0)
    assert np.abs(out - tpipe(output_type="latent", **_kwargs())).max() > 1e-2


def test_interrupt_matches_alg_tpu(pair):
    """An observer sets ``interrupt`` after step 1: both return the latents
    of two steps; the next call resets the flag and runs all four."""
    jpipe, tpipe = pair

    def stop(pipe):
        def obs(i, _latents):
            if i == 1:
                pipe.interrupt = True
        return obs

    ref = np.asarray(jpipe(output_type="latent", step_observer=stop(jpipe), **_kwargs()))
    out = tpipe(output_type="latent", step_observer=stop(tpipe), **_kwargs())
    np.testing.assert_allclose(out, ref, atol=LATENT_ATOL, rtol=0)
    assert tpipe.interrupt
    whole = tpipe(output_type="latent", **_kwargs())
    assert not tpipe.interrupt and np.abs(whole - out).max() > 1e-3


@pytest.mark.parametrize("scheduler,over", [("dpm", {}), ("ddim", dict(PIXEL, eta=0.5, cache_interval=2,
                                                                      num_inference_steps=5))],
                         ids=["dpm", "pixel-eta-cache"])
def test_resume_is_bitwise(pair, tmp_path, scheduler, over):
    """Interrupted after step 1 with a snapshot every step, then resumed by
    the same call: bit for bit the uninterrupted run (DPM carries x0; the
    cache carries the previous prediction; the noise stacks are redrawn)."""
    tpipe = dataclasses.replace(pair[1], scheduler=scheduler)
    snap = str(tmp_path / "run.npz")

    def stop(i, _latents):
        if i == 1:
            tpipe.interrupt = True

    whole = tpipe(output_type="latent", **_kwargs(**over))
    tpipe(output_type="latent", checkpoint=snap, checkpoint_every=1, step_observer=stop, **_kwargs(**over))
    with np.load(snap) as z:
        assert int(z["step"]) == 2
    resumed = tpipe(output_type="latent", checkpoint=snap, checkpoint_every=1, **_kwargs(**over))
    assert np.array_equal(resumed, whole)
    assert not (tmp_path / "run.npz").exists()
    # another seed is another run: its snapshot does not resume this one
    tpipe(output_type="latent", checkpoint=snap, checkpoint_every=1, step_observer=stop, **_kwargs(**over))
    other = tpipe(output_type="latent", checkpoint=snap, **_kwargs(seed=1, **over))
    assert np.array_equal(other, tpipe(output_type="latent", **_kwargs(seed=1, **over)))


def test_pil_output_matches_alg_tpu(pair):
    jpipe, tpipe = pair
    kw = _kwargs(**CASES["pixel-linear"][1])
    ref, out = jpipe(output_type="pil", **kw), tpipe(output_type="pil", **kw)
    assert len(out) == len(ref) == 1 and len(out[0]) == len(ref[0]) == 5
    assert all(f.mode == "RGB" and f.size == (32, 32) for f in out[0])
    a = np.stack([np.asarray(f) for f in out[0]])
    b = np.stack([np.asarray(f) for f in ref[0]])
    assert psnr(a / 255.0, b / 255.0) > MIN_PSNR_DB
    np.testing.assert_array_equal(a, np.round(np.clip(tpipe(output_type="np", **kw)[0], 0, 1) * 255).astype(np.uint8))


@pytest.mark.parametrize("port,ref", [(CogVideoXPipeline, JP.CogVideoXPipeline), (WanPipeline, JP.WanPipeline),
                                      (HunyuanVideoPipeline, JP.HunyuanVideoPipeline)],
                         ids=["cogvideox", "wan", "hunyuan"])
def test_call_takes_every_keyword_of_alg_tpu(port, ref):
    ours = inspect.signature(port.__call__).parameters
    theirs = inspect.signature(ref.__call__).parameters
    assert set(theirs) <= set(ours), sorted(set(theirs) - set(ours))
    kinds = {name: p.kind for name, p in ours.items()}
    assert all(kinds[name] == p.kind for name, p in theirs.items())


@pytest.mark.parametrize("scheduler_class,want", [("CogVideoXDDIMScheduler", "ddim"), ("CogVideoXDPMScheduler", "dpm")])
def test_loader_takes_the_checkpoints_scheduler(tmp_path, scheduler_class, want):
    """A checkpoint whose scheduler config names the DPM class loads into a
    ``scheduler="dpm"`` pipeline, as in ``alg_tpu``."""
    root = str(tmp_path / "TinyCogVideoX")
    H.write_cogvideox(root, dtype=torch.float32, scheduler_class=scheduler_class)
    assert TZ.load_cogvideox_pipeline(root, dtype=torch.float32, device="cpu").scheduler == want
    assert JZ.load_cogvideox_pipeline(root, dtype=jnp.float32).scheduler == want


def test_surface_refusals(pair):
    _, tpipe = pair
    with pytest.raises(ValueError, match="cache_interval"):
        tpipe(output_type="latent", cache_interval=0, **_kwargs())
    with pytest.raises(ValueError, match="scheduler"):
        dataclasses.replace(tpipe, scheduler="euler")(output_type="latent", **_kwargs())
    with pytest.raises(ValueError, match="output_type"):
        tpipe(output_type="pt", **_kwargs())
    with pytest.raises(ValueError, match="attention_kwargs"):
        tpipe(output_type="latent", attention_kwargs={"scale": 0.5}, **_kwargs())


def test_denoise_loop_run_control(tmp_path):
    """The shared loop on a counting stand-in: ``stop_after`` returns after
    that many steps and leaves the snapshot; the cache reuses the previous
    prediction on the steps its mask skips; an observer's replacement
    becomes the next step's input; a resume starts at the saved step."""
    import types

    from alg_tpu_torch.io.runstate import RunCheckpoint
    from alg_tpu_torch.pipelines.denoise import denoise_loop

    pipe = types.SimpleNamespace(interrupt=False)
    calls = []

    def predict(i, latents):
        calls.append(i)
        return latents + 1.0 + i

    def update(i, carry, noise_pred):
        return (carry[0] + noise_pred, carry[1] + 1)

    x0 = torch.zeros(2)
    ck = RunCheckpoint(str(tmp_path / "s.npz"), "fp", every=1)
    out = denoise_loop(pipe, 5, (x0, torch.zeros(1)), predict, update, checkpoint=ck, stop_after=2)
    assert calls == [0, 1] and (tmp_path / "s.npz").exists()
    assert torch.equal(out, torch.full((2,), 4.0))  # 0 -> 0 + 1 -> 1 + 3
    calls.clear()
    resumed = denoise_loop(pipe, 5, (x0, torch.zeros(1)), predict, update, checkpoint=RunCheckpoint(ck.path, "fp"))
    assert calls == [2, 3, 4] and not (tmp_path / "s.npz").exists()
    calls.clear()
    whole = denoise_loop(pipe, 5, (x0, torch.zeros(1)), predict, update)
    assert torch.equal(resumed, whole)

    calls.clear()
    cached = denoise_loop(pipe, 4, (x0, torch.zeros(1)), predict, update,
                          compute=np.array([True, False, True, True]))
    assert calls == [0, 2, 3]
    assert torch.equal(cached, torch.full((2,), 18.0))  # 0 -> 1 -> 2 (step 0's 1 again) -> 7 -> 18

    seen = []
    replaced = denoise_loop(pipe, 3, (x0, torch.zeros(1)), predict, update,
                            step_observer=lambda i, lat: seen.append(lat.copy()) or (np.full(2, -1.0) if i == 0
                                                                                     else None))
    assert [s.tolist() for s in seen] == [[1.0, 1.0], [0.0, 0.0], [3.0, 3.0]]  # -1 -> -1 + 1 -> 0 + 3
    assert torch.equal(replaced, torch.full((2,), 3.0))
