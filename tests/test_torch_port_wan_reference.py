"""The Wan path of ``alg_tpu_torch`` against the benchmark's plain float32 reference
(``benchmark/reference/wan_*.py``) at tiny widths on the CPU, in fp32, with seeded random weights in the
published layout: the DiT, the condition encode (whole and through tiles), the UniPC predictor and
corrector with their history, and whole 3-pass and 2-pass steps of ``WanPipeline.__call__``; and the Wan
DiT's spans under ``torch.profiler``.

Both sides compute in float32 from the same weights and inputs; they differ in the order of their
operations (attention in query blocks here, fused products there, the RMS norm's division), so their
results agree to a few float32 roundings of the tensors' scale, 1e-5 of the norm, where computing in a
lower precision (bf16) gives about 1e-2 (``benchmark/tests/test_bench_control.py``)."""

import copy

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import inputs
from benchmark import manifest as mf
from benchmark.drivers import wan as driver
from benchmark.drivers.sample import kind
from benchmark.reference import sampler as ref_sampler
from benchmark.reference import wan_dit, wan_sampler, wan_vae
from benchmark.weights import derive_seed, make_weights
from benchmark.weights_wan import wan_transformer_spec, wan_vae_spec

from alg_tpu_torch.utils import profiling

CELL = "wan2.1-i2v-14b.alg-81f"
TINY_DIT = {"num_attention_heads": 2, "attention_head_dim": 16, "in_channels": 12, "out_channels": 4, "num_layers": 2,
            "ffn_dim": 48, "freq_dim": 16, "text_dim": 24, "image_dim": 20, "patch_size": [1, 2, 2], "eps": 1e-6}
TINY_VAE = {"base_dim": 8, "z_dim": 4, "dim_mult": [1, 2, 4, 4], "num_res_blocks": 1,
            "temperal_downsample": [False, True, True], "latents_mean": [0.1, -0.2, 0.3, 0.0],
            "latents_std": [1.5, 0.8, 1.2, 2.0]}


def _rel(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


def tiny_config():
    """The cell's configuration with the DiT and the VAE cut to tiny widths, all in fp32."""
    cfg = copy.deepcopy(mf.cell_spec(mf.load_manifest(), CELL).config)
    cfg.update(transformer=dict(TINY_DIT), vae=dict(TINY_VAE), dtypes={"transformer": "float32", "vae": "float32"})
    return cfg


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("seed", [1, 2**33 + 7])
def test_dit_matches_the_reference(seed):
    cfg = tiny_config()
    pipe = driver.build_pipeline(cfg, seed, "cpu")
    w = make_weights(wan_transformer_spec(cfg["transformer"]), derive_seed(seed, "dit"), "cpu", torch.float32)
    g = torch.Generator().manual_seed(seed % 1000)
    x = torch.randn((1, 12, 3, 8, 12), generator=g)
    text, image = torch.randn((1, 7, 24), generator=g), torch.randn((1, 5, 20), generator=g)
    from alg_tpu_torch.models.wan.transformer import wan_rope

    cos, sin = (torch.from_numpy(a) for a in wan_rope(pipe.transformer.cfg, 3, 8, 12))
    ours = pipe.transformer(x, torch.tensor([937.0]), text, image, cos, sin)
    ref = wan_dit.forward(w, cfg["transformer"], x, 937, text, image)
    assert ours.shape == ref.shape == (1, 4, 3, 8, 12)
    assert _rel(ours, ref) < 1e-5


@pytest.mark.parametrize("tiled,frames,h,w", [(False, 9, 32, 48), (True, 5, 272, 400)])
def test_condition_encode_matches_the_reference(tiled, frames, h, w):
    """The 20-channel condition, whole and through the program's 256-pixel tiles at a stride of 192
    (2 x 2 and 2 x 3 tiles here), against the reference's plain encode and tiling."""
    cfg = tiny_config()
    pipe = driver.build_pipeline(cfg, 3, "cpu")
    pipe.vae_encode_tiling = tiled
    image = torch.rand((1, 3, h, w), generator=torch.Generator().manual_seed(h)) * 2 - 1
    ours = pipe._build_condition(image.numpy(), 1, frames, None)
    vae_w = make_weights(wan_vae_spec(cfg["vae"]), derive_seed(3, "vae"), "cpu", torch.float32)
    ref = wan_vae.condition(vae_w, cfg["vae"], image, frames, tiled=tiled)
    assert ours.shape == ref.shape == (1, 8, (frames - 1) // 4 + 1, h // 8, w // 8)
    assert torch.equal(ours[:, :4], ref[:, :4])
    assert _rel(ours, ref) < 1e-5
    if tiled:  # the tiles' seams are blended, so whole and tiled encodes differ
        whole = wan_vae.condition(vae_w, cfg["vae"], image, frames, tiled=False)
        assert _rel(whole, ref) > 1e-3


@pytest.mark.parametrize("frames,h,w", [(81, 480, 832), (9, 480, 720), (8, 480, 720), (1, 2048, 2048),
                                        (49, 480, 720), (3, 512, 512)])
def test_the_reference_tiles_the_condition_where_the_program_does(frames, h, w):
    from alg_tpu_torch.models.vae_tiling import auto_tile_encode

    assert wan_vae.tiles_the_condition(frames, h, w) == auto_tile_encode(frames, h, w)


@pytest.mark.parametrize("steps", [50, 6])
def test_unipc_steps_with_their_history_match_the_reference(steps):
    """Predictor and corrector of every step, the warm-up at order 1 and the final step included."""
    from alg_tpu_torch.schedulers.unipc import UniPCConfig, make_unipc_plan, unipc_init_state, unipc_step

    sched = tiny_config()["scheduler"]
    plan = make_unipc_plan(UniPCConfig(**sched), steps)
    solver = wan_sampler.UniPC(sched, steps)
    np.testing.assert_array_equal(plan.timesteps, solver.timesteps)
    np.testing.assert_allclose(plan.sigmas, solver.sigmas, rtol=1e-6, atol=0)
    g = torch.Generator().manual_seed(steps)
    x = torch.randn((1, 4, 2, 3, 5), generator=g)
    carry, state, x_ref = (x, unipc_init_state(plan, x)), wan_sampler.UniPCState(), x.clone()
    for i in range(steps):
        v = torch.randn(x.shape, generator=g)
        carry = unipc_step(plan, i, v, *carry)
        x_ref, state = solver.step(state, i, v, x_ref)
        assert _rel(carry[0], x_ref) < 1e-5, i
        x_ref = carry[0].clone()  # each step from the program's sample, as the benchmark's check does


def test_pipeline_steps_match_the_reference():
    """A 3-pass ALG step with history (step 1) and a 2-pass step (step 2) of ``WanPipeline.__call__``
    over 6 steps with ALG over [0, 0.2], each recomputed by the reference from the latents the program
    held before it and the UniPC history rebuilt from the program's DiT outputs of the earlier steps."""
    cfg = tiny_config()
    traffic = {**mf.cell_spec(mf.load_manifest(), CELL).traffic, "height": 32, "width": 48, "num_frames": 9,
               "text_tokens": 7, "image_tokens": 5, "num_inference_steps": 6}
    seed = 2**31 + 11
    pipe = driver.build_pipeline(cfg, seed, "cpu")
    req = driver.request(seed, cfg, traffic, "cpu", pipe.dtype)
    noise = inputs.SeededNoise(seed, "noise", "cpu")
    obs, out, outputs, _ = driver.window(pipe, driver.call_kwargs(traffic), float("inf"), noise, req, "cpu", False)
    assert len(obs.latents) == len(outputs) == 6 and np.array_equal(out, obs.latents[-1])
    assert [o.shape[0] for o in outputs] == [3, 3, 2, 2, 2, 2]
    assert [kind(traffic, i) for i in range(3)] == ["alg_step", "alg_step", "cfg_step"]
    ref = driver.Reference(cfg, traffic, seed, "cpu", noise, req)
    numbers = driver.check(ref, obs, outputs, {"alg_step": 1, "cfg_step": 2})
    assert set(numbers) == {f"{k}.{n}" for k in ("alg_step", "cfg_step") for n in ("l2", "max", "pass_l2", "pass_max")}
    for name, value in numbers.items():
        assert value < (1e-4 if name.endswith("l2") else 1e-3), (name, value)


def test_latent_down_up_and_interval_of_the_shipped_config():
    from alg_tpu_torch.alg.matrices import apply_filter_matrices, down_up_matrix

    alg = mf.cell_spec(mf.load_manifest(), CELL).traffic["alg"]
    assert [i for i in range(50) if ref_sampler.lp_strength(i, 50, alg) != 0.0] == list(range(10))
    x = torch.randn((1, 20, 2, 60, 104), generator=torch.Generator().manual_seed(0))
    ours = apply_filter_matrices(x, torch.from_numpy(down_up_matrix(60, 0.4)), torch.from_numpy(down_up_matrix(104, 0.4)))
    torch.testing.assert_close(ours, ref_sampler.down_up(x, 0.4), rtol=1e-5, atol=1e-5)


def _children(records, parent, name=None):
    return [r for r in records if r["parent"] == parent["id"] and (name is None or r["name"] == name)]


def test_dit_forward_records_its_block_spans_under_the_profiler_and_nothing_without():
    cfg = tiny_config()
    dit = driver.build_pipeline(cfg, 4, "cpu").transformer
    g = torch.Generator().manual_seed(4)
    args = (torch.randn((3, 12, 2, 4, 4), generator=g), torch.tensor([500.0] * 3), torch.randn((3, 7, 24), generator=g),
            torch.randn((3, 5, 20), generator=g), torch.ones(8, 16), torch.zeros(8, 16))
    profiling.clear()
    off = dit(*args)
    assert profiling.spans() == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = dit(*args)
    assert torch.equal(off, on)
    recs, ranges = profiling.spans(), {e.name for e in prof.events()}
    assert {r["name"] for r in recs} <= ranges
    top = [r for r in recs if r["parent"] is None]
    assert [r["name"] for r in top] == ["dit.embed", "dit.block", "dit.block", "dit.final"]
    assert [r["attrs"]["block"] for r in top[1:3]] == [0, 1]
    for block in top[1:3]:
        assert [r["name"] for r in _children(recs, block)] == [
            "block.norm", "block.attention", "block.norm", "attention.cross", "block.norm", "block.ff",
            "block.gate"]  # the residual adds before norm2 and the MLP's norm run in the norms' launches
        (attention,) = _children(recs, block, "block.attention")
        stages = _children(recs, attention)
        assert [r["name"] for r in stages] == ["attention.qkv", "attention.kernel", "attention.out"]
        assert stages[1]["attrs"] == {"route": "plain"}
        (cross,) = _children(recs, block, "attention.cross")
        assert _children(recs, cross) == []
