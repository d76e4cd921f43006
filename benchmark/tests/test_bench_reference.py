"""The plain reference against the port's plain CPU path at tiny widths, step by step through the
harness's own run, and its pieces against the port's."""

import numpy as np
import pytest
import torch

import tiny
from benchmark.reference import sampler

CELLS = tiny.CELLS


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [3, 2**33 + 11])
def test_reference_agrees_with_the_ports_cpu_path(cell, seed):
    """fp32 on both sides: every sampled step and each of its CFG passes within 1e-4 (the norm) of the reference,
    the 3-pass ALG step in the 5b cell and 1.5's padded frames included."""
    out = tiny.run_tiny(cell, seed=seed, seconds=0.2)
    result, run = out["result"], out["run"]
    assert result["correct"] and result["failed"] == 0
    kinds = {"alg_step", "cfg_step"} if "alg" in cell.split(".")[1].split("-")[0] else {"cfg_step"}
    assert set(run["checked_steps"]) == kinds
    for name, check in result["checks"].items():
        assert check["value"] < (1e-4 if name.endswith("l2") else 1e-3), (name, check)


def test_one_point_five_pads_its_latent_frames():
    spec = tiny.tiny_spec("cogvideox1.5-5b-i2v.noalg-81f")
    assert sampler.latent_frames(9, spec.config["vae"], spec.config["transformer"]) == 4
    assert sampler.latent_frames(81, {"temporal_compression_ratio": 4}, {"patch_size_t": 2}) == 22
    assert sampler.latent_frames(49, {"temporal_compression_ratio": 4}, {"patch_size_t": None}) == 13


@pytest.mark.parametrize("steps", [50, 7])
@pytest.mark.parametrize("snr", [3.0, 1.0])
def test_ddim_coefficients_match_the_ports(steps, snr):
    from alg_tpu_torch.schedulers.ddim_cogvideox import CogVideoXDDIMConfig, make_ddim_plan

    sched = dict(tiny.tiny_spec(CELLS[0]).config["scheduler"], snr_shift_scale=snr)
    plan = make_ddim_plan(CogVideoXDDIMConfig(**sched), steps)
    for i in range(steps):
        t, a, b, sa, sb = sampler.ddim_coefficients(sched, steps, i)
        assert t == plan.timesteps[i]
        np.testing.assert_allclose([a, b, sa, sb], [plan.a_t[i], plan.b_t[i], plan.sqrt_alpha[i], plan.sqrt_beta[i]],
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("h,w,f", [(60, 90, 0.25), (96, 170, 0.25), (8, 8, 0.25), (30, 45, 0.625)])
def test_down_up_matches_the_ports_filter(h, w, f):
    from alg_tpu_torch.alg.matrices import apply_filter_matrices, down_up_matrix

    x = torch.randn(1, 2, 3, h, w, generator=torch.Generator().manual_seed(h * w))
    ours = sampler.down_up(x, f)
    theirs = apply_filter_matrices(x, torch.from_numpy(down_up_matrix(h, f)), torch.from_numpy(down_up_matrix(w, f)))
    torch.testing.assert_close(ours, theirs, rtol=1e-5, atol=1e-5)


def test_interval_schedule_of_the_shipped_alg_config():
    alg = tiny.tiny_spec(CELLS[0]).traffic["alg"]
    three = [i for i in range(50) if sampler.lp_strength(i, 50, alg) != 0.0]
    assert three == [0, 1]
    assert sampler.lp_strength(0, 50, {"use_low_pass_guidance": False}) == 0.0
