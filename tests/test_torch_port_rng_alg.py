"""alg_tpu_torch host-side pieces against alg_tpu: the noise stream, the run
config, the ALG filter operators and plan, and the DDIM scheduler.

Tolerances: the noise stream, the plan structure and the DDIM tables are
exact. Operator matrices: atol 1e-5 — the same fp32 formula, but XLA fuses
the sample-position arithmetic differently, which moves some weights by a
few 1e-6 (e.g. the 90 -> 89 resize; most sizes agree to 2e-7). The filter
application and the DDIM step are fp32 ops on the same inputs, atol 1e-5."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from alg_tpu.alg import matrices as JM
from alg_tpu.alg import schedule as JS
from alg_tpu.core.rng import NoiseSource as JaxNoise
from alg_tpu.schedulers import ddim_cogvideox as JD

from alg_tpu_torch.alg import matrices as TM
from alg_tpu_torch.alg import schedule as TS
from alg_tpu_torch.core.rng import NoiseSource
from alg_tpu_torch.schedulers import ddim_cogvideox as TD

MAT_ATOL = 1e-5


def test_noise_source_bit_equal_over_mixed_sequence():
    """Small (<16 values, torch's scalar path) and large (vectorised path)
    draws interleaved, in the pipeline's order (posterior noise [B,C,F,h,w],
    then latents): the port's torch.Generator stream equals the JAX
    package's numpy reimplementation bit for bit."""
    a, b = JaxNoise(seed=42), NoiseSource(seed=42)
    for shape in [(1, 16, 1, 60, 90), (1, 3, 16, 60, 90), (3,), (5, 7), (15,), (33,), (2, 17), (1, 2, 4, 4, 4)]:
        x = a.randn(shape)
        y = b.randn(shape)
        assert y.dtype == torch.float32 and tuple(y.shape) == shape
        np.testing.assert_array_equal(y.numpy(), x)


def test_run_config_matches():
    from alg_tpu.core.config import load_run_config as jax_load

    from alg_tpu_torch.core.config import load_run_config

    a, b = jax_load("configs/cogvideox_alg.yaml"), load_run_config("configs/cogvideox_alg.yaml")
    assert b.pipeline_kwargs == a.pipeline_kwargs
    assert b.model_path == a.model_path and b.video == a.video
    assert b.model_dtype == torch.bfloat16 and b.model_dtype_str == "bfloat16"


@pytest.mark.parametrize("size_in,size_out", [(60, 15), (15, 60), (90, 22), (22, 90), (90, 89), (4, 1), (1, 4), (7, 3)])
def test_bilinear_resize_matrix(size_in, size_out):
    np.testing.assert_allclose(TM.bilinear_resize_matrix(size_in, size_out),
                               JM.bilinear_resize_matrix(size_in, size_out), atol=MAT_ATOL, rtol=0)


@pytest.mark.parametrize("ftype,kw", [
    ("down_up", dict(resize_factor=0.25)),
    ("down_up", dict(resize_factor=0.625)),
    ("down_up", dict(resize_factor=1.0)),
    ("gaussian_blur", dict(blur_sigma=3.0, blur_kernel_size=0.1)),
    ("gaussian_blur", dict(blur_sigma=1.5, blur_kernel_size=4)),
    ("none", {}),
])
def test_filter_matrices(ftype, kw):
    for t, j in zip(TM.filter_matrices(ftype, 60, 90, **kw), JM.filter_matrices(ftype, 60, 90, **kw)):
        np.testing.assert_allclose(t, j, atol=MAT_ATOL, rtol=0)


@pytest.mark.parametrize("cfg", [
    dict(lp_filter_type="down_up", lp_resize_factor=0.25, lp_strength_schedule_type="interval",
         schedule_interval_start_time=0.0, schedule_interval_end_time=0.04),  # shipped config
    dict(lp_filter_type="down_up", lp_strength_schedule_type="linear", schedule_linear_end_time=0.5),
    dict(lp_filter_type="gaussian_blur", lp_strength_schedule_type="exponential", schedule_blur_kernel_size=True),
], ids=["interval", "linear", "exponential"])
def test_lp_plan_matches(cfg):
    # 12 steps for the linear schedule: every step is its own resize, and the
    # JAX package builds each operator through an eager jax.image.resize
    steps = 12 if cfg["lp_strength_schedule_type"] == "linear" else 50
    a = JS.build_lp_plan(JS.LPConfig(use_low_pass_guidance=True, **cfg), steps, 60, 90)
    b = TS.build_lp_plan(TS.LPConfig(use_low_pass_guidance=True, **cfg), steps, 60, 90)
    assert [(s.start, s.stop, s.three_pass) for s in b.segments] == \
        [(s.start, s.stop, s.three_pass) for s in a.segments]
    np.testing.assert_array_equal(b.strengths, a.strengths)
    np.testing.assert_array_equal(b.three_pass, a.three_pass)
    np.testing.assert_array_equal(b.m_idx, a.m_idx)
    np.testing.assert_allclose(b.m_h, a.m_h, atol=MAT_ATOL, rtol=0)
    np.testing.assert_allclose(b.m_w, a.m_w, atol=MAT_ATOL, rtol=0)


def test_lp_plan_inactive():
    b = TS.build_lp_plan(TS.LPConfig(), 4, 8, 8)
    assert not b.active and b.m_h is None
    assert [(s.start, s.stop, s.three_pass) for s in b.segments] == [(0, 4, False)]


def test_apply_filter_matrices():
    r = np.random.RandomState(0)
    x = r.randn(2, 3, 4, 12, 18).astype(np.float32)
    mh, mw = JM.filter_matrices("down_up", 12, 18, resize_factor=0.25)
    ref = np.asarray(JM.apply_filter_matrices(jnp.asarray(x), jnp.asarray(mh), jnp.asarray(mw)))
    out = TM.apply_filter_matrices(torch.from_numpy(x), torch.from_numpy(mh), torch.from_numpy(mw))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("steps", [4, 50])
def test_ddim_plan_and_step(steps):
    a = JD.make_ddim_plan(JD.CogVideoXDDIMConfig(), steps)
    b = TD.make_ddim_plan(TD.CogVideoXDDIMConfig(), steps)
    np.testing.assert_array_equal(b.timesteps, a.timesteps)
    for name in ("a_t", "b_t", "sqrt_alpha", "sqrt_beta"):
        np.testing.assert_array_equal(getattr(b, name), getattr(a, name))
    r = np.random.RandomState(1)
    out, sample = r.randn(2, 3, 4, 6, 6).astype(np.float32), r.randn(2, 3, 4, 6, 6).astype(np.float32)
    for i in (0, steps // 2, steps - 1):
        ref = np.asarray(JD.ddim_step(a, i, jnp.asarray(out), jnp.asarray(sample)))
        got = TD.ddim_step(b, i, torch.from_numpy(out), torch.from_numpy(sample))
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)
