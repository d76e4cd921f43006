"""The port's host tables of the sampling surface against ``alg_tpu``'s:
the step cache's compute mask, the CogVideoX DDIM plan with custom
timesteps and with eta > 0 (and a stochastic trajectory on given noise), and
the SDE-DPM++ plan with a ``dpm_step`` trajectory that carries the previous
x0. Tables within 1e-6 (they are the same float64 numpy, cast to fp32);
trajectories within 1e-6 (the same fp32 arithmetic, term by term)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from alg_tpu.alg.schedule import build_cache_schedule as j_cache
from alg_tpu.schedulers import ddim_cogvideox as JDDIM
from alg_tpu.schedulers import dpm_cogvideox as JDPM

from alg_tpu_torch.alg.schedule import build_cache_schedule
from alg_tpu_torch.schedulers import ddim_cogvideox as TDDIM
from alg_tpu_torch.schedulers import dpm_cogvideox as TDPM

from torch_port_common import one_thread


ATOL = 1e-6
TIMESTEPS = {"spaced": None, "custom": [999, 850, 600, 300, 120, 10]}


@pytest.mark.parametrize("n,interval,strengths", [
    (10, 2, None), (10, 3, None), (7, 2, [1.0, 0.5, 0, 0, 0, 0, 0]), (6, 2, [1.0, 0, 0, 0, 0, 0]),
    (5, 1, None), (4, 8, [0, 0, 0.3, 0]),
], ids=["every-2nd", "every-3rd", "alg-steps-forced", "shipped-interval", "interval-1", "interval-past-the-end"])
def test_cache_schedule_matches_alg_tpu(n, interval, strengths):
    got = build_cache_schedule(n, interval, None if strengths is None else np.array(strengths, np.float32))
    ref = j_cache(n, interval, None if strengths is None else np.array(strengths, np.float32))
    assert got.dtype == bool and np.array_equal(got, ref)
    assert got[0] and got[-1]


def _fields_equal(a, b, names):
    for name in names:
        np.testing.assert_allclose(getattr(b, name), np.asarray(getattr(a, name)), atol=ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("eta", [0.0, 0.5, 1.0], ids=["eta0", "eta0.5", "eta1"])
@pytest.mark.parametrize("ts", list(TIMESTEPS), ids=list(TIMESTEPS))
def test_ddim_plan_matches_alg_tpu(ts, eta):
    ref = JDDIM.make_ddim_plan(JDDIM.CogVideoXDDIMConfig(), 6, TIMESTEPS[ts], eta=eta)
    got = TDDIM.make_ddim_plan(TDDIM.CogVideoXDDIMConfig(), 6, TIMESTEPS[ts], eta=eta)
    assert np.array_equal(got.timesteps, np.asarray(ref.timesteps)) and got.eta == ref.eta
    _fields_equal(ref, got, ("a_t", "b_t", "sqrt_alpha", "sqrt_beta", "sqrt_alpha_prev", "eps_coef", "std"))
    if TIMESTEPS[ts] is not None:
        assert got.timesteps.tolist() == TIMESTEPS[ts]


@pytest.mark.parametrize("ts", list(TIMESTEPS), ids=list(TIMESTEPS))
def test_dpm_plan_matches_alg_tpu(ts):
    ref = JDPM.make_dpm_plan(JDDIM.CogVideoXDDIMConfig(), 6, TIMESTEPS[ts])
    got = TDPM.make_dpm_plan(TDDIM.CogVideoXDDIMConfig(), 6, TIMESTEPS[ts])
    assert np.array_equal(got.timesteps, np.asarray(ref.timesteps))
    _fields_equal(ref, got, ("mult1", "mult2", "mult3", "mult4", "mult_noise", "sqrt_alpha", "sqrt_beta"))
    assert got.mult3[0] == 1.0 and got.mult4[0] == 0.0  # step 0 is first order


def _trajectory(step_fn, n, seed=0):
    """(the port's, alg_tpu's) samples over ``n`` steps of ``step_fn(i,
    model_output, noise, package)`` on the same model outputs and noise."""
    r = np.random.RandomState(seed)
    x = r.randn(2, 3, 4, 5).astype(np.float32)
    t, j = torch.from_numpy(x), jnp.asarray(x)
    for i in range(n):
        out, noise = r.randn(*x.shape).astype(np.float32), r.randn(*x.shape).astype(np.float32)
        t = step_fn(i, t, torch.from_numpy(out), torch.from_numpy(noise), "port")
        j = step_fn(i, j, jnp.asarray(out), jnp.asarray(noise), "jax")
    return t, j


def test_stochastic_ddim_trajectory_matches_alg_tpu():
    plans = {"port": TDDIM.make_ddim_plan(TDDIM.CogVideoXDDIMConfig(), 5, eta=0.7),
             "jax": JDDIM.make_ddim_plan(JDDIM.CogVideoXDDIMConfig(), 5, eta=0.7)}
    mods = {"port": TDDIM, "jax": JDDIM}

    def step(i, x, out, noise, pkg):
        return mods[pkg].ddim_step(plans[pkg], i, out, x, noise=noise)

    t, j = _trajectory(step, 5)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL, rtol=0)
    with pytest.raises(ValueError, match="noise"):
        TDDIM.ddim_step(plans["port"], 0, torch.zeros(1), torch.zeros(1))


def test_dpm_trajectory_matches_alg_tpu():
    """Five ``dpm_step``s, each given the previous step's x0."""
    plans = {"port": TDPM.make_dpm_plan(TDDIM.CogVideoXDDIMConfig(), 5),
             "jax": JDPM.make_dpm_plan(JDDIM.CogVideoXDDIMConfig(), 5)}
    mods, old = {"port": TDPM, "jax": JDPM}, {}

    def step(i, x, out, noise, pkg):
        prev, x0 = mods[pkg].dpm_step(plans[pkg], i, out, x, old.get(pkg, x * 0), noise)
        old[pkg] = x0
        return prev

    t, j = _trajectory(step, 5, seed=1)
    assert np.isfinite(t.numpy()).all()
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL, rtol=0)
    np.testing.assert_allclose(old["port"].numpy(), np.asarray(old["jax"]), atol=ATOL, rtol=0)
