"""CogVideoX DDIM scheduler (counterpart of ``alg_tpu/schedulers/ddim_cogvideox.py``).

diffusers ``CogVideoXDDIMScheduler`` at η = 0: scaled-linear betas,
SNR-shifted alphas_cumprod, zero-terminal-SNR rescale, v-prediction, and
the deterministic update ``prev = a_t·sample + b_t·pred_x0`` with
``a_t = sqrt((1 - ā_prev) / (1 - ā_t))`` and
``b_t = sqrt(ā_prev) - sqrt(ā_t)·a_t``. The per-step coefficients are numpy
tables built once per run; the step is two scalar multiply-adds in torch.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class CogVideoXDDIMConfig:
    """Defaults = THUDM/CogVideoX-5b-I2V shipped scheduler config."""

    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"
    snr_shift_scale: float = 3.0
    rescale_betas_zero_snr: bool = True
    set_alpha_to_one: bool = True
    timestep_spacing: str = "trailing"
    steps_offset: int = 0
    prediction_type: str = "v_prediction"


def make_alphas_cumprod(cfg: CogVideoXDDIMConfig) -> np.ndarray:
    """Training alphas_cumprod after SNR shift and zero-terminal-SNR rescale."""
    t = cfg.num_train_timesteps
    if cfg.beta_schedule == "scaled_linear":
        betas = np.linspace(cfg.beta_start**0.5, cfg.beta_end**0.5, t, dtype=np.float64) ** 2
    elif cfg.beta_schedule == "linear":
        betas = np.linspace(cfg.beta_start, cfg.beta_end, t, dtype=np.float64)
    else:
        raise ValueError(f"Unsupported beta_schedule {cfg.beta_schedule!r}")
    ac = np.cumprod(1.0 - betas)
    s = cfg.snr_shift_scale
    ac = ac / (s + (1.0 - s) * ac)
    if cfg.rescale_betas_zero_snr:
        ab = np.sqrt(ac)
        ab0, abT = ab[0], ab[-1]
        ac = ((ab - abT) * (ab0 / (ab0 - abT))) ** 2
    return ac


def make_timesteps(cfg: CogVideoXDDIMConfig, num_inference_steps: int) -> np.ndarray:
    """Descending inference timestep grid for the configured spacing."""
    t, n = cfg.num_train_timesteps, num_inference_steps
    if cfg.timestep_spacing == "linspace":
        ts = np.linspace(0, t - 1, n).round()[::-1].astype(np.int64)
    elif cfg.timestep_spacing == "leading":
        ts = (np.arange(0, n) * (t // n)).round()[::-1].astype(np.int64) + cfg.steps_offset
    elif cfg.timestep_spacing == "trailing":
        ts = np.round(np.arange(t, 0, -t / n)).astype(np.int64) - 1
    else:
        raise ValueError(f"Unsupported timestep_spacing {cfg.timestep_spacing!r}")
    return ts.copy()


@dataclasses.dataclass(frozen=True)
class CogVideoXDDIMPlan:
    """Per-step coefficient tables of one run (``[T]`` each)."""

    timesteps: np.ndarray  # int64
    a_t: np.ndarray  # float32
    b_t: np.ndarray
    sqrt_alpha: np.ndarray  # sqrt(ā_t)
    sqrt_beta: np.ndarray  # sqrt(1 - ā_t)
    prediction_type: str


def make_ddim_plan(cfg: CogVideoXDDIMConfig, num_inference_steps: int) -> CogVideoXDDIMPlan:
    ac = make_alphas_cumprod(cfg)
    ts = make_timesteps(cfg, num_inference_steps)
    final_alpha = 1.0 if cfg.set_alpha_to_one else float(ac[0])
    prev_ts = ts - cfg.num_train_timesteps // num_inference_steps
    alpha_t = ac[ts]
    alpha_prev = np.where(prev_ts >= 0, ac[np.clip(prev_ts, 0, None)], final_alpha)
    a_t = np.sqrt((1.0 - alpha_prev) / (1.0 - alpha_t))
    b_t = np.sqrt(alpha_prev) - np.sqrt(alpha_t) * a_t
    return CogVideoXDDIMPlan(
        timesteps=ts,
        a_t=a_t.astype(np.float32),
        b_t=b_t.astype(np.float32),
        sqrt_alpha=np.sqrt(alpha_t).astype(np.float32),
        sqrt_beta=np.sqrt(1.0 - alpha_t).astype(np.float32),
        prediction_type=cfg.prediction_type,
    )


def predict_x0(plan: CogVideoXDDIMPlan, i: int, model_output: torch.Tensor, sample: torch.Tensor):
    """Model output -> x0 for the configured prediction type."""
    sa, sb = float(plan.sqrt_alpha[i]), float(plan.sqrt_beta[i])
    if plan.prediction_type == "v_prediction":
        return sa * sample - sb * model_output
    if plan.prediction_type == "epsilon":
        return (sample - sb * model_output) / sa
    if plan.prediction_type == "sample":
        return model_output
    raise ValueError(f"Unsupported prediction_type {plan.prediction_type!r}")


def ddim_step(plan: CogVideoXDDIMPlan, i: int, model_output: torch.Tensor, sample: torch.Tensor):
    """One deterministic (η = 0) DDIM step at step index ``i``."""
    x0 = predict_x0(plan, i, model_output, sample)
    return float(plan.a_t[i]) * sample + float(plan.b_t[i]) * x0
