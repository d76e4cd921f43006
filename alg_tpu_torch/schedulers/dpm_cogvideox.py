"""CogVideoX DPM scheduler, the SDE-DPM-Solver++(2M) variant (counterpart of
``alg_tpu/schedulers/dpm_cogvideox.py``).

diffusers ``CogVideoXDPMScheduler``, which the reference pipeline runs when a
checkpoint ships it: the CogVideoX DDIM noise schedule (SNR shift,
zero-terminal-SNR), the model output converted to x0, then

    λ_t    = log(sqrt(ā_t / (1 - ā_t)));  h = λ_prev - λ_t;  r = h_last / h
    mult1  = sqrt((1 - ā_prev) / (1 - ā_t))·exp(-h)
    mult2  = expm1(-2h)·sqrt(ā_prev)
    σ_n    = sqrt(1 - ā_prev)·sqrt(1 - exp(-2h))
    D      = (1 + 1/(2r))·x0 - (1/(2r))·x0_old       (x0 alone on step 0)
    prev   = mult1·sample - mult2·D + σ_n·noise

The previous step's x0 (``old_pred_original_sample`` in the reference loop)
is carried by the caller's loop. Every scalar is a numpy ``[T]`` table built
once per run; the per-step noise is drawn by the caller ahead of the loop.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from alg_tpu_torch.schedulers.ddim_cogvideox import CogVideoXDDIMConfig, make_alphas_cumprod, make_timesteps


@dataclasses.dataclass(frozen=True)
class CogVideoXDPMPlan:
    """Per-step coefficient tables of one run (``[T]`` each, float32)."""

    timesteps: np.ndarray  # int64
    mult1: np.ndarray
    mult2: np.ndarray
    mult3: np.ndarray  # 1 + 1/(2r); 1 on step 0
    mult4: np.ndarray  # 1/(2r); 0 on step 0
    mult_noise: np.ndarray
    sqrt_alpha: np.ndarray
    sqrt_beta: np.ndarray
    prediction_type: str


def make_dpm_plan(cfg: CogVideoXDDIMConfig, num_inference_steps: int, timesteps=None) -> CogVideoXDPMPlan:
    """``timesteps``: a custom descending grid in place of the configured
    spacing (its length is the step count)."""
    ac = make_alphas_cumprod(cfg)
    if timesteps is not None:
        ts = np.asarray(timesteps, dtype=np.int64)
        num_inference_steps = len(ts)
    else:
        ts = make_timesteps(cfg, num_inference_steps)
    final_alpha = 1.0 if cfg.set_alpha_to_one else float(ac[0])
    prev_ts = ts - cfg.num_train_timesteps // num_inference_steps
    a_t = ac[ts]
    a_prev = np.where(prev_ts >= 0, ac[np.clip(prev_ts, 0, None)], final_alpha)
    # the "back" timestep is the previous iteration's; step 0 has none
    a_back = np.concatenate([[a_t[0]], a_t[:-1]])

    # step 0: a_back == a_t gives 0/0 with a zero-terminal-SNR ā = 0; its
    # second-order coefficients are overwritten below
    with np.errstate(divide="ignore", invalid="ignore"):
        lam = np.log(np.sqrt(a_t / (1.0 - a_t)))
        lam_prev = np.log(np.sqrt(a_prev / np.maximum(1.0 - a_prev, 1e-20)))
        lam_back = np.log(np.sqrt(a_back / (1.0 - a_back)))
        h = lam_prev - lam
        r = (lam - lam_back) / h

    mult1 = np.sqrt((1.0 - a_prev) / (1.0 - a_t)) * np.exp(-h)
    mult2 = np.expm1(-2.0 * h) * np.sqrt(a_prev)
    mult_noise = np.sqrt(1.0 - a_prev) * np.sqrt(1.0 - np.exp(-2.0 * h))
    mult3 = 1.0 + 1.0 / (2.0 * r)
    mult4 = 1.0 / (2.0 * r)
    mult3[0], mult4[0] = 1.0, 0.0  # first-order update on step 0 (D = x0)

    f32 = lambda x: np.asarray(x, dtype=np.float32)
    return CogVideoXDPMPlan(timesteps=ts, mult1=f32(mult1), mult2=f32(mult2), mult3=f32(mult3), mult4=f32(mult4),
                            mult_noise=f32(mult_noise), sqrt_alpha=f32(np.sqrt(a_t)), sqrt_beta=f32(np.sqrt(1.0 - a_t)),
                            prediction_type=cfg.prediction_type)


def dpm_step(plan: CogVideoXDPMPlan, i: int, model_output: torch.Tensor, sample: torch.Tensor,
             old_pred_x0: torch.Tensor, noise: torch.Tensor):
    """One SDE-DPM++ step; returns ``(prev_sample, pred_x0)``. ``old_pred_x0``
    is the previous step's ``pred_x0`` (ignored on step 0); ``noise`` is the
    step's standard-normal draw, shaped like ``sample``."""
    c = lambda tab: float(tab[i])
    if plan.prediction_type == "v_prediction":
        x0 = c(plan.sqrt_alpha) * sample - c(plan.sqrt_beta) * model_output
    elif plan.prediction_type == "epsilon":
        x0 = (sample - c(plan.sqrt_beta) * model_output) / c(plan.sqrt_alpha)
    else:
        x0 = model_output
    denoised_d = c(plan.mult3) * x0 - c(plan.mult4) * old_pred_x0
    prev = c(plan.mult1) * sample - c(plan.mult2) * denoised_d + c(plan.mult_noise) * noise
    return prev, x0
