"""Flow-matching Euler scheduler (counterpart of
``alg_tpu/schedulers/flow_match_euler.py``; HunyuanVideo's sampler).

The diffusers ``FlowMatchEulerDiscreteScheduler`` configuration
HunyuanVideo runs with: a ``shift`` (7.0 shipped), optional
``invert_sigmas``, and explicit ``sigmas = linspace(1, 0, steps + 1)[:-1]``
from the pipeline.

Sigma grid, built once per run on the host in float64 and rounded to fp32:
    σ_i (linspace or given)  ->  σ' = s·σ / (1 + (s − 1)·σ)
    invert_sigmas: σ <- 1 − σ (ascending grid, terminal 1); else terminal 0
    timesteps = σ' · num_train_timesteps

Step:  x_{i+1} = x_i + (σ_{i+1} − σ_i) · v, one fp32 multiply-add.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class FlowMatchEulerConfig:
    num_train_timesteps: int = 1000
    shift: float = 1.0
    use_dynamic_shifting: bool = False
    invert_sigmas: bool = False


@dataclasses.dataclass(frozen=True)
class FlowMatchEulerPlan:
    timesteps: np.ndarray  # [T] float32
    sigmas: np.ndarray  # [T + 1] float32 (terminal appended)
    init_noise_sigma: float = 1.0


def make_flow_match_euler_plan(cfg: FlowMatchEulerConfig, num_inference_steps: Optional[int] = None,
                               sigmas: Optional[Sequence[float]] = None) -> FlowMatchEulerPlan:
    """The sigma and timestep tables for a step count or for given sigmas."""
    if sigmas is None:
        if num_inference_steps is None:
            raise ValueError("Provide num_inference_steps or sigmas")
        # default grid: timesteps linspace(t_max, 1), σ = t / T
        ts = np.linspace(1.0, cfg.num_train_timesteps, num_inference_steps, dtype=np.float64)[::-1]
        sig = ts / cfg.num_train_timesteps
    else:
        sig = np.asarray(sigmas, dtype=np.float64)
    if not cfg.use_dynamic_shifting:
        sig = cfg.shift * sig / (1.0 + (cfg.shift - 1.0) * sig)
    if cfg.invert_sigmas:
        sig = 1.0 - sig
    terminal = 1.0 if cfg.invert_sigmas else 0.0
    return FlowMatchEulerPlan(timesteps=(sig * cfg.num_train_timesteps).astype(np.float32),
                              sigmas=np.concatenate([sig, [terminal]]).astype(np.float32))


def flow_match_euler_step(plan: FlowMatchEulerPlan, i: int, model_output: torch.Tensor,
                          sample: torch.Tensor) -> torch.Tensor:
    """``x + (σ_{i+1} − σ_i)·v`` in fp32 (the sigma difference taken in
    fp32, as the JAX package takes it), cast back to the sample's dtype."""
    dt = float(plan.sigmas[i + 1] - plan.sigmas[i])
    return (sample.float() + dt * model_output.float()).to(sample.dtype)
