"""One denoise step of the Wan 2.1 I2V sampler with ALG, in plain float32 PyTorch.

- Flow sigmas (diffusers ``UniPCMultistepScheduler`` with ``use_flow_sigmas``):
  ``1 - linspace(1, 1/T, n + 1)``, shifted to ``s·σ / (1 + (s - 1)·σ)``, reversed,
  the last dropped, and a final 0; timesteps ``int(σ·T)``.
- UniPC (``predict_x0``, ``solver_type="bh2"``, ``lower_order_final``), written
  after diffusers' ``step``, ``multistep_uni_c_bh_update`` and
  ``multistep_uni_p_bh_update``: the model output converted to the x0
  prediction ``m = x - σ·v``; from the second step on, the incoming sample
  corrected (UniC, at the previous step's order) from the last sample and
  the x0 history; then the predictor (UniP) to the next sigma, at an order
  that warms up from 1 and falls back to 1 on the last step. Scalars in
  float64, tensors in float32.
- ALG (``lp_utils``, ``benchmark.reference.sampler``): the interval
  schedule's strength and the ``down_up`` filter over the whole 20-channel
  condition, mask channels included.
- CFG: where the strength is nonzero 3 passes ``[uncond(clean condition),
  uncond(filtered), text(filtered)]`` combined as ``u_init + g·(t - u)``;
  else 2 passes ``[uncond, text]`` on the clean condition.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import wan_dit
from benchmark.reference.sampler import down_up, lp_strength


def flow_sigmas(sched: dict, num_steps: int):
    """(sigmas ``[n + 1]`` float64 ending in 0, timesteps ``[n]`` int64)."""
    t_train = sched["num_train_timesteps"]
    sig = 1.0 - np.linspace(1.0, 1.0 / t_train, num_steps + 1)
    shift = sched["flow_shift"]
    sig = np.flip(shift * sig / (1.0 + (shift - 1.0) * sig))[:-1].copy()
    return np.concatenate([sig, [0.0]]), (sig * t_train).astype(np.int64)


class UniPCState:
    """The solver's history: the x0 predictions so far (oldest first, at most the solver's order), the
    last (corrected) sample, how many steps have run (up to the order) and the last predictor's order."""

    def __init__(self, m: list[torch.Tensor] | None = None, last_sample: torch.Tensor | None = None, steps: int = 0,
                 order: int = 0):
        self.m, self.last_sample, self.steps, self.order = m or [], last_sample, steps, order


class UniPC:
    def __init__(self, sched: dict, num_steps: int):
        if not (sched["use_flow_sigmas"] and sched["prediction_type"] == "flow_prediction"
                and sched["solver_type"] == "bh2"):
            raise ValueError("the reference implements flow sigmas, flow prediction and bh2 only")
        self.sigmas, self.timesteps = flow_sigmas(sched, num_steps)
        self.order, self.lower_order_final, self.n = sched["solver_order"], sched["lower_order_final"], num_steps

    def _lambda(self, i: int) -> float:
        s = self.sigmas[i]
        return math.inf if s == 0 else math.log(1.0 - s) - math.log(s)

    def _weights(self, h: float, rks: list[float], order: int, corrector: bool):
        """(φ₁ = expm1(-h), B_h, ρ) of the bh2 system ``R ρ = b``; diffusers takes ρ = [0.5] for a
        second-order predictor and a first-order corrector."""
        hh = -h
        h_phi_1 = math.expm1(hh)
        b_h = h_phi_1
        rks = np.array(rks + [1.0])
        big_r, b, h_phi_k, fact = [], [], h_phi_1 / hh - 1.0, 1.0
        for j in range(1, order + 1):
            big_r.append(rks ** (j - 1))
            b.append(h_phi_k * fact / b_h)
            fact *= j + 1
            h_phi_k = h_phi_k / hh - 1.0 / fact
        big_r, b = np.stack(big_r), np.array(b)
        if corrector:
            rhos = np.array([0.5]) if order == 1 else np.linalg.solve(big_r, b)
        elif order == 1:
            rhos = np.zeros(0)
        else:
            rhos = np.array([0.5]) if order == 2 else np.linalg.solve(big_r[:-1, :-1], b[:-1])
        return h_phi_1, b_h, rhos

    def _update(self, i_from: int, i_to: int, x, m: list[torch.Tensor], order: int, m_new=None):
        """``x`` carried from sigma ``i_from`` to ``i_to`` with the x0 history ``m`` (its last entry
        at ``i_from``): UniP, or with ``m_new`` (the fresh x0 at ``i_to``) UniC."""
        s_to, s_from = self.sigmas[i_to], self.sigmas[i_from]
        alpha_to = 1.0 - s_to
        m0 = m[-1]
        if s_to == 0:  # the last step: lambda is infinite and the update is the x0 prediction
            if order != 1 or m_new is not None:
                raise ValueError("the last step is first order and is not corrected")
            return m0
        lam_from = self._lambda(i_from)
        h = self._lambda(i_to) - lam_from
        rks = [(self._lambda(i_from - k) - lam_from) / h for k in range(1, order)]
        h_phi_1, b_h, rhos = self._weights(h, rks, order, corrector=m_new is not None)
        out = (s_to / s_from) * x - (alpha_to * h_phi_1) * m0
        res = 0.0
        for k in range(1, order):
            res = res + float(rhos[k - 1]) * (m[-(k + 1)] - m0) / rks[k - 1]
        if m_new is not None:
            res = res + float(rhos[-1]) * (m_new - m0)
        return out - (alpha_to * b_h) * res

    def step(self, state: UniPCState, i: int, v: torch.Tensor, x: torch.Tensor):
        """Step ``i`` from the sample ``x`` with the guided velocity ``v``: (the next sample, the state after)."""
        m_t = x - float(self.sigmas[i]) * v
        if i > 0 and state.last_sample is not None:
            x = self._update(i - 1, i, state.last_sample, state.m, state.order, m_new=m_t)
        m = (state.m + [m_t])[-self.order:]
        order = min(self.order, self.n - i) if self.lower_order_final else self.order
        order = min(order, state.steps + 1)
        nxt = self._update(i, i + 1, x, m, order)
        return nxt, UniPCState(m=m, last_sample=x, steps=min(state.steps + 1, self.order), order=order)


def combine(passes, g: float) -> torch.Tensor:
    """The guided velocity of a step's CFG passes (float32)."""
    passes = [p.float() for p in passes]
    if len(passes) == 3:
        return passes[0] + g * (passes[2] - passes[1])
    return passes[0] + g * (passes[1] - passes[0])


def guidance(traffic: dict) -> float:
    """The CFG scale as the program takes it, a float32 number."""
    return float(np.float32(traffic["guidance_scale"]))


def replay(solver: UniPC, g: float, xs, passes) -> UniPCState:
    """The solver's state before step ``len(xs)``, rebuilt from the sample each earlier step started
    from (``xs[k]``) and that step's CFG passes, combined here with the scale ``g``."""
    state = UniPCState()
    for k, (x, p) in enumerate(zip(xs, passes)):
        _, state = solver.step(state, k, combine(p, g), x.float())
    return state


@torch.no_grad()
def step(dit_w, dit_cfg: dict, solver: UniPC, traffic: dict, i: int, x: torch.Tensor, state: UniPCState,
         cond_clean: torch.Tensor, negative: torch.Tensor, prompt: torch.Tensor, image, lowp: bool = False):
    """Step ``i`` from latents ``x`` ``[1, z, F, h, w]`` with the solver's ``state``: (the next latents,
    the model term: the update less the same update with the guided velocity set to zero, the list
    of the CFG passes' DiT outputs in the order above). ``lowp``: the DiT's products in float8."""
    alg = traffic.get("alg", {})
    strength = lp_strength(i, traffic["num_inference_steps"], alg)
    t = int(solver.timesteps[i])

    def model(c, text):
        return wan_dit.forward(dit_w, dit_cfg, torch.cat([x, c], dim=1), t, text, image, lowp=lowp)

    if strength != 0.0:
        cond = down_up(cond_clean, 1.0 - (1.0 - alg["lp_resize_factor"]) * strength)
        passes = [model(cond_clean, negative), model(cond, negative), model(cond, prompt)]
    else:
        passes = [model(cond_clean, negative), model(cond_clean, prompt)]
    x_next, _ = solver.step(state, i, combine(passes, guidance(traffic)), x)
    x_zero, _ = solver.step(state, i, torch.zeros_like(x), x)
    return x_next, x_next - x_zero, passes
