"""UniPC multistep scheduler, flow-sigma variant (counterpart of
``alg_tpu/schedulers/unipc.py``; Wan's sampler).

The diffusers ``UniPCMultistepScheduler`` configuration Wan runs with:
``use_flow_sigmas``, ``prediction_type="flow_prediction"``, ``predict_x0``,
``solver_order=2``, ``solver_type="bh2"``, ``lower_order_final`` and a
``flow_shift``.

UniPC's predictor (UniP) and corrector (UniC) updates are linear
combinations of the current sample, the stored x0 predictions and the fresh
x0 prediction, with scalar weights that depend only on the sigma grid and
the step index. Every linear system is therefore solved on the host at plan
time, in float64, and rounded to fp32 coefficient tables; a step is a few
fused multiply-adds over a small ring of x0 buffers that the host loop
carries.

    hh = -h,  φ₁ = expm1(hh),  B_h = expm1(hh) (bh2) | hh (bh1)
    UniP:  x_{i+1} = (σ_{i+1}/σ_i)·x − α_{i+1}·φ₁·m_i − α_{i+1}·B_h·Σ_k ρᵖ_k·(m_{i−k}−m_i)/r_k
    UniC:  x_i ← (σ_i/σ_{i−1})·x_{i−1} − α_i·φ₁·m_{i−1}
                 − α_i·B_h·[Σ_k ρᶜ_k·(m_{i−1−k}−m_{i−1})/r_k + ρᶜ_last·(m_i−m_{i−1})]

with m the x0 predictions (flow: m = sample − σ·v), λ = log((1−σ)/σ),
h = λ_next − λ_cur, r_k = (λ_{−k} − λ_cur)/h, and ρ solved from the
Vandermonde-in-r system R ρ = b (b_j = j!·φ_{j+1}/B_h).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class UniPCConfig:
    num_train_timesteps: int = 1000
    solver_order: int = 2
    flow_shift: float = 1.0
    solver_type: str = "bh2"  # bh1 | bh2
    lower_order_final: bool = True
    use_flow_sigmas: bool = True
    prediction_type: str = "flow_prediction"


def _lambda(sig: float) -> float:
    return float(np.log(1.0 - sig) - np.log(sig))


def _phi_b_coeffs(h: float, order: int, solver_type: str):
    """b vector of the UniPC system for the signed step hh = -h (predict_x0)."""
    hh = -h
    h_phi_1 = np.expm1(hh)
    b_h = np.expm1(hh) if solver_type == "bh2" else hh
    b = []
    h_phi_k = h_phi_1 / hh - 1.0
    factorial_i = 1.0
    for j in range(1, order + 1):
        b.append(h_phi_k * factorial_i / b_h)
        factorial_i *= j + 1
        h_phi_k = h_phi_k / hh - 1.0 / factorial_i
    return np.array(b, dtype=np.float64), h_phi_1, b_h


def _solve_rhos(r_ks: np.ndarray, b: np.ndarray, order: int, corrector: bool) -> np.ndarray:
    """ρ weights; diffusers special-cases the small orders to closed forms."""
    rks = np.concatenate([r_ks, [1.0]])
    if corrector:
        if order == 1:
            return np.array([0.5])
        big_r = np.stack([rks ** j for j in range(order)])  # R[j, k] = r_k^j
        return np.linalg.solve(big_r, b)
    if order == 1:
        return np.zeros(0)
    if order == 2:
        return np.array([0.5])
    big_r = np.stack([rks ** j for j in range(order)])
    return np.linalg.solve(big_r[:-1, :-1], b[:-1])


@dataclasses.dataclass(frozen=True)
class UniPCPlan:
    """Host-side tables (numpy), one row per step."""

    timesteps: np.ndarray  # [T] int64 (diffusers casts flow timesteps to int)
    sigmas: np.ndarray  # [T+1] float32
    # predictor
    p_cx: np.ndarray  # [T]   σ_{i+1}/σ_i
    p_cm0: np.ndarray  # [T]  α_{i+1}·φ₁
    p_cd: np.ndarray  # [T, order-1]  α_{i+1}·B_h·ρᵖ_k / r_k  (0-padded)
    # corrector (row i corrects the sample arriving at step i)
    c_mask: np.ndarray  # [T]  1.0 where the corrector applies (i ≥ 1)
    c_cx: np.ndarray  # [T]   σ_i/σ_{i-1}
    c_cm0: np.ndarray  # [T]  α_i·φ₁(h_c)
    c_cd: np.ndarray  # [T, order-1]  α_i·B_h·ρᶜ_k / r_k  (0-padded)
    c_ct: np.ndarray  # [T]  α_i·B_h·ρᶜ_last
    solver_order: int
    init_noise_sigma: float = 1.0


class UniPCState(NamedTuple):
    """Solver state carried by the host loop.

    ``m``: x0-prediction history ``(m_{i-1}, m_{i-2}, ..., m_{i-order})``
    (zeros before they exist: their plan coefficients are zero then).
    ``last_sample``: the corrected sample of the previous step (UniC input)."""

    m: Tuple[torch.Tensor, ...]
    last_sample: torch.Tensor


def make_unipc_plan(cfg: UniPCConfig, num_inference_steps: Optional[int] = None,
                    sigmas: Optional[Sequence[float]] = None) -> UniPCPlan:
    if not cfg.use_flow_sigmas:
        raise NotImplementedError("Only the flow-sigma UniPC variant is implemented (Wan path)")
    if sigmas is None:
        n = num_inference_steps
        alphas = np.linspace(1.0, 1.0 / cfg.num_train_timesteps, n + 1, dtype=np.float64)
        sig = 1.0 - alphas
        sig = np.flip(cfg.flow_shift * sig / (1.0 + (cfg.flow_shift - 1.0) * sig))[:-1].copy()
    else:
        sig = np.asarray(sigmas, dtype=np.float64)
        n = len(sig)
    timesteps = (sig * cfg.num_train_timesteps).astype(np.int64)
    sig_full = np.concatenate([sig, [0.0]])

    order = cfg.solver_order
    lam = [(_lambda(s) if s > 0 else np.inf) for s in sig_full]

    # per-step orders (diffusers warm-up and lower_order_final semantics)
    p_order = [min(order, i + 1, (n - i) if cfg.lower_order_final else order) for i in range(n)]
    c_order = [p_order[i - 1] if i > 0 else 1 for i in range(n)]

    p_cx, p_cm0, p_cd = np.zeros(n), np.zeros(n), np.zeros((n, max(order - 1, 1)))
    c_mask, c_cx, c_cm0 = np.zeros(n), np.zeros(n), np.zeros(n)
    c_cd, c_ct = np.zeros((n, max(order - 1, 1))), np.zeros(n)

    for i in range(n):
        # predictor: σ_i → σ_{i+1}
        s_cur, s_next = sig_full[i], sig_full[i + 1]
        a_next = 1.0 - s_next
        if s_next == 0.0:
            # terminal step: λ→∞, φ₁→−1, B_h→−1; the update degenerates to x = m_i
            p_cx[i] = 0.0
            p_cm0[i] = -1.0
        else:
            h = lam[i + 1] - lam[i]
            b, h_phi_1, b_h = _phi_b_coeffs(h, p_order[i], cfg.solver_type)
            r_ks = np.array([(lam[i - k] - lam[i]) / h for k in range(1, p_order[i])])
            rhos_p = _solve_rhos(r_ks, b, p_order[i], corrector=False)
            p_cx[i] = s_next / s_cur
            p_cm0[i] = a_next * h_phi_1
            for k in range(1, p_order[i]):
                p_cd[i, k - 1] = a_next * b_h * rhos_p[k - 1] / r_ks[k - 1]

        # corrector: recompute the arrival at σ_i from σ_{i-1}
        if i > 0:
            c_mask[i] = 1.0
            s_prev = sig_full[i - 1]
            a_cur = 1.0 - s_cur
            h_c = lam[i] - lam[i - 1]
            oc = c_order[i]
            b, h_phi_1, b_h = _phi_b_coeffs(h_c, oc, cfg.solver_type)
            r_ks = np.array([(lam[i - 1 - k] - lam[i - 1]) / h_c for k in range(1, oc)])
            rhos_c = _solve_rhos(r_ks, b, oc, corrector=True)
            c_cx[i] = s_cur / s_prev
            c_cm0[i] = a_cur * h_phi_1
            for k in range(1, oc):
                c_cd[i, k - 1] = a_cur * b_h * rhos_c[k - 1] / r_ks[k - 1]
            c_ct[i] = a_cur * b_h * rhos_c[-1]

    def f32(x):
        return np.asarray(x, dtype=np.float32)

    return UniPCPlan(timesteps=timesteps, sigmas=f32(sig_full), p_cx=f32(p_cx), p_cm0=f32(p_cm0), p_cd=f32(p_cd),
                     c_mask=f32(c_mask), c_cx=f32(c_cx), c_cm0=f32(c_cm0), c_cd=f32(c_cd), c_ct=f32(c_ct),
                     solver_order=order)


def unipc_init_state(plan: UniPCPlan, like: torch.Tensor) -> UniPCState:
    """Zero state shaped like the fp32 sample ``like`` (the corrector at
    order o reaches back to m_{i-o}, hence ``solver_order`` buffers)."""
    zeros = torch.zeros_like(like, dtype=torch.float32)
    return UniPCState(m=tuple(zeros.clone() for _ in range(plan.solver_order)), last_sample=zeros)


def unipc_step(plan: UniPCPlan, i: int, model_output: torch.Tensor, sample: torch.Tensor,
               state: UniPCState) -> Tuple[torch.Tensor, UniPCState]:
    """One UniC-then-UniP step; returns ``(prev_sample, new_state)``.

    ``sample`` is the previous predictor's output at σ_i and ``model_output``
    the model's evaluation at (sample, t_i). As diffusers' ``step()``:
    convert to x0, correct the incoming sample with it, then predict
    σ_{i+1}. The coefficients enter as fp32 scalars."""
    x = sample.float()
    v = model_output.float()

    def c(tab, *idx):
        return float(tab[(i, *idx)])

    m_t = x - float(plan.sigmas[i]) * v  # flow_prediction → x0
    m_hist = list(state.m)  # m_hist[0] = m_{i-1}, [1] = m_{i-2}, ...
    m0 = m_hist[0]

    if plan.c_mask[i] > 0:
        corr = c(plan.c_cx) * state.last_sample - c(plan.c_cm0) * m0
        res = c(plan.c_ct) * (m_t - m0)
        for k in range(1, plan.solver_order):
            res = res + c(plan.c_cd, k - 1) * (m_hist[k] - m0)
        x_used = corr - res
    else:
        x_used = x

    prev = c(plan.p_cx) * x_used - c(plan.p_cm0) * m_t
    for k in range(1, plan.solver_order):
        prev = prev - c(plan.p_cd, k - 1) * (m_hist[k - 1] - m_t)

    return prev.to(sample.dtype), UniPCState(m=tuple([m_t] + m_hist[:-1]), last_sample=x_used)
