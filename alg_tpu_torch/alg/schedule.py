"""ALG strength schedules and the per-run low-pass plan (counterpart of
``alg_tpu/alg/schedule.py``; host-side numpy).

``get_lp_strength`` reproduces the reference schedules (linear, interval,
exponential, none). The plan holds, per step, the strength, the 2-pass or
3-pass decision and an index into the run's distinct filter operators;
consecutive steps with the same pass count form ``segments``.
"""

from __future__ import annotations

import dataclasses
import logging
import math
from typing import Optional

import numpy as np

from alg_tpu_torch.alg.matrices import filter_matrices

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class LPConfig:
    """ALG kwargs of the reference pipeline ``__call__`` (same defaults)."""

    use_low_pass_guidance: bool = False
    lp_filter_type: str = "none"  # none | down_up | gaussian_blur
    lp_filter_in_latent: bool = True
    lp_blur_sigma: float = 3.0
    lp_blur_kernel_size: object = 0.1  # float = relative to H; int = absolute
    lp_resize_factor: float = 0.25
    lp_strength_schedule_type: str = "none"
    schedule_blur_kernel_size: bool = False
    schedule_interval_start_time: float = 0.0
    schedule_interval_end_time: float = 1.0
    schedule_linear_start_weight: float = 1.0
    schedule_linear_end_weight: float = 0.0
    schedule_linear_end_time: float = 1.0
    schedule_exp_decay_rate: float = 5.0


def get_lp_strength(step_index: int, total_steps: int, cfg: LPConfig) -> float:
    """Low-pass strength multiplier for one step."""
    step_norm = step_index / max(total_steps - 1, 1)
    kind = cfg.lp_strength_schedule_type
    if kind == "linear":
        duration = cfg.schedule_linear_end_time
        if duration <= 0:
            return cfg.schedule_linear_start_weight
        if step_norm >= duration:
            return cfg.schedule_linear_end_weight
        progress = step_norm / duration
        return cfg.schedule_linear_start_weight * (1 - progress) + cfg.schedule_linear_end_weight * progress
    if kind == "interval":
        inside = cfg.schedule_interval_start_time <= step_norm <= cfg.schedule_interval_end_time
        return 1.0 if inside else 0.0
    if kind == "exponential":
        rate = cfg.schedule_exp_decay_rate
        if rate < 0:
            logger.warning("Negative exponential decay rate (%s); using abs value.", rate)
            rate = abs(rate)
        return math.exp(-rate * step_norm)
    if kind != "none":
        logger.warning("Unknown lp_strength_schedule_type %r; using constant 1.0.", kind)
    return 1.0


def modulate_filter_params(cfg: LPConfig, strength: float):
    """Strength -> effective (sigma, kernel_size, resize_factor):
    sigma·s, kernel·s iff ``schedule_blur_kernel_size``, 1 - (1 - f)·s."""
    sigma = cfg.lp_blur_sigma * strength
    ks = cfg.lp_blur_kernel_size * strength if cfg.schedule_blur_kernel_size else cfg.lp_blur_kernel_size
    resize = 1.0 - (1.0 - cfg.lp_resize_factor) * strength
    return sigma, ks, resize


@dataclasses.dataclass(frozen=True)
class LPSegment:
    """A maximal run of consecutive steps sharing a pass count."""

    start: int  # first step (inclusive)
    stop: int  # last step (exclusive)
    three_pass: bool  # True -> [uncond(clean), uncond(LP), text(LP)]


@dataclasses.dataclass(frozen=True)
class LPPlan:
    """Per-step ALG plan of one run.

    ``m_h [U, H, H]`` / ``m_w [U, W, W]`` hold the run's U distinct
    operators and ``m_idx [T]`` maps each step to one; ``three_pass`` is
    strength != 0 (minus the exponential < 0.1 shortcut)."""

    active: bool
    num_steps: int
    strengths: np.ndarray  # [T] float32
    three_pass: np.ndarray  # [T] bool
    m_h: Optional[np.ndarray]
    m_w: Optional[np.ndarray]
    m_idx: Optional[np.ndarray]
    segments: tuple


def _segments_from_mask(three_pass: np.ndarray) -> tuple:
    segs, i, t = [], 0, len(three_pass)
    while i < t:
        j = i
        while j < t and three_pass[j] == three_pass[i]:
            j += 1
        segs.append(LPSegment(start=i, stop=j, three_pass=bool(three_pass[i])))
        i = j
    return tuple(segs)


def build_lp_plan(cfg: LPConfig, num_steps: int, height: int, width: int,
                  exp_shortcut: bool = True) -> LPPlan:
    """The full per-step ALG plan of a ``num_steps`` run over a filtered
    tensor of spatial size ``height`` x ``width``. ``exp_shortcut``: the
    CogVideoX rule that an exponential-schedule step with strength < 0.1
    runs 2-pass."""
    if not cfg.use_low_pass_guidance:
        mask = np.zeros(num_steps, dtype=bool)
        return LPPlan(active=False, num_steps=num_steps, strengths=np.zeros(num_steps, np.float32),
                      three_pass=mask, m_h=None, m_w=None, m_idx=None,
                      segments=_segments_from_mask(mask))

    strengths = np.array([get_lp_strength(i, num_steps, cfg) for i in range(num_steps)], np.float32)
    three_pass = strengths != 0.0
    if exp_shortcut and cfg.lp_strength_schedule_type == "exponential":
        three_pass &= strengths >= 0.1

    unique: dict = {}
    m_idx = np.zeros(num_steps, dtype=np.int32)
    mh_list, mw_list = [], []
    for i in range(num_steps):
        sigma, ks, resize = modulate_filter_params(cfg, float(strengths[i]))
        key = (round(sigma, 12), ks if isinstance(ks, int) else round(float(ks), 12), round(resize, 12))
        if key not in unique:
            mh, mw = filter_matrices(cfg.lp_filter_type, height, width, blur_sigma=sigma,
                                     blur_kernel_size=ks, resize_factor=resize)
            unique[key] = len(mh_list)
            mh_list.append(mh)
            mw_list.append(mw)
        m_idx[i] = unique[key]

    return LPPlan(active=True, num_steps=num_steps, strengths=strengths, three_pass=three_pass,
                  m_h=np.stack(mh_list), m_w=np.stack(mw_list), m_idx=m_idx,
                  segments=_segments_from_mask(three_pass))


def lp_config(args: dict) -> LPConfig:
    """The ``LPConfig`` of a pipeline call's keyword arguments (its
    ``locals()``), each field taken by its name."""
    return LPConfig(**{f.name: args[f.name] for f in dataclasses.fields(LPConfig)})


def request_plan(cfg: LPConfig, num_steps: int, latent_hw: tuple, pixel_hw: tuple, guided: bool = True,
                 exp_shortcut: bool = False) -> LPPlan:
    """A pipeline request's plan: ALG on only where ``guided`` (a family whose
    ALG needs CFG passes whether it runs), the filter at the latent size or,
    for pixel-space ALG, at the frame's."""
    cfg = dataclasses.replace(cfg, use_low_pass_guidance=cfg.use_low_pass_guidance and guided)
    h, w = latent_hw if cfg.lp_filter_in_latent else pixel_hw
    return build_lp_plan(cfg, num_steps, h, w, exp_shortcut=exp_shortcut)


def build_cache_schedule(num_steps: int, cache_interval: int, strengths=None) -> np.ndarray:
    """Compute-step mask ``[T]`` of the opt-in step cache (``cache_interval >
    1``): a full DiT forward on every ``cache_interval``-th step and the last
    step, and on every step of nonzero ALG ``strengths`` (their conditioning
    changes from step to step); the other steps reuse the previous
    prediction. Shared by the three pipelines."""
    compute = np.zeros(num_steps, bool)
    compute[::cache_interval] = True
    compute[-1] = True
    if strengths is not None:
        compute[np.asarray(strengths) != 0.0] = True
    return compute
