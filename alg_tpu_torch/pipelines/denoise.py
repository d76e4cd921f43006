"""The denoise loop and the guidance the three pipelines share: run control
around a family's prediction and scheduler update (counterpart of the host
loops in ``alg_tpu/pipelines/{cogvideox,wan,hunyuan}.py`` ``_sample``), and
the CFG/ALG passes a prediction is made of.

Per step, in order: the pipeline's ``interrupt`` flag is read (set, the loop
returns the latents it has); the step's noise prediction is computed, or on
a step the step cache skips, the previous step's is reused; the scheduler
update gives the new carry; a ``step_observer`` sees the latents and may
replace them; the carry may be snapshotted; ``stop_after`` may end the loop.
A finished loop removes its snapshot.

:class:`Guidance` holds one request's passes: a step runs 1 pass (no CFG),
2 (``[uncond, text]``) or, where ALG's plan says and the family allows it,
3 (``[uncond(clean condition), uncond(filtered), text(filtered)]``), batched
negative first and combined as ``uncond + g·(text − uncond)``, the 3-pass
step's first pass taking the first ``uncond``'s place. Which condition a
pass gets, and when a family filters it, stay with the family.

Under a recording profiler (``utils/profiling.py``) the loop's start ends
the request's ``pipeline.prepare`` span, and each step is a
``denoise.step`` span (``computed`` False on a step the cache skips) holding
the prediction (with its ``alg.filter`` and ``cfg.combine``),
``scheduler.update``, ``denoise.observer`` (with the copy of the latents to
the host) and ``denoise.checkpoint``.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from alg_tpu_torch.alg.schedule import LPPlan, build_cache_schedule
from alg_tpu_torch.io.runstate import RunCheckpoint
from alg_tpu_torch.utils import profiling
from alg_tpu_torch.utils.profiling import span


def check_cache_interval(cache_interval) -> int:
    """``cache_interval`` as an int; below 1 it is refused."""
    cache_interval = int(cache_interval)
    if cache_interval < 1:
        raise ValueError(f"cache_interval must be >= 1, got {cache_interval}")
    return cache_interval


class Guidance:
    """One request's CFG/ALG passes over its ALG ``plan``.

    ``cfg``: the request runs classifier-free guidance (2 passes a step);
    ``three_pass``: the family lets the plan's ALG steps run 3. ``passes``:
    each step's count, ``counts`` the distinct ones. The plan's filter
    operators are put on ``device`` once."""

    def __init__(self, plan: LPPlan, device, cfg: bool, three_pass: bool):
        self.plan = plan
        self.passes = np.where(plan.three_pass & three_pass, 3, 2 if cfg else 1)  # a step's passes
        self.counts = sorted(set(self.passes.tolist()))
        if plan.active:
            self.m_h = torch.from_numpy(plan.m_h).to(device)
            self.m_w = torch.from_numpy(plan.m_w).to(device)

    @staticmethod
    def stack(rows: tuple, n: int) -> torch.Tensor:
        """One batch of an ``n``-pass step's inputs from the three passes'
        ``rows`` (``[uncond(clean), uncond(filtered), text(filtered)]``):
        the last ``n`` of them; one pass takes its row as it is."""
        return rows[-1] if n == 1 else torch.cat(rows[3 - n:])

    def filter(self, i: int, op: Callable, x, *args) -> torch.Tensor:
        """Step ``i``'s filtered condition, ``op(x, m_h, m_w, *args)`` with
        the step's operator pair: ``apply_filter_matrices`` on a latent
        condition, or a family's pixel-space rebuild from the frame."""
        j = int(self.plan.m_idx[i])
        with span("alg.filter", strength=float(self.plan.strengths[i])):
            return op(x, self.m_h[j], self.m_w[j], *args)

    @staticmethod
    def combine(pred: torch.Tensor, g: float, n: int) -> torch.Tensor:
        """The noise prediction of an ``n``-pass step's batch ``pred``."""
        if n == 1:
            return pred
        with span("cfg.combine"):
            parts = pred.chunk(n)
            return parts[0] + g * (parts[-1] - parts[-2])

    def compute(self, num_steps: int, cache_interval: int) -> Optional[np.ndarray]:
        """The step cache's compute mask, or None without the cache."""
        if cache_interval > 1:
            return build_cache_schedule(num_steps, cache_interval, self.plan.strengths)
        return None


def denoise_loop(pipe, num_steps: int, carry: tuple, predict: Callable, update: Callable, *,
                 compute: Optional[np.ndarray] = None, checkpoint: Optional[RunCheckpoint] = None,
                 step_observer: Optional[Callable] = None, stop_after: Optional[int] = None) -> torch.Tensor:
    """Run steps ``0 .. num_steps - 1`` (from a snapshot's step on a resume)
    and return the final latents.

    ``carry``: ``(latents, *scheduler state)``; with the step cache
    (``compute``, the mask of :func:`alg_tpu_torch.alg.schedule.build_cache_schedule`)
    the previous prediction rides at its end, so that a snapshot holds it.
    ``predict(i, latents) -> noise_pred``; ``update(i, carry, noise_pred) ->
    carry`` (without the cached prediction). ``step_observer(i, latents as
    numpy)`` may return replacement latents, the array itself or
    ``{"latents": array}``. ``stop_after``: return once that many steps have
    run (a warm-up run)."""
    if compute is not None:
        carry = carry + (torch.zeros_like(carry[0]),)
    start = 0
    if checkpoint is not None:
        start, carry = checkpoint.restore(carry)
    profiling.end(profiling.PREPARE)
    for i in range(start, num_steps):
        if pipe.interrupt:
            return carry[0]
        computed = compute is None or bool(compute[i])
        with span("denoise.step", step=i, computed=computed):
            noise_pred = predict(i, carry[0]) if computed else carry[-1]
            with span("scheduler.update"):
                if compute is not None:
                    carry = update(i, carry[:-1], noise_pred) + (noise_pred,)
                else:
                    carry = update(i, carry, noise_pred)
            if step_observer is not None:
                with span("denoise.observer"):
                    latents = carry[0]
                    ret = step_observer(i, latents.cpu().numpy())
                    new = ret.get("latents") if isinstance(ret, dict) else ret
                    if new is not None:
                        new = torch.as_tensor(np.asarray(new), dtype=latents.dtype).reshape(latents.shape)
                        carry = (new.to(latents.device),) + carry[1:]
            if checkpoint is not None:
                with span("denoise.checkpoint"):
                    checkpoint.maybe_save(i + 1, carry)
        if stop_after is not None and i + 1 >= stop_after:
            return carry[0]
    if checkpoint is not None:
        checkpoint.complete()
    return carry[0]
