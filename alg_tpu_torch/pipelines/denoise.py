"""The denoise loop the three pipelines share: run control around a family's
prediction and scheduler update (counterpart of the host loops in
``alg_tpu/pipelines/{cogvideox,wan,hunyuan}.py`` ``_sample``).

Per step, in order: the pipeline's ``interrupt`` flag is read (set, the loop
returns the latents it has); the step's noise prediction is computed, or on
a step the step cache skips, the previous step's is reused; the scheduler
update gives the new carry; a ``step_observer`` sees the latents and may
replace them; the carry may be snapshotted; ``stop_after`` may end the loop.
A finished loop removes its snapshot.

Under a recording profiler (``utils/profiling.py``) the loop's start ends
the request's ``pipeline.prepare`` span, and each step is a
``denoise.step`` span (``computed`` False on a step the cache skips) holding
the prediction, ``scheduler.update``, ``denoise.observer`` (with the copy of
the latents to the host) and ``denoise.checkpoint``.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from alg_tpu_torch.io.runstate import RunCheckpoint
from alg_tpu_torch.utils import profiling
from alg_tpu_torch.utils.profiling import span


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
