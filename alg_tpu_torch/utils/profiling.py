"""Tracing and step timing (counterpart of ``alg_tpu/utils/profiling.py``).

:func:`trace_to` records a ``torch.profiler`` trace (CPU activity, and CUDA
activity when a card is present) and writes it into a directory as a Chrome
trace file, which ``chrome://tracing`` or Perfetto opens; no TensorBoard
package is needed. :class:`StepTimer` times named sections on the host's
clock, with :meth:`StepTimer.sync` draining the device's queue first.

The JAX package's ``StepTimer.measure_fetch_latency`` is left out: it
measures the round trip of a remote TPU link, which a CUDA device does not
have (``torch.cuda.synchronize`` is a true barrier).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, List

import torch


@contextlib.contextmanager
def trace_to(log_dir: str):
    """``torch.profiler`` trace of the block, written to
    ``log_dir/trace_<pid>_<ns>.json`` when the block ends; yields the
    profiler. Synchronise the device inside the block so that its last
    kernels land in the trace."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def _first_tensor(x):
    if isinstance(x, torch.Tensor):
        return x
    items = x.values() if isinstance(x, dict) else x if isinstance(x, (list, tuple)) else ()
    for item in items:
        found = _first_tensor(item)
        if found is not None:
            return found
    return None


class StepTimer:
    """Wall-clock section timer with device synchronisation.

    Usage::

        timer = StepTimer()
        with timer.section("encode"):
            z = encode(...)
            timer.sync(z)          # wait for the device's queue to drain
        print(timer.report())
    """

    def __init__(self):
        self.sections: Dict[str, List[float]] = {}

    def sync(self, x=None) -> None:
        """``torch.cuda.synchronize`` for the device of ``x``'s first tensor
        (a tensor or a dict, list or tuple of them) when it is a CUDA
        tensor, or for the current device when ``x`` is None and CUDA is in
        use; nothing on the CPU."""
        if x is None:
            if torch.cuda.is_available() and torch.cuda.is_initialized():
                torch.cuda.synchronize()
            return
        t = _first_tensor(x)
        if t is not None and t.is_cuda:
            torch.cuda.synchronize(t.device)

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        yield
        self.sections.setdefault(name, []).append(time.perf_counter() - t0)

    def report(self) -> str:
        rows = {
            name: {"count": len(ts), "total_s": round(sum(ts), 4), "mean_s": round(sum(ts) / len(ts), 4)}
            for name, ts in self.sections.items()
        }
        return json.dumps(rows)
