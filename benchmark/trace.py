"""``torch.profiler`` over the measured window, reduced to what the per-layer metrics read.

The profiler's chrome trace is written to a temporary directory (under
``TMPDIR``), read back and removed. The arithmetic follows ``chip_smoke.py``'s
``_profiled``: the window is a named range that ends after a synchronise; the
device is busy where a kernel, copy or fill runs, the union of their
intervals inside the window; an idle gap is an interval between them, named
by the innermost host operation or range that covers its middle.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

WINDOW_RANGE = "benchmark.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class Trace:
    """Times in microseconds on the trace's clock."""

    w0: float
    w1: float
    device: List[Tuple[float, float, str, str]]  # (start, end, category, name), clipped to the window
    host: List[Tuple[float, float, str]]  # host operations and ranges: (start, end, name)
    ranges: List[Tuple[float, float, str]] = field(default_factory=list)  # user ranges (record_function)

    @property
    def window_s(self) -> float:
        return (self.w1 - self.w0) / 1e6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        merged: List[Tuple[float, float]] = []
        for a, b, _, _ in sorted(self.device):
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], b))
            else:
                merged.append((a, b))
        return merged

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def kernels(self, ranges: Optional[List[Tuple[float, float]]] = None):
        """(name, seconds) of each kernel launch, only those that start inside ``ranges`` when given."""
        out = []
        starts = [r[0] for r in ranges] if ranges else None
        for a, b, cat, name in self.device:
            if cat != "kernel" or b <= a:
                continue
            if ranges is not None:
                j = bisect.bisect_right(starts, a) - 1
                if j < 0 or a > ranges[j][1]:
                    continue
            out.append((name, (b - a) / 1e6))
        return out

    def top_kernels(self, n: int = 10):
        totals = {}
        for name, s in self.kernels():
            totals[name] = totals.get(name, 0.0) + s
        return sorted(totals.items(), key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10):
        """The ``n`` longest idle gaps inside the window, each named by what the host was doing."""
        gaps, end = [], self.w0
        for a, b in self.busy_intervals():
            if a > end:
                gaps.append((end, a))
            end = max(end, b)
        if self.w1 > end:
            gaps.append((end, self.w1))
        gaps.sort(key=lambda g: g[0] - g[1])
        host = sorted(self.host + self.ranges)
        out = []
        for a, b in gaps[:n]:
            mid = 0.5 * (a + b)
            covering = [h for h in host if h[0] <= mid <= h[1] and h[2] != WINDOW_RANGE]
            name = min(covering, key=lambda h: h[1] - h[0])[2] if covering else "host outside any operation"
            out.append((f"host: {name}", (b - a) / 1e6))
        return out


@contextlib.contextmanager
def profiled(sync):
    """Profile the body as one window; yields a list that holds the :class:`Trace` once it exits.
    ``sync()`` waits for the device before the window's range closes."""
    from torch.profiler import ProfilerActivity, profile, record_function

    box: list = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW_RANGE):
            yield box
            sync()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    del prof
    events = [e for e in (trace["traceEvents"] if isinstance(trace, dict) else trace) if e.get("ph") == "X"]
    window = next(e for e in events if e.get("cat") == "user_annotation" and e["name"] == WINDOW_RANGE)
    w0, w1 = float(window["ts"]), float(window["ts"]) + float(window["dur"])
    device, host, ranges = [], [], []
    for e in events:
        a, b = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            a, b = max(w0, a), min(w1, b)
            if b > a:
                device.append((a, b, cat, e["name"]))
        elif cat == "user_annotation":
            ranges.append((a, b, e["name"]))
        elif cat in ("cpu_op", "cuda_runtime", "cuda_driver"):
            host.append((a, b, e["name"]))
    box.append(Trace(w0, w1, sorted(device), host, ranges))
