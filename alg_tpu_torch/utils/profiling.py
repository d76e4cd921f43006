"""Spans inside the program and the ``torch.profiler`` trace they land in
(counterpart of ``alg_tpu/utils/profiling.py``).

:func:`span` marks a stage of the program: a request, a denoise step, a DiT
forward, a block's stages. It records only while a ``torch.profiler``
session records (:func:`trace_to`, ``serve_cli --profile_dir``,
``train_cli --profile_dir``, or the caller's own ``torch.profiler.profile``);
otherwise it costs one check of the profiler's flag and returns a shared
no-op: no ``record_function`` call, no CUDA event, no allocation.

A recording span is a ``record_function`` range in the profiler's trace,
on the same clock as the kernels, and a record in memory: its name, id,
parent id, request id (the id of the ``pipeline.request`` span it runs
under), attributes, host start and end (``perf_counter_ns``) and two CUDA
events recorded on the current stream at its entry and exit (on the CPU,
the host's clock stands in). Spans nest per thread, so a request served on
a worker thread has its own parents. A span opened while autograd's
backward runs (a checkpointed block recomputed) carries ``recompute=True``.
:func:`spans` returns the records with each span's milliseconds.

:func:`trace_to` writes the Chrome trace, which ``chrome://tracing`` or
Perfetto opens (no TensorBoard package is needed), and beside it the spans
of the block as JSON.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import json
import os
import threading
import time
from typing import List

import torch
from torch.autograd import profiler as _profiler

REQUEST = "pipeline.request"
PREPARE = "pipeline.prepare"

_RECORDS: List[dict] = []  # every recording span since the last clear(), in the order they opened; trace_to clears it
_IDS = itertools.count(1)
_LOCAL = threading.local()


def _stack() -> list:
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


def _cuda_in_use() -> bool:
    return torch.cuda.is_initialized()


def _event():
    """A timing event recorded on the current stream, or None off CUDA."""
    if not _cuda_in_use():
        return None
    event = torch.cuda.Event(enable_timing=True)
    event.record()
    return event


class _Off:
    """What :func:`span` returns while no profiler records."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    """A recording span: a ``record_function`` range and a record in ``_RECORDS``."""

    __slots__ = ("rec", "_range")

    def __init__(self, name: str, attrs: dict):
        self.rec = {"name": name, "attrs": attrs}

    def __enter__(self):
        rec, stack = self.rec, _stack()
        parent = stack[-1].rec if stack else None
        rec["id"] = next(_IDS)
        rec["parent"] = parent["id"] if parent else None
        rec["request"] = rec["id"] if rec["name"] == REQUEST else parent["request"] if parent else None
        if torch._C._current_graph_task_id() != -1:
            rec["attrs"]["recompute"] = True
        self._range = _profiler.record_function(rec["name"])
        self._range.__enter__()
        rec["start_event"] = _event()
        rec["host_start_ns"] = time.perf_counter_ns()
        rec["host_end_ns"] = rec["end_event"] = None
        stack.append(self)
        _RECORDS.append(rec)
        return self

    def __exit__(self, *exc):
        rec = self.rec
        rec["host_end_ns"] = time.perf_counter_ns()
        rec["end_event"] = _event()
        self._range.__exit__(None, None, None)
        stack = _stack()
        if self in stack:
            stack.remove(self)
        return False


def span(name: str, **attrs):
    """A context manager that records the block as the span ``name`` with
    ``attrs`` while a ``torch.profiler`` session records, and does nothing
    otherwise."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, attrs)


def end(name: str) -> None:
    """Close this thread's innermost open span if it is named ``name``; else nothing."""
    stack = _stack() if _profiler._is_profiler_enabled else None
    if stack and stack[-1].rec["name"] == name:
        stack[-1].__exit__(None, None, None)


def annotate(name: str, **attrs) -> None:
    """Add ``attrs``, known only once the span is open, to this thread's
    innermost open span named ``name``, if any."""
    if not _profiler._is_profiler_enabled:
        return
    for open_span in reversed(_stack()):
        if open_span.rec["name"] == name:
            open_span.rec["attrs"].update(attrs)
            return


def request_span(family: str):
    """Decorator of a pipeline's ``__call__``: the call is a
    ``pipeline.request`` span (``family=family``), and its part before the
    denoise loop starts a ``pipeline.prepare`` span inside it, which the
    loop closes (``end(PREPARE)``). Spans the call leaves open when it
    raises are closed with it."""

    def wrap(call):
        @functools.wraps(call)
        def traced(*args, **kwargs):
            if not _profiler._is_profiler_enabled:
                return call(*args, **kwargs)
            stack = _stack()
            depth = len(stack)
            try:
                _Span(REQUEST, {"family": family}).__enter__()
                _Span(PREPARE, {}).__enter__()
                return call(*args, **kwargs)
            finally:
                while len(stack) > depth:
                    stack[-1].__exit__(None, None, None)

        return traced

    return wrap


def clear() -> None:
    """Drop the records gathered so far."""
    _RECORDS.clear()


def spans() -> List[dict]:
    """The records of the spans gathered since the last :func:`clear`, in
    the order they opened, with ``device_ms`` (from the two CUDA events, or
    the host's clock off CUDA; None while the span is open) and ``clock``
    (``"cuda"`` or ``"host"``). Synchronise the device first."""
    out = []
    for rec in list(_RECORDS):
        start, stop = rec["start_event"], rec["end_event"]
        row = {k: v for k, v in rec.items() if k not in ("start_event", "end_event")}
        if start is not None and stop is not None:
            row.update(device_ms=start.elapsed_time(stop), clock="cuda")
        elif rec["host_end_ns"] is not None:
            row.update(device_ms=(rec["host_end_ns"] - rec["host_start_ns"]) / 1e6, clock="host")
        else:
            row.update(device_ms=None, clock=None)
        out.append(row)
    return out


@contextlib.contextmanager
def trace_to(log_dir: str):
    """``torch.profiler`` trace of the block, written to
    ``log_dir/trace_<pid>_<ns>.json`` when the block ends, with the block's
    spans beside it in ``spans_<pid>_<ns>.json``; yields the profiler. The
    span records are cleared when the block starts; the device is
    synchronised when it ends, before the spans' times are read."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    clear()
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if _cuda_in_use():
            torch.cuda.synchronize()
        prof.stop()
        stamp = f"{os.getpid()}_{time.time_ns()}"
        prof.export_chrome_trace(os.path.join(log_dir, f"trace_{stamp}.json"))
        with open(os.path.join(log_dir, f"spans_{stamp}.json"), "w") as f:
            json.dump(spans(), f, default=str)

