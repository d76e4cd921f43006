"""The program's own spans in a traced window (``alg_tpu_torch.utils.profiling``), for the per-layer readers
that read them.

The program records a span (a request, its prepare, a denoise step, a DiT forward, a block's stages) only
while a ``torch.profiler`` session records, as the traced window's does: each is a range of the window's
trace (``view.trace.ranges``) and a record whose ``device_ms`` comes from two CUDA events. A program
without the recorder, or one whose spans do not match the window's steps and DiT forwards, gives None here,
and so each reader that reads them reports nothing.
"""

from __future__ import annotations

from typing import List, Optional

REQUEST, STEP, FORWARD = "pipeline.request", "denoise.step", "dit.forward"


def window_spans(view) -> Optional[List[dict]]:
    """The records of the window's request (the last ``pipeline.request`` recorded), or None where there
    are none, or where their ``denoise.step`` spans are not ``view.steps`` or their ``dit.forward`` spans
    not ``len(view.forwards)``."""
    try:
        from alg_tpu_torch.utils.profiling import spans
    except ImportError:
        return None
    records = spans()
    requests = [r["id"] for r in records if r["name"] == REQUEST]
    if not requests:
        return None
    mine = [r for r in records if r["request"] == requests[-1]]
    if (sum(r["name"] == STEP for r in mine) != view.steps
            or sum(r["name"] == FORWARD for r in mine) != len(view.forwards)):
        return None
    return mine


def enclosing(records: List[dict], rec: dict, name: str) -> Optional[dict]:
    """The innermost record named ``name`` that holds ``rec``, or None."""
    by_id = {r["id"]: r for r in records}
    parent = by_id.get(rec["parent"])
    while parent is not None and parent["name"] != name:
        parent = by_id.get(parent["parent"])
    return parent


def total_ms(records: List[dict], *names: str) -> float:
    return sum(r["device_ms"] for r in records if r["name"] in names)
