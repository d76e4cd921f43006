"""Layer: the device, over the step loop alone. Milliseconds a step in which no kernel, copy or fill runs on
the card (the gaps between the busy intervals of the profiler's timeline), from the first ``denoise.step``
span's start to the last one's end (their ranges, on the profiler's clock), over the steps: the step loop's
share of ``idle_share.sample``, without the request's work before its first step."""

from benchmark import program_spans as ps


def read(view):
    if ps.window_spans(view) is None or view.steps == 0:
        return None
    steps = sorted((a, b) for a, b, name in view.trace.ranges if name == ps.STEP)
    if len(steps) != view.steps:
        return None
    lo, hi = steps[0][0], steps[-1][1]
    idle, end = 0.0, lo
    for a, b in view.trace.busy_intervals():
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        idle += max(0.0, a - end)
        end = max(end, b)
    idle += max(0.0, hi - end)
    return idle / view.steps / 1e3
