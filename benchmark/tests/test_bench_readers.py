"""The ``sample`` driver's traced view and the pipeline's per-layer readers, on a hand-made trace and on a
traced run of the harness at the tiny size."""

import time

import pytest

import tiny
from benchmark import manifest as mf
from benchmark import run
from benchmark.drivers import sample
from benchmark.trace import Trace

CFG = dict(tiny.TINY_DIT)
FORWARD = {"passes": 2, "s_text": 16, "frames": 3, "h": 8, "w": 8}


def _trace(dits, ends, calls=((100.0, 9e6),)):
    ranges = [(a, b, sample.DIT_RANGE) for a, b in dits] + [(a, a, sample.STEP_END_RANGE) for a in ends]
    ranges += [(a, b, sample.CALL_RANGE) for a, b in calls]
    return Trace(0.0, 1e7, [], [], ranges)


def test_pipeline_readers_split_the_calls_prep_from_the_step_loop():
    trace = _trace([(1_000.0, 2_000_000.0), (2_100_000.0, 4_000_000.0)], [2_050_000.0, 4_100_000.0])
    view = sample.view_of(trace, [dict(FORWARD), dict(FORWARD)], 2, CFG)
    assert view.forwards[0]["s_video"] == 3 * 4 * 4
    assert mf.metric_reader("request_prep_ms.sample")(view) == pytest.approx(0.9)
    outside = (4_100_000.0 - 1_000.0) - (1_999_000.0 + 1_900_000.0)
    assert mf.metric_reader("pipeline_overhead_ms.sample")(view) == pytest.approx(outside / 2 / 1e3)


@pytest.mark.parametrize("dits,ends,calls", [
    ([(1.0, 2.0)], [3.0, 4.0], [(0.0, 5.0)]),  # a DiT range missing
    ([(1.0, 2.0), (3.0, 4.0)], [2.5], [(0.0, 5.0)]),  # a step end missing
    ([(1.0, 2.0), (3.0, 4.0)], [2.5, 4.5], []),  # no call range
])
def test_view_refuses_a_trace_that_does_not_match_the_run(dits, ends, calls):
    with pytest.raises(RuntimeError):
        sample.view_of(_trace(dits, ends, calls), [dict(FORWARD), dict(FORWARD)], 2, CFG)


def test_a_traced_tiny_run_reads_the_pipeline_metrics():
    cell = tiny.CELLS[0]
    spec = tiny.tiny_spec(cell)
    c = run.Cell(name=cell, config=spec.config, traffic=spec.traffic, seed=3, seconds=0.2, trace=True, device="cpu",
                 t_process=time.time())
    out = run.execute(c, spec)
    result, view = out["result"], out["run"]["view"]
    assert result["correct"] is True
    assert len(view.forwards) == view.steps == len(view.step_ends) == out["run"]["attempted"]
    assert view.call_start <= view.forwards[0]["start"] <= view.step_ends[0]
    for name in ("pipeline_overhead_ms.sample", "request_prep_ms.sample"):
        assert result["metrics"][name]["value"] > 0
    assert result["device"]["window_s"] > 0
    assert list(result)[-1] == "checks"
