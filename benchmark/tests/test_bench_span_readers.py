"""The per-layer readers of the program's own spans (``benchmark/program_spans.py``), on a hand-made span
table and trace, and on a traced run of the harness at the tiny size."""

import time

import pytest

import tiny
from benchmark import manifest as mf
from benchmark import run
from benchmark.drivers import sample
from benchmark.trace import Trace

READERS = ("step_outside_dit_ms.sample", "vae_encode_ms.sample", "dit_norm_gate_share.sample",
           "loop_idle_ms.sample")
FORWARD = {"passes": 2, "s_text": 16, "frames": 3, "h": 8, "w": 8}


def _rec(id_, name, parent, ms, **attrs):
    return {"id": id_, "name": name, "parent": parent, "request": 1, "attrs": attrs, "device_ms": ms,
            "clock": "cuda"}


def _records():
    """A request of two steps: prepare with the frame's encode, then a 3-pass and a 2-pass forward of one block."""
    recs = [{**_rec(1, "pipeline.request", None, 5_000.0), "request": 1}, _rec(2, "pipeline.prepare", 1, 60.0),
            _rec(3, "vae.encode", 2, 40.0, frames=1, h=480, w=720)]
    nid = 4
    for i, (step_ms, fwd_ms) in enumerate(((3_006.0, 3_000.0), (2_004.5, 2_000.0))):
        step, fwd, block = nid, nid + 1, nid + 2
        recs += [_rec(step, "denoise.step", 1, step_ms, step=i, computed=True),
                 _rec(nid + 3, "alg.filter", step, 0.5), _rec(fwd, "dit.forward", step, fwd_ms, passes=3 - i),
                 _rec(block, "dit.block", fwd, fwd_ms - 10, block=0)]
        recs += [_rec(nid + 4 + k, stage, block, ms) for k, (stage, ms) in enumerate(
            (("block.norm", 100.0), ("block.attention", 2000.0), ("block.gate", 50.0), ("block.norm", 100.0),
             ("block.ff", 500.0), ("block.gate", 50.0)))]
        nid += 10
    recs.append({**_rec(nid, "pipeline.request", None, 1.0), "request": nid})  # an earlier request's table...
    return recs[-1:] + recs[:-1]  # ...recorded first


def _view(steps=2, forwards=2):
    """Steps on the profiler's clock at [1e5, 3.1e6] and [3.1e6, 5.1e6] us; the device busy over
    [5e4, 2e6], [2.0005e6, 5.0995e6], and after the loop."""
    ranges = [(1e5, 3.1e6, "denoise.step"), (3.1e6, 5.1e6, "denoise.step"), (0.0, 5.2e6, sample.CALL_RANGE)]
    device = [(0.05e6, 2e6, "kernel", "k"), (2.0005e6, 5.0995e6, "kernel", "k"), (5.1e6, 5.2e6, "kernel", "k")]
    trace = Trace(0.0, 5.2e6, device, [], ranges)
    return sample.View(trace=trace, forwards=[dict(FORWARD)] * forwards, call_start=0.0, step_ends=[], steps=steps,
                       dit_cfg=dict(tiny.TINY_DIT))


@pytest.fixture
def table(monkeypatch):
    from alg_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "spans", _records)


def test_readers_on_a_hand_made_span_table(table):
    view = _view()
    assert mf.metric_reader("step_outside_dit_ms.sample")(view) == pytest.approx((6.0 + 4.5) / 2)
    assert mf.metric_reader("vae_encode_ms.sample")(view) == pytest.approx(40.0)
    assert mf.metric_reader("dit_norm_gate_share.sample")(view) == pytest.approx(600.0 / 5_000.0 * 100.0)
    loop_idle = mf.metric_reader("loop_idle_ms.sample")(view)
    assert loop_idle == pytest.approx((500.0 + 500.0) / 2 / 1e3)  # the gap at 2e6, and the loop's end
    idle = mf.metric_reader("idle_share.sample")(view) / 100.0 * view.trace.window_s * 1e3
    assert loop_idle * view.steps <= idle


@pytest.mark.parametrize("name", READERS)
@pytest.mark.parametrize("steps,forwards", [(3, 2), (2, 1)])
def test_readers_refuse_a_span_table_that_does_not_match_the_window(table, name, steps, forwards):
    assert mf.metric_reader(name)(_view(steps, forwards)) is None


@pytest.mark.parametrize("name", READERS)
def test_readers_report_nothing_for_a_program_without_spans(monkeypatch, name):
    from alg_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "spans")
    assert mf.metric_reader(name)(_view()) is None


def test_a_traced_tiny_run_reads_the_span_metrics():
    cell = tiny.CELLS[0]
    spec = tiny.tiny_spec(cell)
    c = run.Cell(name=cell, config=spec.config, traffic=spec.traffic, seed=2**31 + 11, seconds=0.2, trace=True,
                 device="cpu", t_process=time.time())
    out = run.execute(c, spec)
    result, view = out["result"], out["run"]["view"]
    assert result["correct"] is True
    metrics = {name: result["metrics"][name]["value"] for name in READERS}
    assert metrics["vae_encode_ms.sample"] > 0 and metrics["step_outside_dit_ms.sample"] > 0
    assert 0 < metrics["dit_norm_gate_share.sample"] < 100
    assert metrics["loop_idle_ms.sample"] >= 0
    steps = [a for a, _, name in view.trace.ranges if name == "denoise.step"]
    assert len(steps) == view.steps and view.call_start <= min(steps)
