"""The port's spans (``alg_tpu_torch/utils/profiling.py``) on the CPU at tiny
sizes: off while no ``torch.profiler`` session records (no span, no
``record_function`` call, no CUDA event), and under one a request, its
prepare, one ``denoise.step`` a step, one ``dit.forward`` a computed step
with its passes, the CogVideoX DiT's blocks and stages, consistent parent
and request ids, each span a range of the profiler's trace; the latents
bit for bit the same either way; Wan, HunyuanVideo and ``serve_batch``
requests; a recomputed block's spans under remat."""

import os
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from alg_tpu_torch.alg.schedule import LPConfig, build_lp_plan
from alg_tpu_torch.core.remat import remat_blocks
from alg_tpu_torch.models.cogvideox.transformer import CogVideoXTransformer, CogVideoXTransformerConfig
from alg_tpu_torch.models.cogvideox.vae import CogVideoXVAE, CogVideoXVAEConfig
from alg_tpu_torch.pipelines.cogvideox import CogVideoXPipeline
from alg_tpu_torch.utils import profiling

from torch_port_common import build_hunyuan_pair, build_wan_pair, one_thread  # noqa: F401  (one torch thread)

STEPS = 4
ALG = dict(use_low_pass_guidance=True, lp_filter_type="down_up", lp_filter_in_latent=True, lp_resize_factor=0.25,
           lp_strength_schedule_type="interval", schedule_interval_start_time=0.0, schedule_interval_end_time=0.4)
# the attention's gated residuals run with norm2 in one launch, under its block.norm
STAGES = ["block.norm", "block.attention", "block.norm", "block.ff", "block.gate"]


@pytest.fixture(scope="module")
def pipe():
    torch.manual_seed(0)
    tcfg = CogVideoXTransformerConfig(num_attention_heads=2, attention_head_dim=16, in_channels=8, out_channels=4,
                                      time_embed_dim=16, text_embed_dim=12, num_layers=2, sample_height=4,
                                      sample_width=4, max_text_seq_length=4)
    vcfg = CogVideoXVAEConfig(block_out_channels=(8, 16, 16, 32), latent_channels=4, layers_per_block=1,
                              norm_num_groups=4)
    return CogVideoXPipeline(transformer=CogVideoXTransformer(tcfg).requires_grad_(False),
                             vae=CogVideoXVAE(vcfg).requires_grad_(False), device="cpu")


def _kwargs(**over):
    r = np.random.RandomState(7)
    return {**dict(image=r.uniform(-1, 1, (1, 3, 32, 32)).astype(np.float32),
                   prompt_embeds=torch.from_numpy(r.randn(1, 4, 12).astype(np.float32)),
                   negative_prompt_embeds=torch.from_numpy(r.randn(1, 4, 12).astype(np.float32)), height=32,
                   width=32, num_frames=5, num_inference_steps=STEPS, guidance_scale=6.0, output_type="latent",
                   **ALG), **over}


def _traced(call):
    """(what ``call()`` returns, its span records, the names of the profiler's user ranges)."""
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = call()
    names = {e.name for e in prof.events()}
    return out, profiling.spans(), names


def _children(records, parent, name=None):
    return [r for r in records if r["parent"] == parent["id"] and (name is None or r["name"] == name)]


def _only(records, name):
    found = [r for r in records if r["name"] == name]
    assert len(found) == 1, (name, len(found))
    return found[0]


def test_no_profiler_no_span_no_range_no_event(pipe, monkeypatch):
    """Off, a span makes no ``record_function`` call and no CUDA event, even where CUDA counts as in use."""
    calls = {"record_function": 0, "event": 0}
    real = torch.autograd.profiler.record_function

    def counting_range(*args, **kwargs):
        calls["record_function"] += 1
        return real(*args, **kwargs)

    class CountingEvent:
        def __init__(self, **kwargs):
            calls["event"] += 1

        def record(self):
            pass

        def elapsed_time(self, other):
            return 0.0

    monkeypatch.setattr(torch.autograd.profiler, "record_function", counting_range)
    monkeypatch.setattr(torch.cuda, "Event", CountingEvent)
    monkeypatch.setattr(profiling, "_cuda_in_use", lambda: True)
    profiling.clear()
    pipe(**_kwargs())
    assert profiling.spans() == [] and calls == {"record_function": 0, "event": 0}
    # the same patches do see a recording span's range and events
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("probe"):
            pass
    assert calls == {"record_function": 1, "event": 2}
    assert profiling.spans()[-1]["clock"] == "cuda"


def test_profiled_call_records_request_steps_forwards_and_blocks(pipe):
    _, recs, ranges = _traced(lambda: pipe(**_kwargs()))
    request = _only(recs, "pipeline.request")
    assert request["attrs"] == dict(family="cogvideox", rows=1, frames=5, height=32, width=32, steps=STEPS)
    assert request["parent"] is None
    assert all(r["request"] == request["id"] for r in recs)
    ids = {r["id"]: r for r in recs}
    for r in recs:  # each child opens after its parent and closes before it, on the host's clock
        assert r["device_ms"] is not None and r["device_ms"] >= 0 and r["clock"] == "host"
        if r is not request:
            p = ids[r["parent"]]
            assert p["host_start_ns"] <= r["host_start_ns"] <= r["host_end_ns"] <= p["host_end_ns"]
    assert {r["name"] for r in recs} <= ranges  # every span is a range of the profiler's trace

    prepare = _only(recs, "pipeline.prepare")
    steps = _children(recs, request, "denoise.step")
    assert prepare["parent"] == request["id"] and _only(recs, "vae.encode")["parent"] == prepare["id"]
    assert prepare["host_end_ns"] <= steps[0]["host_start_ns"]
    assert [s["attrs"] for s in steps] == [dict(step=i, computed=True) for i in range(STEPS)]
    three = build_lp_plan(LPConfig(**ALG), STEPS, 8, 8, exp_shortcut=True).three_pass
    assert three.any() and not three.all()
    forwards = [r for r in recs if r["name"] == "dit.forward"]
    assert len(forwards) == STEPS
    for i, step in enumerate(steps):
        (forward,) = [f for f in forwards if f["parent"] == step["id"]]
        assert forward["attrs"] == dict(passes=3 if three[i] else 2, s_text=4, s_video=2 * 2 * 2)
        assert [c["name"] for c in _children(recs, step)] == (["alg.filter", "dit.forward", "cfg.combine",
                                                               "scheduler.update"])
        assert [c["name"] for c in _children(recs, forward)] == ["dit.embed", "dit.block", "dit.block", "dit.final"]
        for k, block in enumerate(_children(recs, forward, "dit.block")):
            assert block["attrs"] == {"block": k}
            assert [c["name"] for c in _children(recs, block)] == STAGES
            (attention,) = _children(recs, block, "block.attention")
            assert [c["name"] for c in _children(recs, attention)] == ["attention.qkv", "attention.kernel",
                                                                        "attention.out"]
            # the forward records the route it took on the span: "plain" on the CPU
            assert _only(_children(recs, attention), "attention.kernel")["attrs"] == {"route": "plain"}


def test_step_cache_skips_the_forward_span(pipe):
    _, recs, _ = _traced(lambda: pipe(**_kwargs(cache_interval=2, num_inference_steps=5)))
    steps = [r for r in recs if r["name"] == "denoise.step"]
    computed = [s["attrs"]["computed"] for s in steps]
    assert len(steps) == 5 and not all(computed)
    for step, c in zip(steps, computed):
        assert len(_children(recs, step, "dit.forward")) == int(c)


def test_latents_bitwise_equal_with_the_profiler_on_and_off(pipe):
    off = pipe(**_kwargs())
    on, recs, _ = _traced(lambda: pipe(**_kwargs()))
    assert recs and np.array_equal(off, on)


@pytest.mark.parametrize("family", ["wan", "hunyuan"])
def test_wan_and_hunyuan_requests_give_request_step_and_forward_spans(family):
    r = np.random.RandomState(3)
    image = r.uniform(-1, 1, (1, 3, 32, 32)).astype(np.float32)
    if family == "wan":
        _, tpipe = build_wan_pair()
        kw = dict(image=image, prompt="a cat", negative_prompt="", max_sequence_length=7,
                  image_embeds=torch.from_numpy(r.randn(1, 5, 10).astype(np.float32)), guidance_scale=5.0,
                  **dict(ALG, lp_resize_factor=0.4))
    else:
        _, tpipe = build_hunyuan_pair()
        kw = dict(image=image, prompt_embeds=torch.from_numpy(r.randn(1, 7, 12).astype(np.float32)),
                  pooled_prompt_embeds=torch.from_numpy(r.randn(1, 6).astype(np.float32)),
                  prompt_attention_mask=torch.ones(1, 7, dtype=torch.int32), **dict(ALG, lp_resize_factor=0.625))
    _, recs, ranges = _traced(lambda: tpipe(height=32, width=32, num_frames=9, num_inference_steps=3,
                                            output_type="latent", **kw))
    request = _only(recs, "pipeline.request")
    assert request["attrs"] == dict(family=family, rows=1, frames=9, height=32, width=32, steps=3)
    assert _only(recs, "pipeline.prepare")["parent"] == request["id"]
    assert _only(recs, "vae.encode")["request"] == request["id"]
    steps = _children(recs, request, "denoise.step")
    assert len(steps) == 3
    for step in steps:
        (forward,) = _children(recs, step, "dit.forward")
        assert forward["attrs"]["passes"] in (1, 2, 3) and forward["attrs"]["s_video"] > 0
    assert {r["name"] for r in recs} <= ranges


def test_serve_batch_of_two_is_one_request_of_two_rows(tmp_path):
    from alg_tpu_torch import cli as TC
    from alg_tpu_torch import serving as TS
    from alg_tpu_torch.core.config import run_config_from_dict

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
    import make_tiny_checkpoint

    path = str(tmp_path / "TinyCogVideoX")
    make_tiny_checkpoint.build(path)
    cfg = run_config_from_dict({
        "model": {"path": path, "dtype": "float32"},
        "generation": {"height": 32, "width": 32, "num_frames": 5, "num_inference_steps": 2, "guidance_scale": 6.0,
                       "max_sequence_length": 16},
        "alg": ALG, "video": {"fps": 8}})
    pipe = TC.load_pipeline(cfg, device="cpu")
    image = np.random.RandomState(5).randint(0, 256, (32, 32, 3), dtype=np.uint8)
    requests = [TS.BatchRequest(prompt=p, image=image, negative_prompt="", seed=s)
                for p, s in (("a bus", 42), ("the panda", 7))]
    videos, recs, _ = _traced(lambda: TS.serve_batch(pipe, requests, **cfg.pipeline_kwargs))
    assert len(videos) == 2
    assert _only(recs, "pipeline.request")["attrs"]["rows"] == 2
    assert len([r for r in recs if r["name"] == "denoise.step"]) == 2


def test_remat_recomputes_the_blocks_spans(pipe):
    dit = pipe.transformer
    x = torch.randn(1, 2, 8, 8, 8)
    text = torch.randn(1, 4, 12)

    def step():
        dit.requires_grad_(True)
        try:
            with remat_blocks():
                dit(x, text, torch.full((1,), 500.0)).square().mean().backward()
        finally:
            dit.requires_grad_(False)
            dit.zero_grad(set_to_none=True)

    _, recs, _ = _traced(step)
    blocks = [r for r in recs if r["name"] == "dit.block"]
    assert [b["attrs"] for b in blocks] == [{"block": 0}, {"block": 1},
                                            {"block": 1, "recompute": True}, {"block": 0, "recompute": True}]
    again = [r for r in recs if r["attrs"].get("recompute")]
    assert {r["name"] for r in again} == {"dit.block", *STAGES, "attention.qkv", "attention.kernel", "attention.out"}
