"""The Wan cell's harness on the CPU at tiny widths: the ``wan`` driver end to end through
``benchmark.run.execute`` against the plain reference, a broken timed path found, its per-layer readers
on hand-made traces and on a traced run, and ``benchmark/flops_wan.py`` against counts by hand."""

import copy
import time
import types

import pytest

from benchmark import flops, flops_wan
from benchmark import manifest as mf
from benchmark import run
from benchmark.drivers import sample, wan
from benchmark.trace import Trace

CELL = "wan2.1-i2v-14b.alg-81f"
READERS = ("mfu.wan", "flash_fwd_roofline.wan", "rope_roofline.wan", "gemm_roofline.wan",
           "cross_attention_share.wan", "vae_encode_ms.wan", "idle_share.wan")
TINY_DIT = {"num_attention_heads": 2, "attention_head_dim": 16, "in_channels": 12, "out_channels": 4, "num_layers": 2,
            "ffn_dim": 48, "freq_dim": 16, "text_dim": 24, "image_dim": 20, "patch_size": [1, 2, 2], "eps": 1e-6}
TINY_VAE = {"base_dim": 8, "z_dim": 4, "dim_mult": [1, 2, 4, 4], "num_res_blocks": 1,
            "temperal_downsample": [False, True, True], "latents_mean": [0.1, -0.2, 0.3, 0.0],
            "latents_std": [1.5, 0.8, 1.2, 2.0]}


def tiny_spec(steps: int = 12) -> mf.CellSpec:
    """The cell's spec cut to tiny widths in fp32, 9 frames at 32 x 48, 7 text and 5 image tokens, ``steps``
    UniPC steps (ALG's interval as the cell's, so steps 0-2 of 12 are 3-pass)."""
    spec = mf.cell_spec(mf.load_manifest(), CELL)
    cfg = copy.deepcopy(spec.config)
    cfg.update(transformer=dict(TINY_DIT), vae=dict(TINY_VAE), dtypes={"transformer": "float32", "vae": "float32"})
    spec.config = cfg
    spec.traffic = {**spec.traffic, "height": 32, "width": 48, "num_frames": 9, "text_tokens": 7, "image_tokens": 5,
                    "num_inference_steps": steps}
    return spec


def run_tiny(seed: int, seconds: float, trace: bool = False):
    spec = tiny_spec()
    c = run.Cell(name=CELL, config=spec.config, traffic=spec.traffic, seed=seed, seconds=seconds, trace=trace,
                 device="cpu", t_process=time.time())
    return run.execute(c, spec)


@pytest.mark.parametrize("seed", [3, 2**33 + 11])
def test_the_wan_driver_agrees_with_the_reference(seed):
    """fp32 on both sides: the sampled steps and each of their CFG passes within 1e-4 (the norm) and 1e-3
    (the largest element) of the reference; the 3-pass step is judged against the cell's limits."""
    out = run_tiny(seed, seconds=float("inf"))
    result, res = out["result"], out["run"]
    assert result["correct"] and result["failed"] == 0 and result["attempted"] == 12
    assert set(result["checks"]) == {f"alg_step.{n}" for n in ("l2", "max", "pass_l2", "pass_max")}
    assert set(res["checked_steps"]) == {"alg_step", "cfg_step"} and res["checked_steps"]["alg_step"] <= 2
    for name, value in res["numbers"].items():
        assert value < (1e-4 if name.endswith("l2") else 1e-3), (name, value)
    assert set(result["metrics"]) == {"sample_step_s", "setup_s"}


@pytest.mark.parametrize("ends,steps", [([17.0, 31.3, 45.6], 2), ([17.0, 30.95, 44.9], 2), ([15.5, 28.4, 41.3], 2),
                                         ([13.0, 24.0, 35.0], 3), ([10.0, 20.0, 30.0, 40.0], 3)])
def test_the_window_ends_at_the_step_end_nearest_its_seconds(monkeypatch, ends, steps):
    """Step ends in seconds after the call, 31 s asked for: 30.95 ends the window as 31.3 does."""
    clock = iter([0.0] + ends)
    monkeypatch.setattr(sample.time, "perf_counter", lambda: next(clock))
    pipe = types.SimpleNamespace(interrupt=False)
    obs = wan.NearestEnd(pipe, 31.0)
    for i in range(len(ends)):
        if pipe.interrupt:
            break
        obs(i, None)
    assert len(obs.times) == steps and pipe.interrupt


def _update_returns_its_sample(monkeypatch):
    import alg_tpu_torch.pipelines.wan as wan_pipeline

    monkeypatch.setattr(wan_pipeline, "unipc_step", lambda plan, i, model_output, sample, state: (sample, state))


def _filter_left_out(monkeypatch):
    """The 3-pass step's filtered condition is the clean one."""
    import alg_tpu_torch.pipelines.wan as wan_pipeline

    monkeypatch.setattr(wan_pipeline, "apply_filter_matrices", lambda x, m_h, m_w: x)


@pytest.mark.parametrize("fault", [_update_returns_its_sample, _filter_left_out], ids=lambda f: f.__name__[1:])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    result = run_tiny(5, seconds=float("inf"))["result"]
    assert result["correct"] is False and result["failed"] >= 1
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


def _view(forwards, device, ranges=(), steps=1):
    rows = [{"passes": 3, "s_text": 512, "s_image": 257, "s_video": 32760, "start": 0.0, "end": 1e6, **f}
            for f in forwards]
    trace = Trace(0.0, 2e6, device, [], list(ranges))
    return sample.View(trace=trace, forwards=rows, call_start=0.0, step_ends=[], steps=steps,
                       dit_cfg=copy.deepcopy(mf.cell_spec(mf.load_manifest(), CELL).config["transformer"]))


@pytest.mark.parametrize("name", READERS)
def test_readers_report_nothing_where_there_is_nothing_to_read(monkeypatch, name):
    from alg_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "spans", lambda: [])
    assert mf.metric_reader(name)(_view([], [])) is None


def test_kernel_readers_on_a_hand_made_trace():
    cfg = mf.cell_spec(mf.load_manifest(), CELL).config["transformer"]
    device = [(0.0, 5e5, "kernel", "void flash_fwd_tc_kernel<false, false>"),
              (5e5, 5.1e5, "kernel", "void rope_kernel<__nv_bfloat16>"),
              (5.1e5, 8e5, "kernel", "nvjet_tst_192x192_64x4_2x1_v_bz_coopB_bias_TNN"),
              (1.5e6, 1.6e6, "kernel", "nvjet_outside_the_forward")]
    view = _view([{}], device)
    attn = flops_wan.attention_flops_all(cfg, 32760, 512, 257)
    assert mf.metric_reader("flash_fwd_roofline.wan")(view) == pytest.approx(
        3 * attn / flops.PEAK_FLOPS_BF16 / 0.5 * 100)
    rope = 2 * 40 * flops_wan.rope_bytes(3, 40, 32760, 128)
    assert mf.metric_reader("rope_roofline.wan")(view) == pytest.approx(rope / flops.PEAK_BYTES / 0.01 * 100)
    lin = flops_wan.linear_flops(cfg, 32760, 512, 257)
    assert mf.metric_reader("gemm_roofline.wan")(view) == pytest.approx(3 * lin / flops.PEAK_FLOPS_BF16 / 0.29 * 100)
    assert mf.metric_reader("mfu.wan")(view) == pytest.approx(3 * (lin + attn) / 2.0 / flops.PEAK_FLOPS_BF16 * 100)
    assert mf.metric_reader("idle_share.wan")(view) == pytest.approx((2e6 - 9e5) / 2e6 * 100)


def test_cross_attention_share_reads_the_cross_attention_span(monkeypatch):
    from alg_tpu_torch.utils import profiling

    def rec(id_, name, parent, ms):
        return {"id": id_, "name": name, "parent": parent, "request": 1, "attrs": {}, "device_ms": ms, "clock": "cuda"}

    recs = [rec(1, "pipeline.request", None, 9e3), rec(2, "denoise.step", 1, 5e3), rec(3, "dit.forward", 2, 4e3),
            rec(4, "dit.block", 3, 3.9e3), rec(5, "attention.cross", 4, 100.0), rec(6, "vae.encode", 1, 2e3)]
    monkeypatch.setattr(profiling, "spans", lambda: recs)
    view = _view([{}], [])
    assert mf.metric_reader("cross_attention_share.wan")(view) == pytest.approx(2.5)
    assert mf.metric_reader("vae_encode_ms.wan")(view) == pytest.approx(2e3)
    assert mf.metric_reader("cross_attention_share.wan")(_view([{}, {}], [])) is None  # not the window's forwards


def test_a_traced_tiny_run_reads_the_span_and_model_metrics():
    out = run_tiny(2**31 + 5, seconds=0.05, trace=True)
    result, view = out["result"], out["run"]["view"]
    assert result["correct"] is True
    assert len(view.forwards) == view.steps == out["run"]["attempted"]
    assert [f["s_video"] for f in view.forwards] == [3 * 2 * 3] * view.steps  # 9 frames of 32 x 48: 3 x 4 x 6 latents
    assert all(f["s_text"] == 7 and f["s_image"] == 5 for f in view.forwards)
    metrics = {k: v["value"] for k, v in result["metrics"].items()}
    assert 0 < metrics["cross_attention_share.wan"] < 100 and metrics["vae_encode_ms.wan"] > 0
    assert metrics["mfu.wan"] > 0


def test_flops_by_hand_at_the_cells_shape():
    cfg = mf.cell_spec(mf.load_manifest(), CELL).config["transformer"]
    d, s, st, si, ffn = 5120, 21 * 30 * 52, 512, 257, 13824
    assert flops_wan.video_tokens(cfg, 21, 60, 104) == s == 32760
    block = 2 * d * d * (6 * s + 2 * st + 2 * si) + 4 * s * d * ffn
    outside = (2 * s * 36 * 4 * d + 2 * (256 * d + d * d) + 2 * d * 6 * d + 2 * st * (4096 * d + d * d)
               + 2 * si * (1280 * 1280 + 1280 * d) + 2 * s * d * 64)
    assert flops_wan.linear_flops(cfg, s, st, si) == 40 * block + outside
    attn = 40 * 4 * 40 * 128 * (s * s + s * (st + si))
    assert flops_wan.attention_flops_all(cfg, s, st, si) == attn
    assert flops_wan.forward_flops(cfg, s, st, si) == 40 * block + outside + attn
    # a 3-pass step is about 5.06e15 FLOP: about 11.4 s at 45% of 989 TFLOP/s
    assert 5.0e15 < 3 * flops_wan.forward_flops(cfg, s, st, si) < 5.1e15
    assert flops_wan.rope_bytes(3, 40, s, 128) == 2 * 3 * 40 * s * 128 * 2 + 2 * s * 128 * 4
