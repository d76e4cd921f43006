"""The port's serving entry points (``alg_tpu_torch/serve_cli.py`` and
``alg_tpu_torch/http_serving.py``) on tiny checkpoints, on the CPU: ``run``
end to end over a JSONL file (a video named by its request and one by its
index), its parser against ``alg_tpu``'s, the mesh and multi-host flags over
gloo ranks (``torch_dist_workers``),
HunyuanVideo's size bucket from the first request's image, and the HTTP
daemon as ``tests/test_http_serving.py`` holds ``alg_tpu``'s: ``/healthz``,
``/generate`` with base64 and path images, a micro-batch of two, equal
videos for equal seeds, and the 400, 404 and 500 answers."""

import base64
import json
import logging
import os
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import alg_tpu.serve_cli as JSC
from alg_tpu.alg.hunyuan_size import get_hunyuan_video_size

import alg_tpu_torch.io.video as TV
import alg_tpu_torch.serve_cli as TSC
from alg_tpu_torch.core.config import run_config_from_dict
from alg_tpu_torch.io import hf_checkpoint as H
from alg_tpu_torch.pipelines.hunyuan import HunyuanVideoPipeline
from alg_tpu_torch.serving import BatchRequest

from torch_port_common import one_thread

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import make_tiny_checkpoint  # noqa: E402

Image = pytest.importorskip("PIL.Image")
yaml = pytest.importorskip("yaml")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMAGE = os.path.join(REPO, "assets", "a red double decker bus driving down a street.jpg")


def _config(path, **generation):
    return {
        "model": {"path": path, "dtype": "float32"},
        "generation": {"height": 32, "width": 32, "num_frames": 5, "num_inference_steps": 2, "guidance_scale": 6.0,
                       "max_sequence_length": 16, **generation},
        "alg": {"use_low_pass_guidance": True, "lp_filter_type": "down_up", "lp_filter_in_latent": True,
                "lp_resize_factor": 0.25, "lp_strength_schedule_type": "interval",
                "schedule_interval_start_time": 0.0, "schedule_interval_end_time": 0.5},
        "video": {"fps": 8},
    }


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """A tiny CogVideoX checkpoint, its YAML config, a 32 x 32 input image
    and a JSONL file of two requests (one names its output)."""
    root = tmp_path_factory.mktemp("serve")
    ckpt = str(root / "TinyCogVideoX")
    make_tiny_checkpoint.build(ckpt)
    img = str(root / "input.png")
    Image.fromarray((np.random.RandomState(0).rand(32, 32, 3) * 255).astype(np.uint8)).save(img)
    cfg = str(root / "tiny.yaml")
    with open(cfg, "w") as f:
        yaml.safe_dump(_config(ckpt), f)
    reqs = root / "requests.jsonl"
    reqs.write_text("\n".join([
        json.dumps({"prompt": "a red bus", "image_path": img, "seed": 42, "output": "bus.mp4"}),
        json.dumps({"prompt": "the panda", "image_path": img, "seed": 7}),
    ]))
    return {"ckpt": ckpt, "config": cfg, "requests": str(reqs), "image": img}


def _args(*argv):
    return TSC.build_parser().parse_args(list(argv))


@pytest.fixture(scope="module")
def served(setup, tmp_path_factory):
    """``main`` over the YAML config and the JSONL file (MJPEG-AVI: no
    ffmpeg): the paths it wrote and its log."""
    out = tmp_path_factory.mktemp("served")
    handler, logger = _Records(), logging.getLogger("alg_tpu_torch.serve_cli")
    logger.addHandler(handler)
    level = logger.level
    logger.setLevel(logging.INFO)  # setLevel, not the attribute: it clears what an earlier run cached of the level
    try:
        with pytest.MonkeyPatch.context() as m:
            m.setattr(TV.shutil, "which", lambda name: None)
            written = TSC.main(["--config", setup["config"], "--requests", setup["requests"], "--output_dir",
                                str(out), "--device", "cpu"])
    finally:
        logger.setLevel(level)
        logger.removeHandler(handler)
    return written, out, "\n".join(handler.lines)


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def test_run_writes_each_requests_video(served):
    """``run`` (through ``main``) over the YAML config and the JSONL file
    writes the video a request names and the one named by its index, two
    different videos, and logs the batch."""
    written, out, log = served
    assert written == [str(out / "bus.avi"), str(out / "001.avi")]
    assert all(os.path.getsize(p) > 0 for p in written)
    assert open(written[0], "rb").read() != open(written[1], "rb").read()
    assert "Batch complete: 2 videos" in log


def test_run_takes_a_parsed_config_and_array_requests(setup, served, tmp_path, monkeypatch):
    """``run(args, config=..., requests=...)`` with uint8 arrays, as on a
    machine without PyYAML or PIL, writes the videos the files give."""
    monkeypatch.setattr(TV.shutil, "which", lambda name: None)
    from_files = served[0]
    pixels = np.asarray(Image.open(setup["image"]).convert("RGB"))
    reqs = [BatchRequest("a red bus", pixels, seed=42), BatchRequest("the panda", pixels, seed=7)]
    with open(setup["config"]) as f:
        config = yaml.safe_load(f)
    from_arrays = TSC.run(_args("--config", "-", "--output_dir", str(tmp_path / "arrays"), "--device", "cpu"),
                          config=config, requests=reqs)
    assert from_arrays == [str(tmp_path / "arrays" / "000.avi"), str(tmp_path / "arrays" / "001.avi")]
    assert [open(p, "rb").read() for p in from_arrays] == [open(p, "rb").read() for p in from_files]


def test_parser_keeps_alg_tpus_flags_and_defaults():
    """Every flag of ``alg_tpu``'s parser, with its default, plus ``--device``
    (cuda) and ``--random_init``."""
    port, ref = vars(_args("--config", "c.yaml")), vars(JSC.build_parser().parse_args(["--config", "c.yaml"]))
    assert {k: v for k, v in port.items() if k in ref} == ref
    assert set(port) - set(ref) == {"device", "random_init"}
    assert port["device"] == "cuda" and port["random_init"] is False


# flag -> the ranks it runs on and what each writes (multi-host: each rank a host of one rank)
MESH_FLAGS = {"--dp": (2, [["bus.avi", "001.avi"], []]), "--sp": (2, [["bus.avi", "001.avi"], []]),
              "--tp": (2, [["bus.avi", "001.avi"], []]), "--sp_mode": (1, [["bus.avi", "001.avi"]]),
              "--multihost": (2, [["bus.avi"], ["001.avi"]])}


@pytest.mark.parametrize("flag", [["--dp", "2"], ["--sp", "2"], ["--tp", "2"], ["--sp_mode", "ring"],
                                  ["--multihost"], ["--quantize", "w8"]])
def test_flags_that_are_not_ported_raise(flag, setup, tmp_path, monkeypatch):
    """The mesh and multi-host flags, once refused (A13), serve both
    requests over gloo ranks: rank 0 writes the videos (under
    ``--multihost`` each host its block), each within 3e-5 of the unsharded
    run's frames (``--tp 2``: the tiny DiT has 2 heads; ``--sp_mode ring``
    alone warns and runs on one rank). A mesh larger than the launch raises
    naming torchrun. ``--quantize``, once refused (A12), serves both
    requests."""
    argv = ["--config", setup["config"], "--requests", setup["requests"], "--output_dir", str(tmp_path), "--device",
            "cpu", *flag]
    if flag[0] == "--quantize":
        assert [os.path.basename(p) for p in TSC.run(_args(*argv))] == ["bus.avi", "001.avi"]
        return
    import torch_dist_workers as W

    world, writes = MESH_FLAGS[flag[0]]
    ranks = W.Ranks(W.cli_run, world, tmp_path / "ranks", "serve_cli", argv)
    frames, write = {}, TV.write_video

    def record(path, video, fps=8):
        frames[os.path.basename(path)] = np.asarray(video)
        return write(path, video, fps=fps)

    monkeypatch.setattr(TV, "write_video", record)
    TSC.run(_args("--config", setup["config"], "--requests", setup["requests"], "--output_dir",
                  str(tmp_path / "single"), "--device", "cpu"))
    got = {}
    for (paths, recorded), want in zip(ranks.results(), writes):
        assert [os.path.basename(p) for p in paths] == want
        got.update(recorded)
    assert set(got) == set(frames)
    for name, video in frames.items():
        np.testing.assert_allclose(got[name], np.asarray(video), atol=3e-5, err_msg=name)
    if flag[0] == "--dp":
        with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
            TSC.run(_args(*argv))


def test_listen_with_multihost_is_refused(setup):
    """``alg_tpu``'s rule: the daemon is single-process, front it with a router for multi-host serving."""
    with pytest.raises(ValueError, match="--listen is single-process"):
        TSC.run(_args("--config", setup["config"], "--listen", "0", "--multihost", "--device", "cpu"))


def test_requests_are_required_without_listen(setup):
    with pytest.raises(ValueError, match="--requests is required unless --listen"):
        TSC.run(_args("--config", setup["config"], "--device", "cpu"))


def test_hunyuan_bucket_comes_from_the_first_request(tmp_path, monkeypatch):
    """With ``video.resolution`` the batch's height and width are
    ``alg_tpu``'s bucket for the FIRST request's image, as a PIL image and
    as a uint8 array (the pipeline's call is stubbed: only its arguments are
    looked at)."""
    root = str(tmp_path / "TinyHunyuanVideo")
    H.write_hunyuan(root)
    seen = []

    def call(self, **kwargs):
        seen.append((kwargs["height"], kwargs["width"]))
        return np.zeros((len(kwargs["prompt_embeds"]), 5, kwargs["height"], kwargs["width"], 3), np.float32)

    monkeypatch.setattr(HunyuanVideoPipeline, "__call__", call)
    monkeypatch.setattr(TV.shutil, "which", lambda name: None)
    config = _config(root, true_cfg_scale=1.0)
    del config["generation"]["height"], config["generation"]["width"]
    config["video"]["resolution"] = "360p"
    wide = Image.open(IMAGE).convert("RGB")
    tall = wide.transpose(Image.ROTATE_90)
    for first, second in ((wide, tall), (tall, wide)):
        pil_reqs = [BatchRequest("a red bus", first), BatchRequest("the panda", second)]
        TSC.run(_args("--config", "-", "--output_dir", str(tmp_path / "out"), "--device", "cpu"), config=config,
                requests=pil_reqs)
        bucket = get_hunyuan_video_size("360p", first)
        assert seen[-1] == bucket
        array_reqs = [BatchRequest("a red bus", np.asarray(first.resize(bucket[::-1]))),
                      BatchRequest("the panda", np.asarray(second.resize(bucket[::-1])))]
        TSC.run(_args("--config", "-", "--output_dir", str(tmp_path / "out"), "--device", "cpu"), config=config,
                requests=array_reqs)
        assert seen[-1] == bucket
    assert seen[0] != seen[2]


# -- the HTTP daemon ------------------------------------------------------------------


@pytest.fixture(scope="module")
def server(setup):
    from alg_tpu_torch.cli import load_pipeline
    from alg_tpu_torch.http_serving import serve_http

    cfg = run_config_from_dict(_config(setup["ckpt"]))
    srv = serve_http(load_pipeline(cfg, device="cpu"), cfg, port=0, max_batch=2, batch_window=1.0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    host, port = srv.server_address[:2]
    yield f"http://{host}:{port}", srv.alg_worker
    srv.alg_worker.shutdown()
    srv.shutdown()
    srv.server_close()
    thread.join(timeout=30)
    srv.alg_worker.join(timeout=30)  # the worker thread ends on shutdown and can be joined
    assert not srv.alg_worker.is_alive()


def _post(url, obj, expect_error=False):
    req = urllib.request.Request(url + "/generate", data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        if not expect_error:
            raise
        return e.code, json.loads(e.read())


def test_healthz(server):
    url, _ = server
    with urllib.request.urlopen(url + "/healthz", timeout=60) as resp:
        obj = json.loads(resp.read())
    assert resp.status == 200
    assert obj["ok"] is True and obj["family"] == "cogvideox" and obj["max_batch"] == 2


def test_generate_b64_and_path_images_and_a_micro_batch(server, setup):
    """Three concurrent requests through a ``max_batch=2`` daemon run as a
    micro-batch of two and one of one, each at its real size; the base64 and
    path forms of one image at one seed give the same video (sent one after
    the other, so each runs alone); another seed gives another video."""
    url, worker = server
    with open(setup["image"], "rb") as f:
        img_b64 = base64.b64encode(f.read()).decode()
    bodies = [{"prompt": "a red bus", "image_b64": img_b64, "seed": 42},
              {"prompt": "a red bus", "image_path": setup["image"], "seed": 42},
              {"prompt": "a red bus", "image_path": setup["image"], "seed": 7}]
    before, results = len(worker.batches), [None] * 3

    def call(i):
        results[i] = _post(url, bodies[i])

    threads = [threading.Thread(target=call, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sorted(worker.batches[before:]) == [1, 2]
    for status, obj in results:
        assert status == 200 and obj["num_frames"] == 5 and base64.b64decode(obj["video_b64"])
    assert {obj["seed"] for _, obj in results} == {42, 7}

    alone = [_post(url, body)[1] for body in bodies]
    assert worker.batches[-3:] == [1, 1, 1]
    assert alone[0]["video_b64"] == alone[1]["video_b64"]
    assert alone[0]["video_b64"] != alone[2]["video_b64"]
    with urllib.request.urlopen(url + "/healthz", timeout=60) as resp:
        assert json.loads(resp.read())["served"] >= 6


def test_bad_request_unknown_path_and_failed_generation(server, setup):
    """400 for a body without an image, 404 for an unknown path, 500 with
    the error for a generation that fails (FLF2V on CogVideoX)."""
    url, _ = server
    status, obj = _post(url, {"prompt": "no image"}, expect_error=True)
    assert status == 400 and "image" in obj["error"]
    with pytest.raises(urllib.error.HTTPError) as exc:
        urllib.request.urlopen(urllib.request.Request(url + "/nope", method="GET"), timeout=60)
    assert exc.value.code == 404
    status, obj = _post(url, {"prompt": "a red bus", "image_path": setup["image"],
                              "last_image_path": setup["image"]}, expect_error=True)
    assert status == 500 and "only supported by the Wan pipeline" in obj["error"]
