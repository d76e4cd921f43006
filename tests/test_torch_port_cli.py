"""The port's sampling entry point (``alg_tpu_torch/cli.py``) against
``alg_tpu``'s on tiny checkpoints (``tools/make_tiny_checkpoint.py``'s
CogVideoX and HunyuanVideo directories, a Wan one from ``hf_checkpoint``)
and the repository's input image, fp32 on the CPU, 2 steps with latent ALG:
final latents within atol 2e-3 and frames above 40 dB, for CogVideoX also
with ``--lora`` from an ``.npz`` and from a ``.safetensors`` file; the
flags that are not ported raise; a parsed config and an image array run as
a YAML file and an image file do; HunyuanVideo's size buckets; ``main`` and
``--random_init`` write their videos."""

import os
import shutil
import sys

import numpy as np
import pytest
import torch

import alg_tpu.cli as JC
import alg_tpu.io.video as JV
from alg_tpu import pipelines as JP

import alg_tpu_torch.cli as TC
import alg_tpu_torch.io.video as TV
from alg_tpu_torch.io import hf_checkpoint as H
from alg_tpu_torch.io.lora import _COGVIDEOX_BLOCK_MAP
from alg_tpu_torch.pipelines.cogvideox import CogVideoXPipeline
from alg_tpu_torch.pipelines.hunyuan import HunyuanVideoPipeline
from alg_tpu_torch.pipelines.wan import WanPipeline

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import make_tiny_checkpoint  # noqa: E402

from torch_port_common import one_thread


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMAGE = os.path.join(REPO, "assets", "a red double decker bus driving down a street.jpg")
PROMPT = "a red double decker bus driving down the street"


def _config(path, **generation):
    return {
        "model": {"path": path, "dtype": "float32", "flow_shift": 7.0, "flow_reverse": False},
        "generation": {"height": 32, "width": 32, "num_frames": 5, "num_inference_steps": 2, "guidance_scale": 6.0,
                       "max_sequence_length": 16, **generation},
        "alg": {"use_low_pass_guidance": True, "lp_filter_type": "down_up", "lp_filter_in_latent": True,
                "lp_blur_sigma": None, "lp_resize_factor": 0.25, "lp_strength_schedule_type": "interval",
                "schedule_interval_start_time": 0.0, "schedule_interval_end_time": 0.5},
        "video": {"fps": 8},
    }


def _write_yaml(path, config):
    yaml = pytest.importorskip("yaml")
    with open(path, "w") as f:
        yaml.safe_dump(config, f)
    return str(path)


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ckpt") / "TinyCogVideoX")
    make_tiny_checkpoint.build(root)
    return root


@pytest.fixture(scope="module")
def family_ckpts(tiny_ckpt, tmp_path_factory):
    """{family: (checkpoint dir, config)}. The Wan checkpoint takes UMT5-XXL's
    32 buckets and distance 128, which ``alg_tpu``'s loader assumes whatever
    the file says (ROADMAP.md C, R9), so that both packages run one model."""
    root = tmp_path_factory.mktemp("families")
    wan = dict(H.TINY_WAN, text_encoder={**H.TINY_WAN["text_encoder"], "relative_attention_num_buckets": 32,
                                          "relative_attention_max_distance": 128})
    H.write_wan(str(root / "TinyWan"), wan, dtype=torch.float32)
    make_tiny_checkpoint.build_hunyuan(str(root / "TinyHunyuanVideo"))
    wan_cfg = _config(str(root / "TinyWan"), num_frames=9, guidance_scale=5.0)
    wan_cfg["alg"]["lp_resize_factor"] = 0.5
    hy_cfg = _config(str(root / "TinyHunyuanVideo"), true_cfg_scale=1.0)
    hy_cfg["alg"]["lp_resize_factor"] = 0.625
    return {"cogvideox": (tiny_ckpt, _config(tiny_ckpt)), "wan": (str(root / "TinyWan"), wan_cfg),
            "hunyuan": (str(root / "TinyHunyuanVideo"), hy_cfg)}


@pytest.fixture
def captured(monkeypatch):
    """What each package's run hands its decode (the final latents) and
    ``write_video`` (the frames), by package."""
    got = {}

    def keep_write(module, key):
        write = module.write_video

        def wrapped(path, frames, fps):
            got[f"{key}_frames"] = TV._frames_to_uint8(frames)
            return write(path, frames, fps)

        monkeypatch.setattr(module, "write_video", wrapped)

    keep_write(JV, "jax")
    keep_write(TV, "port")

    def keep_latents(cls, key):
        decode = cls.decode_latents

        def kept(self, latents, *args, **kwargs):
            got[f"{key}_latents"] = np.array(latents)
            return decode(self, latents, *args, **kwargs)

        monkeypatch.setattr(cls, "decode_latents", kept)

    for cls in (JP.CogVideoXPipeline, JP.WanPipeline, JP.HunyuanVideoPipeline):
        keep_latents(cls, "jax")
    for cls in (CogVideoXPipeline, WanPipeline, HunyuanVideoPipeline):
        keep_latents(cls, "port")
    monkeypatch.setattr(JV.shutil, "which", lambda name: None)  # the same MJPEG-AVI from both
    monkeypatch.setattr(TV.shutil, "which", lambda name: None)
    return got


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) / 255 - b.astype(np.float64) / 255) ** 2)
    return float("inf") if mse == 0 else 10 * np.log10(1.0 / mse)


def _peft_state(tiny_ckpt, rank=2, seed=0):
    """A peft-layout adapter for every mapped module of the tiny DiT's blocks, B nonzero."""
    from alg_tpu_torch.io.safetensors import load_safetensors_dir

    base = load_safetensors_dir(os.path.join(tiny_ckpt, "transformer"))
    rng = np.random.RandomState(seed)
    state = {}
    for i in range(2):
        for module in _COGVIDEOX_BLOCK_MAP:
            out_dim, in_dim = base[f"transformer_blocks.{i}.{module}.weight"].shape
            state[f"transformer_blocks.{i}.{module}.lora_A.weight"] = (0.1 * rng.randn(rank, in_dim)).astype(np.float32)
            state[f"transformer_blocks.{i}.{module}.lora_B.weight"] = (0.1 * rng.randn(out_dim, rank)).astype(np.float32)
    return state


@pytest.mark.parametrize("family,lora", [("cogvideox", None), ("cogvideox", "npz"), ("cogvideox", "safetensors"),
                                         ("wan", None), ("hunyuan", None)])
def test_run_matches_alg_tpu(family, lora, tiny_ckpt, family_ckpts, captured, tmp_path):
    """``alg_tpu_torch.cli.run`` against ``alg_tpu.cli.run`` over the same
    YAML file, image file and flags, ``--device cpu``: latents within 2e-3,
    frames above 40 dB; with ``--lora`` both merge the adapter and still
    agree."""
    argv = ["--config", _write_yaml(tmp_path / "c.yaml", family_ckpts[family][1]), "--image_path", IMAGE,
            "--prompt", PROMPT]
    if lora is not None:
        state = _peft_state(tiny_ckpt)
        path = str(tmp_path / f"adapter.{lora}")
        if lora == "npz":
            np.savez(path, **state)
        else:
            from safetensors.numpy import save_file

            save_file(state, path)
        argv += ["--lora", path, "--lora_scale", "0.5"]
    JC.run(JC.build_parser().parse_args(argv + ["--output_path", str(tmp_path / "jax.mp4")]))
    out = TC.run(TC.build_parser().parse_args(argv + ["--output_path", str(tmp_path / "port.mp4"),
                                                      "--device", "cpu"]))
    assert out == str(tmp_path / "port.avi") and os.path.getsize(out) > 0
    assert captured["port_latents"].shape == captured["jax_latents"].shape
    err = np.abs(captured["port_latents"] - captured["jax_latents"]).max()
    assert err <= 2e-3, err
    assert captured["port_frames"].shape == ((9 if family == "wan" else 5), 32, 32, 3)
    assert _psnr(captured["port_frames"], captured["jax_frames"]) > 40.0


def test_lora_moves_the_dit(tiny_ckpt, tmp_path):
    """``load_pipeline(lora=...)`` changes exactly the mapped block weights,
    by the same amount from an ``.npz`` and a ``.safetensors`` file."""
    from safetensors.numpy import save_file

    from alg_tpu_torch.core.config import run_config_from_dict

    cfg = run_config_from_dict(_config(tiny_ckpt))
    state = _peft_state(tiny_ckpt, seed=1)
    np.savez(str(tmp_path / "a.npz"), **state)
    save_file(state, str(tmp_path / "a.safetensors"))
    base = TC.load_pipeline(cfg, device="cpu").transformer.state_dict()
    merged = [TC.load_pipeline(cfg, lora=str(tmp_path / f"a.{ext}"), device="cpu").transformer.state_dict()
              for ext in ("npz", "safetensors")]
    moved = {n for n, t in merged[0].items() if not torch.equal(t, base[n])}
    assert moved == {f"blocks.{i}.{m}.weight" for i in range(2)
                     for m in ("attn.to_q", "attn.to_k", "attn.to_v", "attn.to_out", "ff.fc_in", "ff.fc_out",
                               "norm1.linear", "norm2.linear")}
    assert all(torch.equal(merged[0][n], merged[1][n]) for n in moved)


def test_run_with_a_parsed_config_and_an_image_array(tiny_ckpt, captured, tmp_path):
    """``run(args, config=..., image=...)``, as on a machine without PyYAML
    or PIL, gives the frames the YAML file and the image file give (the image
    already at the generated size, so PIL's resize leaves it as it is)."""
    from PIL import Image

    small = Image.open(IMAGE).convert("RGB").resize((32, 32), resample=Image.LANCZOS)
    small.save(tmp_path / "small.png")
    args = ["--output_path", str(tmp_path / "a.mp4"), "--device", "cpu", "--prompt", PROMPT]
    TC.run(TC.build_parser().parse_args(args + ["--config", _write_yaml(tmp_path / "c.yaml", _config(tiny_ckpt)),
                                                "--image_path", str(tmp_path / "small.png")]))
    from_files = captured["port_frames"]
    TC.run(TC.build_parser().parse_args(args), config=_config(tiny_ckpt), image=np.asarray(small))
    assert np.array_equal(captured["port_frames"], from_files)


def test_hunyuan_size_buckets_come_from_the_image(family_ckpts, tmp_path, monkeypatch):
    """With ``video.resolution`` the HunyuanVideo height and width are
    ``alg_tpu``'s bucket for the input image, from an image file and from the
    same image as an array (the pipeline's call is stubbed: only its
    arguments are looked at)."""
    from PIL import Image

    from alg_tpu.alg.hunyuan_size import get_hunyuan_video_size

    seen = []

    def call(self, **kwargs):
        seen.append((kwargs["height"], kwargs["width"]))
        return np.zeros((1, 5, kwargs["height"], kwargs["width"], 3), np.float32)

    monkeypatch.setattr(HunyuanVideoPipeline, "__call__", call)
    monkeypatch.setattr(TV.shutil, "which", lambda name: None)
    config = dict(family_ckpts["hunyuan"][1], video={"fps": 8, "resolution": "360p"})
    args = TC.build_parser().parse_args(["--image_path", IMAGE, "--output_path", str(tmp_path / "h.mp4"),
                                         "--device", "cpu"])
    TC.run(args, config=config)
    image = Image.open(IMAGE).convert("RGB")
    TC.run(args, config=config, image=np.asarray(image.resize(seen[0][::-1])))
    assert seen[0] == get_hunyuan_video_size("360p", image) and seen[1] == seen[0]


def test_flags_that_are_not_ported_raise(tiny_ckpt, tmp_path, captured, monkeypatch):
    """``--quantize``, once refused (ROADMAP A12), runs, and with ``--lora``
    raises ``alg_tpu``'s ``ValueError``. ``--checkpoint_path``, once refused,
    snapshots the denoise loop: a run interrupted after its first step leaves
    the snapshot, and the same command run again resumes it, to the
    uninterrupted run's latents bit for bit, and removes it."""
    from PIL import Image

    args = ["--output_path", str(tmp_path / "x.mp4"), "--device", "cpu"]
    image = np.asarray(Image.open(IMAGE).convert("RGB").resize((32, 32)))
    with pytest.raises(ValueError, match="--lora with --quantize is unsupported"):
        TC.run(TC.build_parser().parse_args(args + ["--quantize", "w8", "--lora", str(tmp_path / "a.npz")]),
               config=_config(tiny_ckpt), image=np.zeros((32, 32, 3), np.uint8))
    assert TC.run(TC.build_parser().parse_args(args + ["--quantize", "w8"]), config=_config(tiny_ckpt),
                  image=image) == str(tmp_path / "x.avi")
    TC.run(TC.build_parser().parse_args(args), config=_config(tiny_ckpt), image=image)
    whole = captured["port_latents"]
    snap = tmp_path / "s.npz"
    resume_args = TC.build_parser().parse_args(args + ["--checkpoint_path", str(snap)])
    call = CogVideoXPipeline.__call__

    def interrupted(self, **kwargs):
        def stop(i, _latents):
            self.interrupt = True

        return call(self, step_observer=stop, **kwargs)

    with monkeypatch.context() as m:
        m.setattr(CogVideoXPipeline, "__call__", interrupted)
        TC.run(resume_args, config=_config(tiny_ckpt), image=image)
    assert snap.exists() and not np.array_equal(captured["port_latents"], whole)
    TC.run(resume_args, config=_config(tiny_ckpt), image=image)
    assert np.array_equal(captured["port_latents"], whole) and not snap.exists()
    with pytest.raises(ValueError, match="family"):
        TC.run(TC.build_parser().parse_args(args), config=_config(str(tmp_path)), image=np.zeros((32, 32, 3)))


def test_parser_keeps_alg_tpus_flags_and_defaults():
    """Every flag of ``alg_tpu``'s parser, with its default, plus ``--device``
    (cuda) and ``--random_init``."""
    port, ref = vars(TC.build_parser().parse_args([])), vars(JC.build_parser().parse_args([]))
    assert {k: v for k, v in port.items() if k in ref} == ref
    assert set(port) - set(ref) == {"device", "random_init"}
    assert port["device"] == "cuda" and port["random_init"] is False


def test_main_writes_the_wan_video_and_random_init_runs(tmp_path, monkeypatch):
    """``main`` over a tiny Wan checkpoint from ``hf_checkpoint`` writes a
    9-frame video; ``--random_init`` over the same directory draws other
    weights at its shapes and writes one too; int8 attention is left as it
    was found."""
    from alg_tpu_torch.ops.attention import get_attention_int8

    root = str(tmp_path / "TinyWan")
    H.write_wan(root)
    monkeypatch.setattr(TV.shutil, "which", lambda name: None)
    frames = []
    write = TV.write_video
    monkeypatch.setattr(TV, "write_video", lambda p, f, fps: frames.append(np.asarray(f)) or write(p, f, fps))
    config = _config(root, num_frames=9, guidance_scale=5.0)
    config["alg"]["lp_resize_factor"] = 0.5
    path = _write_yaml(tmp_path / "wan.yaml", config)
    image = str(tmp_path / "img.png")
    shutil.copy(IMAGE, image)
    for extra in ([], ["--random_init"]):
        out = TC.main(["--config", path, "--image_path", image, "--prompt", PROMPT, "--device", "cpu",
                       "--output_path", str(tmp_path / "wan.mp4")] + extra)
        assert os.path.getsize(out) > 0
    assert frames[0].shape == frames[1].shape == (9, 32, 32, 3)
    assert np.isfinite(frames[0]).all() and not np.array_equal(frames[0], frames[1])
    assert get_attention_int8() is None
