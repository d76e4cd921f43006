"""The port's latent precompute (``alg_tpu_torch/prepare_cli.py``) against
``alg_tpu.prepare_cli`` on the CPU at a tiny size: the clip readers and
converters with equality; each family's encoder on the same checkpoint, clip
and prompt, both packages in fp32 (every array within atol 1e-4 + rtol 1e-4,
Wan's mask block and Hunyuan's attention mask exact, Wan with and without
FLF2V); ``run`` over a manifest (file names, ``--limit``, ``--video`` with
``--prompt``, the error without either, HunyuanVideo's bucket from the first
clip). CogVideoX and Wan checkpoints come from ``io/hf_checkpoint.py`` (Wan's
UMT5 with UMT5-XXL's 32 buckets and distance 128, which ``alg_tpu``'s loader
assumes), HunyuanVideo's from ``tools/make_tiny_checkpoint.py``."""

import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import alg_tpu.prepare_cli as JPC
from alg_tpu.alg.hunyuan_size import get_hunyuan_video_size
from alg_tpu.io import model_zoo as JZ

from alg_tpu_torch import prepare_cli as TPC
from alg_tpu_torch.io import hf_checkpoint as H
from alg_tpu_torch.io import model_zoo as TZ

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import make_tiny_checkpoint  # noqa: E402

PIL = pytest.importorskip("PIL")
from PIL import Image  # noqa: E402

from torch_port_common import one_thread


PROMPT = "a red double decker bus driving down the street"
MAX_SEQ = 8
ATOL = RTOL = 1e-4


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp("prepare_ckpts")
    wan = dict(H.TINY_WAN, text_encoder={**H.TINY_WAN["text_encoder"], "relative_attention_num_buckets": 32,
                                          "relative_attention_max_distance": 128})
    H.write_cogvideox(str(root / "TinyCogVideoX"), dtype=torch.float32)
    H.write_wan(str(root / "TinyWan"), wan, dtype=torch.float32)
    make_tiny_checkpoint.build_hunyuan(str(root / "TinyHunyuanVideo"))
    return {"cogvideox": str(root / "TinyCogVideoX"), "wan": str(root / "TinyWan"),
            "hunyuan": str(root / "TinyHunyuanVideo")}


@pytest.fixture(scope="module")
def pipes(ckpts):
    """{family: (the port's pipeline, alg_tpu's)}, fp32 on the CPU."""
    return {
        "cogvideox": (TZ.load_cogvideox_pipeline(ckpts["cogvideox"], dtype=torch.float32, device="cpu"),
                      JZ.load_cogvideox_pipeline(ckpts["cogvideox"], dtype=jnp.float32)),
        "wan": (TZ.load_wan_pipeline(ckpts["wan"], dtype=torch.float32, device="cpu"),
                JZ.load_wan_pipeline(ckpts["wan"], dtype=jnp.float32)),
        "hunyuan": (TZ.load_hunyuan_pipeline(ckpts["hunyuan"], dtype=torch.float32, device="cpu"),
                    JZ.load_hunyuan_pipeline(ckpts["hunyuan"], dtype=jnp.float32)),
    }


def _uint8_clip(frames, h=32, w=32, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (frames, h, w, 3)).astype(np.uint8)


# -- input handling -------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["uint8", "unit", "signed", "off_size_uint8", "off_size_unit"])
def test_frames_to_tensor_matches_alg_tpu(kind):
    rng = np.random.RandomState(1)
    shape = (3, 24, 40, 3) if kind.startswith("off_size") else (3, 32, 48, 3)
    if kind.endswith("uint8"):
        arr = rng.randint(0, 256, shape).astype(np.uint8)
    elif kind.endswith("unit"):
        arr = rng.rand(*shape).astype(np.float32)
    else:
        arr = (rng.rand(*shape) * 2 - 1).astype(np.float32)
    got, want = TPC.frames_to_tensor(arr, 32, 48), JPC.frames_to_tensor(arr, 32, 48)
    assert got.shape == want.shape == (3, 3, 32, 48) and got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_load_frames_matches_alg_tpu(tmp_path):
    clip = _uint8_clip(3, 24, 40, seed=2)
    frames_dir = tmp_path / "frames"
    frames_dir.mkdir()
    for i, f in enumerate(clip):
        Image.fromarray(f).save(frames_dir / f"f{i:03d}.png")
    Image.fromarray(clip[0]).save(tmp_path / "one.png")
    np.save(tmp_path / "clip.npy", clip)
    np.savez(tmp_path / "clip.npz", frames=clip)
    for name in ("frames", "one.png", "clip.npy", "clip.npz"):
        got, want = TPC.load_frames(str(tmp_path / name)), JPC.load_frames(str(tmp_path / name))
        assert type(got) is type(want) and len(got) == len(want), name
        if isinstance(want, np.ndarray):
            np.testing.assert_array_equal(got, want)
        else:
            for a, b in zip(got, want):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        # and on through the size conversion (a PIL resize here: 24 x 40 -> 32 x 48)
        np.testing.assert_array_equal(TPC.frames_to_tensor(got, 32, 48), JPC.frames_to_tensor(want, 32, 48))
    with pytest.raises(ValueError, match="unsupported"):
        TPC.load_frames(str(tmp_path / "clip.mp4"))


def test_coerce_frames_matches_alg_tpu():
    arr = np.random.RandomState(3).rand(7, 3, 8, 8).astype(np.float32)
    got = TPC.coerce_frames(arr)
    assert got.shape[0] == 5
    np.testing.assert_array_equal(got, JPC.coerce_frames(arr))
    assert TPC.coerce_frames(arr[:5]).shape[0] == 5 and TPC.coerce_frames(arr[:1]).shape[0] == 1


def test_off_size_array_without_pil_names_pil(monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    arr = _uint8_clip(2, 16, 16)
    assert TPC.frames_to_tensor(arr, 16, 16).shape == (2, 3, 16, 16)  # at the size: no PIL needed
    with pytest.raises(ImportError, match="PIL"):
        TPC.frames_to_tensor(arr, 32, 32)


# -- encode parity ----------------------------------------------------------------------


def _close(got, want, key):
    assert got.shape == want.shape and got.dtype == want.dtype, (key, got.shape, want.shape, got.dtype, want.dtype)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL, err_msg=key)


@pytest.mark.parametrize("family,frames,flf2v", [("cogvideox", 5, False), ("wan", 9, False), ("wan", 9, True),
                                                 ("hunyuan", 5, False)])
def test_encoder_matches_alg_tpu(pipes, family, frames, flf2v):
    port, ref = pipes[family]
    clip = TPC.coerce_frames(TPC.frames_to_tensor(_uint8_clip(frames, seed=5), 32, 32))
    extra = {"flf2v": flf2v} if family == "wan" else {}
    got = TPC._ENCODERS[family](port, np.ascontiguousarray(clip), PROMPT, MAX_SEQ, **extra)
    want = JPC._ENCODERS[family](ref, clip, PROMPT, MAX_SEQ, **extra)
    assert sorted(got) == sorted(want)
    for key in want:
        want_k = np.asarray(want[key])
        if key == "encoder_attention_mask":
            assert got[key].dtype == want_k.dtype == np.int32
            np.testing.assert_array_equal(got[key], want_k)
        elif key == "condition":
            np.testing.assert_array_equal(got[key][:4], want_k[:4])  # the mask block
            _close(got[key], want_k, key)
        else:
            _close(got[key], want_k, key)
    if family == "cogvideox":
        assert np.abs(got["image_latents"][1:]).max() == 0.0 and np.abs(got["image_latents"][0]).max() > 0.0
    if family == "wan":  # the last pixel frame marks the last latent frame's fourth t-channel
        mask = got["condition"][:4]
        assert mask[:, 0].min() == 1.0 and np.abs(mask[:, 1:-1]).max() == 0.0
        assert (mask[3, -1].min() == 1.0 and np.abs(mask[:3, -1]).max() == 0.0) if flf2v else (
            np.abs(mask[:, -1]).max() == 0.0)


# -- run over a manifest -------------------------------------------------------------------


def _config(path, **extra):
    return {"model": {"path": path, "dtype": "float32"},
            "generation": {"height": 32, "width": 32, "num_frames": 5, "max_sequence_length": MAX_SEQ},
            "video": {"fps": 8}, **extra}


def _args(out_dir, *extra):
    return TPC.build_parser().parse_args(["--config", "unused.yaml", "--device", "cpu", "--output_dir", str(out_dir),
                                          *extra])


def test_run_over_a_manifest(ckpts, tmp_path):
    clips = []
    for i, frames in enumerate((5, 7, 5)):  # 7 frames are cut to 5
        np.save(tmp_path / f"clip{i}.npy", _uint8_clip(frames, seed=10 + i))
        clips.append({"video": str(tmp_path / f"clip{i}.npy"), "prompt": PROMPT})
    manifest = tmp_path / "manifest.jsonl"
    manifest.write_text("".join(json.dumps(c) + "\n" for c in clips))
    config = _config(ckpts["cogvideox"])
    written = TPC.run(_args(tmp_path / "all", "--manifest", str(manifest)), config)
    assert [os.path.basename(p) for p in written] == [f"example_{i:05d}.npz" for i in range(3)]
    assert sorted(os.listdir(tmp_path / "all")) == [f"example_{i:05d}.npz" for i in range(3)]
    for path in written:
        with np.load(path) as z:
            assert sorted(z.files) == ["encoder_hidden_states", "image_latents", "latents"]
            assert z["latents"].shape == z["image_latents"].shape == (2, 4, 4, 4)
            assert z["encoder_hidden_states"].shape == (MAX_SEQ, 16)
            assert all(z[k].dtype == np.float32 for k in z.files)

    limited = TPC.run(_args(tmp_path / "two", "--manifest", str(manifest), "--limit", "2"), config)
    assert [os.path.basename(p) for p in limited] == ["example_00000.npz", "example_00001.npz"]
    single = TPC.run(_args(tmp_path / "one", "--video", clips[1]["video"], "--prompt", PROMPT), config)
    for a, b in ((single[0], written[1]), (limited[1], written[1])):
        with np.load(a) as za, np.load(b) as zb:
            for k in zb.files:
                np.testing.assert_array_equal(za[k], zb[k], err_msg=k)
    with pytest.raises(ValueError, match="--manifest, or --video with --prompt"):
        TPC.run(_args(tmp_path / "none", "--video", clips[0]["video"]), config)


def test_run_takes_the_hunyuan_bucket_from_the_first_clip(ckpts, tmp_path):
    # a 3:2 frames directory first, then a square clip: both are encoded at the first clip's bucket
    first = _uint8_clip(5, 64, 96, seed=20)
    frames_dir = tmp_path / "wide"
    frames_dir.mkdir()
    for i, f in enumerate(first):
        Image.fromarray(f).save(frames_dir / f"f{i:03d}.png")
    np.save(tmp_path / "square.npy", _uint8_clip(5, 48, 48, seed=21))
    manifest = tmp_path / "manifest.jsonl"
    manifest.write_text(json.dumps({"video": str(frames_dir), "prompt": PROMPT}) + "\n"
                        + json.dumps({"video": str(tmp_path / "square.npy"), "prompt": PROMPT}) + "\n")
    written = TPC.run(_args(tmp_path / "out", "--manifest", str(manifest)),
                      _config(ckpts["hunyuan"], video={"fps": 8, "resolution": "360p"}))
    height, width = get_hunyuan_video_size("360p", Image.fromarray(first[0]))
    assert (height, width) != (32, 32)
    for path in written:
        with np.load(path) as z:
            assert sorted(z.files) == ["encoder_attention_mask", "encoder_hidden_states", "image_latents", "latents",
                                       "pooled_projections"]
            assert z["latents"].shape[1:] == (2, height // 8, width // 8)
            assert z["image_latents"].shape[1:] == (1, height // 8, width // 8)
            assert z["encoder_attention_mask"].dtype == np.int32


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal on a machine without a CUDA device")
def test_prepare_and_train_default_to_the_card_and_refuse_without_one(ckpts, tmp_path):
    from alg_tpu_torch import train_cli

    np.save(tmp_path / "clip.npy", _uint8_clip(5))
    args = TPC.build_parser().parse_args(["--config", "c.yaml", "--output_dir", str(tmp_path / "out"), "--video",
                                          str(tmp_path / "clip.npy"), "--prompt", PROMPT])
    assert args.device == "cuda"
    with pytest.raises((RuntimeError, AssertionError)):
        TPC.run(args, _config(ckpts["cogvideox"]))
    targs = train_cli.make_parser().parse_args(["--config", "c.yaml", "--output", str(tmp_path / "a.npz"),
                                                "--synthetic", "2", "--steps", "1"])
    assert targs.device == "cuda"
    with pytest.raises((RuntimeError, AssertionError)):
        train_cli.run(_config(ckpts["cogvideox"]), targs)
