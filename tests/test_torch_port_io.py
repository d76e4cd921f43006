"""The port's checkpoint path against the reference: its safetensors reader
and writer against the ``safetensors`` package, its three pipeline loaders
against ``alg_tpu``'s on ``tools/make_tiny_checkpoint.py``'s directories
(parameters bit for bit, configs field for field), its checkpoint writer
against that tool, and its video export against ``alg_tpu``'s."""

import dataclasses
import json
import os
import struct
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from alg_tpu.io import model_zoo as JZ
from alg_tpu.io import video as JV

from alg_tpu_torch.io import hf_checkpoint as H
from alg_tpu_torch.io import model_zoo as TZ
from alg_tpu_torch.io import safetensors as ST
from alg_tpu_torch.io import video as TV
from alg_tpu_torch.io import weights as W
from alg_tpu_torch.io.jax_params import flatten_jax_tree

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import make_tiny_checkpoint  # noqa: E402

from torch_port_common import one_thread


safetensors_torch = pytest.importorskip("safetensors.torch")


# -- safetensors ------------------------------------------------------------------

DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16, "I64": torch.int64,
          "I32": torch.int32}


def _tensors(dtype, seed):
    g = torch.Generator().manual_seed(seed)
    shapes = {"a.weight": (3, 5), "b.bias": (7,), "c.table": (2, 3, 4), "d.scalar": (), "e.empty": (0, 3)}
    if dtype.is_floating_point:
        return {n: (torch.randn(s, generator=g) * 10).to(dtype) for n, s in shapes.items()}
    return {n: torch.randint(-2**30, 2**30, s, generator=g, dtype=torch.int64).to(dtype) for n, s in shapes.items()}


def _same_bits(a, b):
    def raw(t):
        return bytes(t.contiguous().reshape(-1).view(torch.uint8).numpy())

    return a.dtype == b.dtype and a.shape == b.shape and raw(a) == raw(b)


@pytest.mark.parametrize("name", list(DTYPES))
def test_reader_matches_the_safetensors_package(name, tmp_path):
    """Two shards and ``__metadata__`` written by the ``safetensors``
    package: the port's directory reader returns every tensor bit for bit
    (bf16 as bf16), and a name in two shards raises."""
    dtype = DTYPES[name]
    first, second = _tensors(dtype, 0), {f"z.{k}": v for k, v in _tensors(dtype, 1).items()}
    safetensors_torch.save_file(first, str(tmp_path / "model-00001-of-00002.safetensors"), metadata={"format": "pt"})
    safetensors_torch.save_file(second, str(tmp_path / "model-00002-of-00002.safetensors"))
    got = ST.load_safetensors_dir(str(tmp_path))
    assert set(got) == set(first) | set(second)
    for k, v in {**first, **second}.items():
        assert _same_bits(got[k], v), k
    assert ST.read_header(str(tmp_path / "model-00001-of-00002.safetensors"))[0]["__metadata__"] == {"format": "pt"}
    safetensors_torch.save_file({"a.weight": first["a.weight"]}, str(tmp_path / "model-00003.safetensors"))
    with pytest.raises(ValueError, match="more than one shard"):
        ST.load_safetensors_dir(str(tmp_path))


@pytest.mark.parametrize("name", list(DTYPES))
def test_writer_is_read_by_the_safetensors_package(name, tmp_path):
    """What the port's writer writes, the ``safetensors`` package reads back
    bit for bit, metadata too; the byte count it returns is the file's."""
    tensors = _tensors(DTYPES[name], 2)
    path = str(tmp_path / "x.safetensors")
    n = ST.save_safetensors(tensors, path, metadata={"source": "test"})
    assert n == os.path.getsize(path)
    back = safetensors_torch.load_file(path)
    assert set(back) == set(tensors) and all(_same_bits(back[k], v) for k, v in tensors.items())
    from safetensors import safe_open

    with safe_open(path, framework="pt") as f:
        assert f.metadata() == {"source": "test"}


def test_reader_copies_a_misaligned_tensor(tmp_path):
    """A hand-built file whose fp32 tensor starts 6 bytes into the data,
    after three bf16 values: the reader copies it out at the right value."""
    a = torch.tensor([1.5, -2.0, 3.25], dtype=torch.bfloat16)
    b = torch.tensor([0.1, -7.0], dtype=torch.float32)
    header = json.dumps({"a": {"dtype": "BF16", "shape": [3], "data_offsets": [0, 6]},
                         "b": {"dtype": "F32", "shape": [2], "data_offsets": [6, 14]}}).encode()
    header += b" " * (-len(header) % 8)
    path = tmp_path / "m.safetensors"
    path.write_bytes(struct.pack("<Q", len(header)) + header + a.view(torch.uint8).numpy().tobytes()
                     + b.view(torch.uint8).numpy().tobytes())
    got = ST.load_file(str(path))
    assert _same_bits(got["a"], a) and _same_bits(got["b"], b)


# -- the three loaders against alg_tpu's ------------------------------------------------------

TINY_CHECKPOINTS = {"cogvideox": ("TinyCogVideoX", make_tiny_checkpoint.build),
            "wan": ("TinyWan", make_tiny_checkpoint.build_wan),
            "hunyuan": ("TinyHunyuanVideo", make_tiny_checkpoint.build_hunyuan)}


@pytest.fixture(scope="module")
def tiny_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("tiny")
    out = {}
    for family, (name, build) in TINY_CHECKPOINTS.items():
        out[family] = str(root / name)
        build(out[family])
    return out


def _assert_same_module(module, tree, what):
    got, want = module.state_dict(), dict(flatten_jax_tree(jax.device_get(tree)))
    assert set(got) == set(want), (what, sorted(set(got) ^ set(want))[:5])
    for name, t in got.items():
        w = np.asarray(want[name]).astype(np.float32)
        assert t.shape == w.shape and np.array_equal(t.float().numpy(), w), f"{what}.{name}"


def _assert_same_config(port_cfg, jax_cfg, what, skip=()):
    for f in dataclasses.fields(port_cfg):
        if f.name in skip:
            continue
        a, b = getattr(port_cfg, f.name), getattr(jax_cfg, f.name)
        if dataclasses.is_dataclass(a):
            _assert_same_config(a, b, f"{what}.{f.name}")
        else:
            assert a == b, (what, f.name, a, b)


LOADS = {
    "cogvideox": (lambda d, dt: JZ.load_cogvideox_pipeline(d, dtype=dt),
                  lambda d, dt: TZ.load_cogvideox_pipeline(d, dtype=dt, device="cpu"),
                  (("transformer", "transformer"), ("vae", "vae"), ("t5", "t5"))),
    "wan": (lambda d, dt: JZ.load_wan_pipeline(d, dtype=dt, flow_shift=5.0),
            lambda d, dt: TZ.load_wan_pipeline(d, dtype=dt, flow_shift=5.0, device="cpu"),
            (("transformer", "transformer"), ("vae", "vae"), ("t5", "t5"), ("clip", "clip"))),
    "hunyuan": (lambda d, dt: JZ.load_hunyuan_pipeline(d, dtype=dt, flow_shift=7.0),
                lambda d, dt: TZ.load_hunyuan_pipeline(d, dtype=dt, flow_shift=7.0, device="cpu"),
                (("transformer", "transformer"), ("vae", "vae"), ("llava", "llava"), ("clip", "clip"))),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("family", list(LOADS))
def test_loader_matches_alg_tpu(family, dtype, tiny_dirs):
    """Every module the port's loader builds holds exactly the parameters
    ``alg_tpu``'s loader converts (its trees flattened to the port's names
    and layouts), in the same dtypes (the VAEs and CLIP towers fp32, the
    rest in the config dtype); the configs agree field for field, but for
    the UMT5 bias-table fields, which the port takes from the checkpoint
    (ROADMAP.md C, R9) and ``alg_tpu`` leaves at UMT5-XXL's."""
    jax_load, port_load, pairs = LOADS[family]
    jp = jax_load(tiny_dirs[family], getattr(jnp, dtype))
    tp = port_load(tiny_dirs[family], getattr(torch, dtype))
    for port_attr, jax_attr in pairs:
        module = getattr(tp, port_attr)
        _assert_same_module(module, getattr(jp, f"{jax_attr}_params"), port_attr)
        fp32 = port_attr in ("vae", "clip")
        assert next(module.parameters()).dtype == (torch.float32 if fp32 else getattr(torch, dtype)), port_attr
        skip = ("relative_attention_num_buckets", "relative_attention_max_distance") if family == "wan" else ()
        _assert_same_config(module.cfg, getattr(jp, f"{jax_attr}_cfg"), port_attr,
                            skip=skip if port_attr == "t5" else ())
    if family == "wan":
        te = json.load(open(os.path.join(tiny_dirs[family], "text_encoder", "config.json")))
        assert tp.t5.cfg.relative_attention_num_buckets == te["relative_attention_num_buckets"]
        assert tp.scheduler_cfg.flow_shift == jp.scheduler_cfg.flow_shift
    if family == "cogvideox":
        _assert_same_config(tp.scheduler_cfg, jp.scheduler_cfg, "scheduler")
    if family == "hunyuan":
        _assert_same_config(tp.scheduler_cfg, jp.scheduler_cfg, "scheduler")


def test_loader_tokenizers_match_alg_tpu(tiny_dirs):
    """The loaders' tokenizer hooks give ``alg_tpu``'s ids, masks and dtypes."""
    prompts = ["a red double decker bus", "the panda <image> driving", "unknown words here", ""]
    cog_j, cog_t = JZ._make_tokenizer(tiny_dirs["cogvideox"]), TZ._make_tokenizer(tiny_dirs["cogvideox"])
    wan_j, wan_t = JZ._make_wan_tokenizer(tiny_dirs["wan"]), TZ._make_wan_tokenizer(tiny_dirs["wan"])
    hy = tiny_dirs["hunyuan"]
    pairs = [(cog_j(prompts, 12), cog_t(prompts, 12))]
    pairs += list(zip(wan_j(prompts, 12), wan_t(prompts, 12)))
    pairs += list(zip(JZ._make_plain_tokenizer(hy, "tokenizer", True)(prompts, 12),
                      TZ._make_plain_tokenizer(hy, "tokenizer", True)(prompts, 12)))
    pairs += [(JZ._make_plain_tokenizer(hy, "tokenizer_2", False)(prompts, 12),
               TZ._make_plain_tokenizer(hy, "tokenizer_2", False)(prompts, 12))]
    for a, b in pairs:
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_loaders_refuse_what_is_not_ported(tmp_path):
    """``quantize``, once refused (ROADMAP A12), loads, and an unknown mode
    raises; a tokenizer directory without ``tokenizer.json`` raises; an
    absent model names the cache flag. (A CogVideoX 1.5 checkpoint, once
    refused, now loads: ``tests/test_torch_port_cogvideox15.py``; quantized
    widths: ``tests/test_torch_port_quant.py``.)"""
    root = str(tmp_path / "TinyCogVideoX1.5")
    make_tiny_checkpoint.build(root, patch_size_t=2)
    # the tiny DiT's linears are narrower than 128: none is quantized
    got = TZ.load_cogvideox_pipeline(root, dtype=torch.float32, quantize="w8", device="cpu").transformer.state_dict()
    want = TZ.load_cogvideox_pipeline(root, dtype=torch.float32, device="cpu").transformer.state_dict()
    assert list(got) == list(want) and all(torch.equal(got[n], want[n]) for n in want)
    with pytest.raises(ValueError, match="quantization mode"):
        TZ.load_cogvideox_pipeline(root, dtype=torch.float32, quantize="w2", device="cpu")
    os.remove(os.path.join(root, "tokenizer", "tokenizer.json"))
    with pytest.raises(FileNotFoundError, match="tokenizer.json"):
        TZ._make_tokenizer(root)
    with pytest.raises(FileNotFoundError, match="model_cache_dir"):
        TZ.resolve_model_dir("THUDM/CogVideoX-5b-I2V", str(tmp_path))


def test_resolve_model_dir_finds_local_layouts(tmp_path):
    """A path, ``cache_dir/<id>`` and the newest HF hub snapshot, as ``alg_tpu``'s does."""
    (tmp_path / "org" / "Model").mkdir(parents=True)
    snaps = tmp_path / "models--org--Other" / "snapshots"
    (snaps / "aaa").mkdir(parents=True)
    (snaps / "bbb").mkdir()
    for args in ((str(tmp_path / "org" / "Model"), None), ("org/Model", str(tmp_path)), ("org/Other", str(tmp_path))):
        assert TZ.resolve_model_dir(*args) == JZ.resolve_model_dir(*args)


# -- the checkpoint writer against the tool ----------------------------------------------------


@pytest.mark.parametrize("family", ["cogvideox", "cogvideox15", "wan", "hunyuan"])
def test_writer_matches_the_tiny_tool(family, tiny_dirs, tmp_path):
    """``hf_checkpoint`` at the tool's widths writes the same files, tensor
    names and shapes and config.json contents as
    ``tools/make_tiny_checkpoint.py`` (tensors in bf16), and tokenizers
    (HunyuanVideo's two) that encode as the tool's do, in the port's
    interpreter and in the ``tokenizers`` package."""
    tokenizers = pytest.importorskip("tokenizers")
    from alg_tpu_torch.io.hf_tokenizer import load_tokenizer

    if family == "cogvideox15":  # the tool's CogVideoX with temporal patches (1.5)
        tool = str(tmp_path / "tool" / "TinyCogVideoX1.5")
        make_tiny_checkpoint.build(tool, patch_size_t=2)
        mine = str(tmp_path / "TinyCogVideoX1.5")
        drawn = H.write_cogvideox(mine, H.TINY_COGVIDEOX15)
    else:
        tool = tiny_dirs[family]
        mine = str(tmp_path / os.path.basename(tool))
        drawn = {"cogvideox": H.write_cogvideox, "wan": H.write_wan, "hunyuan": H.write_hunyuan}[family](mine)
    for sub in sorted(os.listdir(tool)):
        assert sorted(os.listdir(os.path.join(tool, sub))) == sorted(os.listdir(os.path.join(mine, sub))), sub
        cfg_path = os.path.join(tool, sub, "config.json")
        if os.path.exists(cfg_path):
            assert json.load(open(cfg_path)) == json.load(open(os.path.join(mine, sub, "config.json"))), sub
            a, b = ST.load_safetensors_dir(os.path.join(tool, sub)), ST.load_safetensors_dir(os.path.join(mine, sub))
            assert {k: v.shape for k, v in a.items()} == {k: v.shape for k, v in b.items()}, sub
            assert all(v.dtype == torch.bfloat16 for v in b.values())
            assert all(_same_bits(drawn[sub][k], v) for k, v in b.items())
    prompts = ["a red double decker bus driving down the street", "the panda <image> x", "zebra"]
    for sub in ("tokenizer", "tokenizer_2") if family == "hunyuan" else ("tokenizer",):
        for a, b in zip(load_tokenizer(os.path.join(tool, sub))(prompts, 16),
                        load_tokenizer(os.path.join(mine, sub))(prompts, 16)):
            assert np.array_equal(a, b)
        ref = tokenizers.Tokenizer.from_file(os.path.join(mine, sub, "tokenizer.json"))
        assert [ref.encode(p).ids for p in prompts] == [
            tokenizers.Tokenizer.from_file(os.path.join(tool, sub, "tokenizer.json")).encode(p).ids for p in prompts]


def test_writer_draws_load_bit_for_bit(tmp_path):
    """What ``write_cogvideox`` and ``write_hunyuan`` draw is what the
    loaders put in the modules: bf16 parameters bit for bit, the fp32 VAEs
    and CLIP text model the bf16 values (phases F's and S3's check on the
    card, here at the tiny widths); the draws follow the seed; the Llava
    tokenizer maps ``<image>`` to the config's ``image_token_index``."""
    from alg_tpu_torch.io.hf_tokenizer import load_tokenizer

    root = str(tmp_path / "TinyCogVideoX")
    drawn = H.write_cogvideox(root, seed=5)
    pipe = TZ.load_cogvideox_pipeline(root, dtype=torch.bfloat16, device="cpu")
    hy_root = str(tmp_path / "TinyHunyuanVideo")
    hy_drawn = H.write_hunyuan(hy_root, H.TINY_HUNYUAN, seed=5)
    hy = TZ.load_hunyuan_pipeline(hy_root, dtype=torch.bfloat16, device="cpu")
    for drawn_sub, sub, module, convert in (
            (drawn, "transformer", pipe.transformer, W.convert_cogvideox_transformer),
            (drawn, "vae", pipe.vae, W.convert_cogvideox_vae),
            (drawn, "text_encoder", pipe.t5, W.convert_t5_encoder),
            (hy_drawn, "transformer", hy.transformer, W.convert_hunyuan_transformer),
            (hy_drawn, "vae", hy.vae, W.convert_hunyuan_vae),
            (hy_drawn, "text_encoder", hy.llava, W.convert_llava),
            (hy_drawn, "text_encoder_2", hy.clip, W.convert_clip_text)):
        want = dict(W.flatten_tree(convert(drawn_sub[sub], module.cfg)))
        got = module.state_dict()
        assert set(want) == set(got)
        for name, t in got.items():
            if sub in ("vae", "text_encoder_2"):
                assert t.dtype == torch.float32 and torch.equal(t, want[name].float()), name
            else:
                assert _same_bits(t, want[name]), name
    again = H.write_cogvideox(str(tmp_path / "again"), seed=5)
    assert all(_same_bits(again["vae"][k], v) for k, v in drawn["vae"].items())
    ids, _ = load_tokenizer(os.path.join(hy_root, "tokenizer"))(["the panda <image> x"], 8)
    assert ids[0, 2] == hy.llava.cfg.image_token_index == H.TINY_HUNYUAN["text_encoder"]["image_token_index"]


# -- video export against alg_tpu's ----------------------------------------------------------


def _frames(seed=0):
    return np.random.RandomState(seed).rand(3, 16, 24, 3).astype(np.float32)


@pytest.mark.parametrize("ext", [".mp4", ".gif"])
def test_write_video_writes_alg_tpus_bytes(ext, tmp_path, monkeypatch):
    """Without ffmpeg: the same MJPEG-AVI (or the GIF asked for) bytes as
    ``alg_tpu``'s ``write_video``, from float frames and from uint8 ones."""
    pytest.importorskip("PIL")
    monkeypatch.setattr(JV.shutil, "which", lambda name: None)
    monkeypatch.setattr(TV.shutil, "which", lambda name: None)
    for frames in (_frames(), (_frames(1) * 255).astype(np.uint8)):
        a = JV.write_video(str(tmp_path / f"a{ext}"), frames, fps=8)
        b = TV.write_video(str(tmp_path / f"b{ext}"), frames, fps=8)
        assert os.path.splitext(a)[1] == os.path.splitext(b)[1] == (".avi" if ext == ".mp4" else ".gif")
        assert open(a, "rb").read() == open(b, "rb").read()


def test_write_video_falls_back_to_npy_frames_without_pil(tmp_path, monkeypatch):
    """Neither ffmpeg nor PIL: a directory of ``.npy`` uint8 frames, as
    ``alg_tpu`` writes it."""
    monkeypatch.setattr(TV.shutil, "which", lambda name: None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    frames = _frames(2)
    out = TV.write_video(str(tmp_path / "clip.mp4"), frames, fps=8)
    assert out == str(tmp_path / "clip")
    back = np.stack([np.load(os.path.join(out, f)) for f in sorted(os.listdir(out))])
    assert back.dtype == np.uint8 and np.array_equal(back, TV._frames_to_uint8(frames))
    assert np.array_equal(back, JV._frames_to_uint8(frames))
