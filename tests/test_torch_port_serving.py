"""The port's batched serving (``alg_tpu_torch/serving.py``) against
``alg_tpu.serving.serve_batch`` on ``tools/make_tiny_checkpoint.py``'s
CogVideoX and HunyuanVideo directories and a tiny Wan one from
``hf_checkpoint``, fp32 on the CPU, two requests at different seeds in one
batch: final latents within atol 2e-3 and frames above 40 dB for CogVideoX,
Wan (with and without FLF2V) and HunyuanVideo under true CFG; in the port, a
request served in a batch of two is the request served alone within 1e-5; a
uint8 array and the PIL image of the same pixels give the same video; both
packages encode CogVideoX and Wan prompts at the default length whatever the
config says (R13); both refuse the same bad batches."""

import os
import sys

import numpy as np
import pytest
import torch

import alg_tpu.cli as JC
from alg_tpu import pipelines as JP
from alg_tpu import serving as JS
from alg_tpu.core.config import load_run_config

import alg_tpu_torch.cli as TC
from alg_tpu_torch import serving as TS
from alg_tpu_torch.core.config import run_config_from_dict
from alg_tpu_torch.core.rng import NoiseSource
from alg_tpu_torch.io import hf_checkpoint as H
from alg_tpu_torch.pipelines.cogvideox import CogVideoXPipeline
from alg_tpu_torch.pipelines.hunyuan import HunyuanVideoPipeline
from alg_tpu_torch.pipelines.wan import WanPipeline

from torch_port_common import one_thread

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import make_tiny_checkpoint  # noqa: E402

Image = pytest.importorskip("PIL.Image")
yaml = pytest.importorskip("yaml")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMAGE = os.path.join(REPO, "assets", "a red double decker bus driving down a street.jpg")
PROMPTS = ("a red double decker bus driving down the street", "the panda")
SEEDS = (42, 7)


def _config(path, **generation):
    return {
        "model": {"path": path, "dtype": "float32", "flow_shift": 7.0, "flow_reverse": False},
        "generation": {"height": 32, "width": 32, "num_frames": 5, "num_inference_steps": 2, "guidance_scale": 6.0,
                       "max_sequence_length": 16, **generation},
        "alg": {"use_low_pass_guidance": True, "lp_filter_type": "down_up", "lp_filter_in_latent": True,
                "lp_resize_factor": 0.25, "lp_strength_schedule_type": "interval",
                "schedule_interval_start_time": 0.0, "schedule_interval_end_time": 0.5},
        "video": {"fps": 8},
    }


class _Checkpoints:
    """The tiny checkpoint of a family, its parsed config and one pipeline a
    package, each made on first use and kept for the module. The Wan
    checkpoint takes UMT5-XXL's 32 buckets and distance 128, which
    ``alg_tpu``'s loader assumes whatever the file says (ROADMAP.md C, R9)."""

    def __init__(self, root):
        self.root, self.configs, self.pipes = root, {}, {}

    def config(self, family):
        if family not in self.configs:
            path = os.path.join(self.root, {"cogvideox": "TinyCogVideoX", "wan": "TinyWan",
                                            "hunyuan": "TinyHunyuanVideo"}[family])
            if family == "cogvideox":
                make_tiny_checkpoint.build(path)
                cfg = _config(path)
            elif family == "wan":
                H.write_wan(path, dict(H.TINY_WAN, text_encoder={
                    **H.TINY_WAN["text_encoder"], "relative_attention_num_buckets": 32,
                    "relative_attention_max_distance": 128}), dtype=torch.float32)
                cfg = _config(path, num_frames=9, guidance_scale=5.0)
                cfg["alg"]["lp_resize_factor"] = 0.5
            else:
                make_tiny_checkpoint.build_hunyuan(path)
                cfg = _config(path, true_cfg_scale=2.0, guidance_scale=1.0)
                cfg["alg"]["lp_resize_factor"] = 0.625
            self.configs[family] = cfg
        return self.configs[family]

    def pipe(self, package, family):
        """``alg_tpu``'s (loaded from a YAML file) or the port's (on the CPU)."""
        if (package, family) not in self.pipes:
            if package == "jax":
                path = os.path.join(self.root, f"{family}.yaml")
                with open(path, "w") as f:
                    yaml.safe_dump(self.config(family), f)
                self.pipes[package, family] = JC.load_pipeline(load_run_config(path))
            else:
                self.pipes[package, family] = TC.load_pipeline(run_config_from_dict(self.config(family)),
                                                               device="cpu")
        return self.pipes[package, family]

    def gen_kwargs(self, family, **over):
        return {**run_config_from_dict(self.config(family)).pipeline_kwargs, **over}


@pytest.fixture(scope="module")
def ck(tmp_path_factory):
    return _Checkpoints(str(tmp_path_factory.mktemp("serving")))


def _pil(size=32, flip=False):
    img = Image.open(IMAGE).convert("RGB").resize((size, size), resample=Image.LANCZOS)
    return img.transpose(Image.FLIP_LEFT_RIGHT) if flip else img


def _requests(module, flf2v=False, image=None):
    first, second = (_pil(), _pil(flip=True)) if image is None else (image, image)
    return [module.BatchRequest(prompt=p, image=img, negative_prompt="", seed=s,
                                last_image=_pil(flip=i == 0) if flf2v else None)
            for i, (p, img, s) in enumerate(zip(PROMPTS, (first, second), SEEDS))]


@pytest.fixture
def captured(monkeypatch):
    """The final latents each package's call hands its decode, by package."""
    got = {}

    def keep(cls, key):
        decode = cls.decode_latents

        def kept(self, latents, *args, **kwargs):
            got[key] = np.array(latents)
            return decode(self, latents, *args, **kwargs)

        monkeypatch.setattr(cls, "decode_latents", kept)

    for cls in (JP.CogVideoXPipeline, JP.WanPipeline, JP.HunyuanVideoPipeline):
        keep(cls, "jax")
    for cls in (CogVideoXPipeline, WanPipeline, HunyuanVideoPipeline):
        keep(cls, "port")
    return got


def _psnr(a, b):
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return float("inf") if mse == 0 else 10 * np.log10(1.0 / mse)


@pytest.mark.parametrize("case", ["cogvideox", "wan", "wan-flf2v", "hunyuan-truecfg"])
def test_serve_batch_matches_alg_tpu(case, ck, captured):
    """Two requests in one batch through each package's ``serve_batch``:
    final latents within 2e-3, frames above 40 dB, each request's own."""
    family = case.split("-")[0]
    flf2v = case == "wan-flf2v"
    kw = ck.gen_kwargs(family, output_type="np")
    want = np.asarray(JS.serve_batch(ck.pipe("jax", family), _requests(JS, flf2v), **kw))
    got = TS.serve_batch(ck.pipe("port", family), _requests(TS, flf2v), **kw)
    assert got.shape == want.shape == (2, 9 if family == "wan" else 5, 32, 32, 3)
    assert captured["port"].shape == captured["jax"].shape
    err = np.abs(captured["port"] - captured["jax"]).max()
    assert err <= 2e-3, err
    for i in range(2):
        assert _psnr(got[i], want[i]) > 40.0
    assert _psnr(got[0], got[1]) < 40.0  # two requests, two videos


@pytest.mark.parametrize("family", ["cogvideox", "wan", "hunyuan"])
def test_a_request_in_a_batch_is_the_request_alone(family, ck):
    """Each request of a batch of two gets the latents it gets alone (its
    own noise stream, its own prompt and image), within 1e-5."""
    pipe, kw = ck.pipe("port", family), ck.gen_kwargs(family, output_type="latent")
    reqs = _requests(TS)
    both = TS.serve_batch(pipe, reqs, **kw)
    for i, req in enumerate(reqs):
        alone = TS.serve_batch(pipe, [req], **kw)
        assert alone.shape[0] == 1
        assert np.abs(both[i] - alone[0]).max() <= 1e-5


@pytest.mark.parametrize("family", ["cogvideox", "wan", "hunyuan"])
def test_a_uint8_array_serves_as_its_pil_image(family, ck):
    """An RGB uint8 array at the generated size and the PIL image of the same
    pixels give the same video."""
    pipe, kw = ck.pipe("port", family), ck.gen_kwargs(family, output_type="np")
    pil = _pil()
    videos = [TS.serve_batch(pipe, _requests(TS, image=image), **kw) for image in (pil, np.asarray(pil))]
    assert videos[0].shape[0] == 2 and np.array_equal(videos[0], videos[1])


def test_prompt_length_is_the_encoders_default_r13(ck, monkeypatch):
    """R13: with the config's ``max_sequence_length`` at 16, both packages'
    ``serve_batch`` encode CogVideoX prompts at 226 tokens and Wan prompts
    at 512, where HunyuanVideo's encoder takes the config's length."""
    lengths = {}

    def spy(cls, key):
        encode = cls.encode_prompt

        def recorded(self, *args, **kwargs):
            out = encode(self, *args, **kwargs)
            lengths.setdefault(key, []).append(int((out[0] if isinstance(out, tuple) else out).shape[1]))
            return out

        monkeypatch.setattr(cls, "encode_prompt", recorded)

    for cls, key in ((JP.CogVideoXPipeline, "jax cogvideox"), (JP.WanPipeline, "jax wan"),
                     (JP.HunyuanVideoPipeline, "jax hunyuan"), (CogVideoXPipeline, "port cogvideox"),
                     (WanPipeline, "port wan"), (HunyuanVideoPipeline, "port hunyuan")):
        spy(cls, key)
    reqs = {"jax": _requests(JS), "port": _requests(TS)}
    for family in ("cogvideox", "wan"):
        for package, serve in (("jax", JS.serve_batch), ("port", TS.serve_batch)):
            pipe = ck.pipe(package, family)
            serve(pipe, reqs[package], **ck.gen_kwargs(family, output_type="latent", num_inference_steps=1))
    assert lengths["jax cogvideox"] == lengths["port cogvideox"] == [226, 226]
    assert lengths["jax wan"] == lengths["port wan"] == [512, 512]
    # HunyuanVideo honours it: the port's DiT text grows with the config's length, as alg_tpu's does
    hy = ck.pipe("port", "hunyuan")
    for package, mod in (("jax", JS), ("port", TS)):
        encoded = mod._encode_hunyuan(ck.pipe(package, "hunyuan"), _requests(mod)[:1],
                                      {"max_sequence_length": 8})
        lengths[f"{package} hunyuan 8"] = int(encoded["prompt_embeds"].shape[1])
    lengths["port hunyuan 16"] = int(TS._encode_hunyuan(hy, _requests(TS)[:1], {"max_sequence_length": 16})[
        "prompt_embeds"].shape[1])
    assert lengths["jax hunyuan 8"] == lengths["port hunyuan 8"] < lengths["port hunyuan 16"]


def test_bad_batches_raise_as_alg_tpu_does(ck, tmp_path):
    """The same ``ValueError``s as ``alg_tpu``'s: ``last_image`` on some
    requests only, ``last_image`` on a family other than Wan, a pipeline that
    is not one of the three; a draw that does not lead with the batch
    raises; each request's stream is its own seed's. Over a mesh of one gloo
    rank (this process) ``serve_batch`` is bit for bit the unsharded call,
    ``shard_pipeline`` arms a copy and re-arms only the mode, and an
    unknown mode raises."""
    cases = []
    for package, mod in (("jax", JS), ("port", TS)):
        mixed = _requests(mod)
        mixed[0].last_image = _pil()
        flf2v = _requests(mod, flf2v=True)
        for pipe, reqs in ((ck.pipe(package, "wan"), mixed), (ck.pipe(package, "cogvideox"), flf2v),
                           (object(), _requests(mod))):
            with pytest.raises(ValueError) as exc:
                mod.serve_batch(pipe, reqs, **ck.gen_kwargs("cogvideox"))
            cases.append((package, str(exc.value)))
    assert [m for p, m in cases if p == "jax"] == [m for p, m in cases if p == "port"]
    import torch.distributed as dist

    from alg_tpu_torch.sharding import init_process_group, make_mesh

    init_process_group(0, 1, f"file://{tmp_path}/store", "cpu")
    try:
        mesh, pipe = make_mesh(device="cpu"), ck.pipe("port", "cogvideox")
        armed = TS.shard_pipeline(pipe, mesh)
        assert armed.attn_mesh is mesh and armed.sp_mode == "gather" and pipe.attn_mesh is None
        assert TS.shard_pipeline(armed, mesh, "ring").transformer is armed.transformer
        with pytest.raises(ValueError, match="sp_mode"):
            TS.shard_pipeline(pipe, mesh, "bogus")
        gen = ck.gen_kwargs("cogvideox", output_type="latent")
        with torch.no_grad():
            np.testing.assert_array_equal(TS.serve_batch(pipe, _requests(TS), mesh=mesh, sp_mode="ring", **gen),
                                          TS.serve_batch(pipe, _requests(TS), **gen))
    finally:
        dist.destroy_process_group()
    noise = TS._BatchNoise(SEEDS)
    with pytest.raises(ValueError, match="batch-leading"):
        noise.randn((3, 4))
    draws = noise.randn((2, 3, 4))
    for i, seed in enumerate(SEEDS):
        assert torch.equal(draws[i], NoiseSource(seed).randn((3, 4)))
