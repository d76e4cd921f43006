"""CogVideoX-1.5 and the rest of the CogVideoX model variants in the port,
against ``alg_tpu`` on the CPU in fp32 on the same numpy inputs: the DiT with
temporal patches and the ofs embedding, without RoPE and without attention
biases (atol 1e-4, the whole-forward bound of
``tests/test_torch_port_models.py``); the "slice" RoPE tables (1e-6); the
loader on ``tools/make_tiny_checkpoint.build(patch_size_t=2)`` and on a copy
whose VAE sets ``invert_scale_latents`` (bit for bit, configs field for
field); both ``__call__``s over those checkpoints with latent ALG, without
ALG, with pixel-space ALG and with DPM (latents within 2e-3, frames above
40 dB, the JAX goldens' bounds; 9 frames are 3 latent frames padded to 4,
and the video has the 9 frames asked for); ``cli.run`` against
``alg_tpu.cli.run``; ``prepare_cli``'s encoder and a LoRA train step at 2
latent frames, with and without RoPE, against ``alg_tpu``; ``train_cli.run``
over the 1.5 directory and its refusal of an odd latent count;
``decode_latents(vae_tiling=)`` of CogVideoX and Wan; the QKV-fusion flags."""

import dataclasses
import json
import logging
import os
import shutil
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import alg_tpu.cli as JC
import alg_tpu.prepare_cli as JPC
import alg_tpu.train_cli as JTC
from alg_tpu import pipelines as JP
from alg_tpu import training as JT
from alg_tpu.io import model_zoo as JZ
from alg_tpu.models.cogvideox import CogVideoXTransformerConfig, cogvideox_rope as jax_rope
from alg_tpu.models.cogvideox import cogvideox_transformer, init_cogvideox_transformer

import alg_tpu_torch.cli as TC
from alg_tpu_torch import prepare_cli as TPC
from alg_tpu_torch import train_cli
from alg_tpu_torch.io import model_zoo as TZ
from alg_tpu_torch.io.jax_params import flatten_jax_tree, load_jax_lora
from alg_tpu_torch.models.cogvideox.transformer import CogVideoXTransformerConfig as TCfg
from alg_tpu_torch.models.cogvideox.transformer import cogvideox_rope
from alg_tpu_torch.pipelines.cogvideox import CogVideoXPipeline
from alg_tpu_torch.training import lora as TL
from alg_tpu_torch.training import train as TT

from torch_port_common import (build_pair, one_thread, one_torch_thread, port_cfg, port_module, psnr, random_tree,
                               tiny_configs, tiny_wan_configs)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import make_tiny_checkpoint  # noqa: E402


FWD_ATOL, ROPE_ATOL, LATENT_ATOL, MIN_PSNR_DB = 1e-4, 1e-6, 2e-3, 40.0
PROMPT = "a red double decker bus driving down the street"

# the tiny DiT of torch_port_common.tiny_configs, in each variant
VARIANTS = {
    "1.5-ofs": dict(patch_size_t=2, ofs_embed_dim=16),
    "1.5-no-ofs": dict(patch_size_t=2, ofs_embed_dim=16),  # the ofs embedding held but not given, as in training
    "no-rope": dict(use_rotary_positional_embeddings=False),
    "no-attention-bias": dict(attention_bias=False),
}


def _dit_cfg(**over):
    return CogVideoXTransformerConfig(num_attention_heads=4, attention_head_dim=16, in_channels=8, out_channels=4,
                                      time_embed_dim=16, text_embed_dim=12, num_layers=2, sample_height=4,
                                      sample_width=4, max_text_seq_length=4, **over)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_dit_matches_alg_tpu(variant):
    """4 latent frames (2 temporal patches at patch_size_t 2) of 8 x 12
    latents, two timesteps; the parameter trees agree key for key (no q/k/v
    biases where ``attention_bias`` is false)."""
    tcfg = _dit_cfg(**VARIANTS[variant])
    tree = random_tree(lambda k: init_cogvideox_transformer(k, tcfg), 3)
    rng = np.random.RandomState(4)
    x, enc = rng.randn(2, 4, 8, 8, 12).astype(np.float32), rng.randn(2, 5, 12).astype(np.float32)
    t = np.array([999.0, 17.0], np.float32)
    cos = sin = ofs = None
    if tcfg.use_rotary_positional_embeddings:
        cos, sin = jax_rope(tcfg, 64, 96, 4)
    if variant == "1.5-ofs":
        ofs = np.array([2.0], np.float32)
    ref = np.asarray(jax.jit(lambda p, *a: cogvideox_transformer(p, tcfg, *a[:5], ofs=a[5]))(
        tree, jnp.asarray(x), jnp.asarray(enc), jnp.asarray(t), cos, sin, None if ofs is None else jnp.asarray(ofs)))
    model = port_module("dit", tcfg, tree)
    as_t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    with torch.no_grad():
        out = model(*(as_t(a) for a in (x, enc, t, cos, sin)), ofs=as_t(ofs)).numpy()
    assert out.shape == ref.shape == (2, 4, 4, 8, 12)
    np.testing.assert_allclose(out, ref, atol=FWD_ATOL, rtol=0)
    names = set(model.state_dict())
    assert ("blocks.0.attn.to_q.bias" in names) == tcfg.attention_bias
    assert ("ofs_embedding.linear_1.weight" in names) == (tcfg.ofs_embed_dim is not None)


def test_ofs_moves_the_output_and_odd_latent_counts_are_refused():
    tcfg = _dit_cfg(patch_size_t=2, ofs_embed_dim=16)
    model = port_module("dit", tcfg, random_tree(lambda k: init_cogvideox_transformer(k, tcfg), 5))
    rng = np.random.RandomState(6)
    x, enc = torch.from_numpy(rng.randn(1, 2, 8, 8, 8).astype(np.float32)), torch.zeros(1, 3, 12)
    cos, sin = (torch.from_numpy(a) for a in cogvideox_rope(model.cfg, 64, 64, 2))
    t = torch.tensor([500.0])
    with torch.no_grad():
        assert (model(x, enc, t, cos, sin, ofs=torch.tensor([2.0])) - model(x, enc, t, cos, sin)).abs().max() > 1e-4
        with pytest.raises(ValueError, match="patch_size_t"):
            model(x[:, :1], enc, t, cos[:16], sin[:16])


@pytest.mark.parametrize("hw,frames", [((768, 1360), 22), ((768, 1360), 3), ((480, 720), 13), ((64, 96), 4),
                                       ((32, 32), 1)])
def test_slice_rope_tables_match_alg_tpu(hw, frames):
    """``ceil(F / 2)`` temporal positions and the leading rows and columns of
    the grid, at the published 1.5 size (21 latent frames padded to 22, and
    the smoke's 3) and smaller ones; the 1.0 "crop" tables beside them."""
    for over in (dict(patch_size_t=2, sample_height=300, sample_width=300), {}):
        jc = CogVideoXTransformerConfig(**over)
        tc = port_cfg(TCfg, jc)
        got, want = cogvideox_rope(tc, *hw, frames), jax_rope(jc, *hw, frames)
        pt = over.get("patch_size_t", 1)
        assert got[0].shape == want[0].shape == (-(-frames // pt) * (hw[0] // 16) * (hw[1] // 16), 64)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, atol=ROPE_ATOL, rtol=0)


# -- the loader, __call__, cli.run, prepare on the tiny 1.5 checkpoint -------------------------------


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """{"tool": tools/make_tiny_checkpoint.build(patch_size_t=2), "invert": the same with the VAE's
    invert_scale_latents set, as CogVideoX-1.5 ships it}."""
    root = tmp_path_factory.mktemp("cogvideox15")
    tool = str(root / "TinyCogVideoX1.5")
    make_tiny_checkpoint.build(tool, patch_size_t=2)
    invert = str(root / "TinyCogVideoX1.5-invert")
    shutil.copytree(tool, invert)
    path = os.path.join(invert, "vae", "config.json")
    vae = json.load(open(path))
    with open(path, "w") as f:
        json.dump({**vae, "invert_scale_latents": True}, f)
    return {"tool": tool, "invert": invert}


def _assert_same_config(port_cfg_, jax_cfg):
    for f in dataclasses.fields(port_cfg_):
        assert getattr(port_cfg_, f.name) == getattr(jax_cfg, f.name), f.name


@pytest.mark.parametrize("which", ["tool", "invert"])
def test_loader_matches_alg_tpu(ckpts, which):
    jp = JZ.load_cogvideox_pipeline(ckpts[which], dtype=jnp.float32)
    tp = TZ.load_cogvideox_pipeline(ckpts[which], dtype=torch.float32, device="cpu")
    for port_attr, jax_attr in (("transformer", "transformer"), ("vae", "vae"), ("t5", "t5")):
        module = getattr(tp, port_attr)
        got, want = module.state_dict(), dict(flatten_jax_tree(jax.device_get(getattr(jp, f"{jax_attr}_params"))))
        assert set(got) == set(want), sorted(set(got) ^ set(want))[:5]
        for name, t in got.items():
            assert np.array_equal(t.numpy(), np.asarray(want[name], np.float32)), f"{port_attr}.{name}"
        _assert_same_config(module.cfg, getattr(jp, f"{jax_attr}_cfg"))
    _assert_same_config(tp.scheduler_cfg, jp.scheduler_cfg)
    assert tp.transformer.cfg.patch_size_t == 2 and tp.transformer.cfg.ofs_embed_dim == 16
    assert tp.vae.cfg.invert_scale_latents == (which == "invert")
    assert tp.transformer.patch_embed["proj"].weight.shape == (32, 8 * 2 * 2 * 2)


def _call_kwargs(**over):
    image = np.random.RandomState(7).uniform(-1, 1, (1, 3, 32, 32)).astype(np.float32)
    return {**dict(image=image, prompt="a cat", negative_prompt="", height=32, width=32, num_frames=9,
                   num_inference_steps=4, guidance_scale=6.0, seed=42, max_sequence_length=8,
                   use_low_pass_guidance=True, lp_filter_type="down_up", lp_filter_in_latent=True,
                   lp_resize_factor=0.25, lp_strength_schedule_type="interval", schedule_interval_start_time=0.0,
                   schedule_interval_end_time=0.4), **over}


CALLS = {
    "latent-alg": ("ddim", {}),
    "noalg": ("ddim", dict(use_low_pass_guidance=False)),
    "pixel-alg": ("ddim", dict(lp_filter_type="gaussian_blur", lp_filter_in_latent=False, lp_blur_sigma=3.0,
                               lp_blur_kernel_size=0.1, lp_strength_schedule_type="linear",
                               schedule_linear_end_time=0.5)),
    "dpm": ("dpm", {}),
}


@pytest.fixture(scope="module")
def pipes(ckpts):
    """(alg_tpu's pipeline, the port's) over the invert_scale_latents checkpoint, fp32 on the CPU."""
    return (JZ.load_cogvideox_pipeline(ckpts["invert"], dtype=jnp.float32),
            TZ.load_cogvideox_pipeline(ckpts["invert"], dtype=torch.float32, device="cpu"))


@pytest.mark.parametrize("case", list(CALLS))
def test_call_matches_alg_tpu(pipes, case):
    """9 frames: 3 latent frames padded to 4 (both packages return the padded
    latents); each package decodes its own latents without the padded frame
    into the 9 frames asked for."""
    scheduler, over = CALLS[case]
    jpipe, tpipe = (dataclasses.replace(p, scheduler=scheduler) for p in pipes)
    kw = _call_kwargs(**over)
    ref = np.asarray(jpipe(output_type="latent", **kw))
    out = tpipe(output_type="latent", **kw)
    assert out.shape == ref.shape == (1, 4, 4, 4, 4)
    np.testing.assert_allclose(out, ref, atol=LATENT_ATOL, rtol=0)
    ref_frames = np.asarray(jpipe.decode_latents(jnp.asarray(ref[:, 1:])))
    out_frames = tpipe.decode_latents(torch.from_numpy(out[:, 1:])).numpy()
    assert out_frames.shape == ref_frames.shape == (1, 9, 3, 32, 32)
    to01 = lambda v: np.clip(v / 2 + 0.5, 0, 1)  # noqa: E731
    assert psnr(to01(out_frames), to01(ref_frames)) > MIN_PSNR_DB


def test_call_returns_the_frames_asked_for_and_resumes_over_the_padded_latents(pipes, tmp_path):
    """``np`` output has 9 frames, the port's decode of its latents without
    the padded frame; a run interrupted after step 2 and resumed from its
    snapshot (4 latent frames) ends bit for bit where the straight run does;
    an observer sees the padded latents."""
    _, tpipe = pipes
    kw = _call_kwargs()
    video = tpipe(output_type="np", **kw)
    lat = tpipe(output_type="latent", **kw)
    frames = tpipe.decode_latents(torch.from_numpy(lat[:, 1:])).numpy()
    assert video.shape == (1, 9, 32, 32, 3)
    np.testing.assert_allclose(video, np.clip(frames / 2 + 0.5, 0, 1).transpose(0, 1, 3, 4, 2), atol=1e-6)
    seen = []

    def stop_after_two(i, latents):
        seen.append(tuple(latents.shape))
        if i == 1:
            tpipe.interrupt = True

    ckpt = str(tmp_path / "run.npz")
    tpipe(output_type="latent", checkpoint=ckpt, checkpoint_every=1, step_observer=stop_after_two, **kw)
    assert seen == [(1, 4, 4, 4, 4)] * 2
    resumed = tpipe(output_type="latent", checkpoint=ckpt, checkpoint_every=1, **kw)
    assert np.array_equal(resumed, lat)


def test_invert_scale_latents_divides_the_image_latents(ckpts, pipes):
    """The same weights with and without ``invert_scale_latents`` condition
    the DiT on image latents scaled by 1/0.7 and by 0.7: different runs."""
    plain = TZ.load_cogvideox_pipeline(ckpts["tool"], dtype=torch.float32, device="cpu")
    z = torch.ones(1, 1, 4, 4, 4)
    assert torch.allclose(pipes[1]._scale_latents(z), z / 0.7) and torch.allclose(plain._scale_latents(z), z * 0.7)
    kw = _call_kwargs(num_inference_steps=2)
    assert np.abs(plain(output_type="latent", **kw) - pipes[1](output_type="latent", **kw)).max() > 1e-3


def _cli_config(path):
    return {
        "model": {"path": path, "dtype": "float32"},
        "generation": {"height": 32, "width": 32, "num_frames": 9, "num_inference_steps": 2, "guidance_scale": 6.0,
                       "max_sequence_length": 16},
        "alg": {"use_low_pass_guidance": True, "lp_filter_type": "down_up", "lp_filter_in_latent": True,
                "lp_blur_sigma": None, "lp_resize_factor": 0.25, "lp_strength_schedule_type": "interval",
                "schedule_interval_start_time": 0.0, "schedule_interval_end_time": 0.5},
        "video": {"fps": 8},
    }


def test_cli_run_matches_alg_tpu(ckpts, tmp_path, monkeypatch):
    """``alg_tpu_torch.cli.run`` against ``alg_tpu.cli.run`` over the tiny 1.5
    directory (as ``tests/test_cli.py`` runs it), the same YAML file, image
    and prompt: the latents handed to the decode (the padded frame dropped)
    within 2e-3, the written frames (9) above 40 dB."""
    yaml = pytest.importorskip("yaml")
    import alg_tpu.io.video as JV
    import alg_tpu_torch.io.video as TV

    got = {}
    for key, cls in (("jax", JP.CogVideoXPipeline), ("port", CogVideoXPipeline)):
        def kept(self, latents, *args, _decode=cls.decode_latents, _key=key, **kwargs):
            got[f"{_key}_latents"] = np.array(latents)
            return _decode(self, latents, *args, **kwargs)

        monkeypatch.setattr(cls, "decode_latents", kept)
    for key, module in (("jax", JV), ("port", TV)):
        def write(path, frames, fps, _write=module.write_video, _key=key):
            got[f"{_key}_frames"] = TV._frames_to_uint8(frames)
            return _write(path, frames, fps)

        monkeypatch.setattr(module, "write_video", write)
        monkeypatch.setattr(module.shutil, "which", lambda name: None)
    with open(tmp_path / "c.yaml", "w") as f:
        yaml.safe_dump(_cli_config(ckpts["invert"]), f)
    image = os.path.join(os.path.dirname(__file__), "..", "assets", "a red double decker bus driving down a street.jpg")
    argv = ["--config", str(tmp_path / "c.yaml"), "--image_path", image, "--prompt", PROMPT]
    JC.run(JC.build_parser().parse_args(argv + ["--output_path", str(tmp_path / "jax.mp4")]))
    TC.run(TC.build_parser().parse_args(argv + ["--output_path", str(tmp_path / "port.mp4"), "--device", "cpu"]))
    assert got["port_latents"].shape == got["jax_latents"].shape == (1, 3, 4, 4, 4)
    assert np.abs(got["port_latents"] - got["jax_latents"]).max() <= LATENT_ATOL
    assert got["port_frames"].shape == (9, 32, 32, 3)
    assert psnr(got["port_frames"] / 255.0, got["jax_frames"] / 255.0) > MIN_PSNR_DB


def test_prepare_encoder_matches_alg_tpu(ckpts, pipes):
    """``encode_cogvideox`` on a 5-frame clip (2 latent frames, a multiple of
    patch_size_t) with ``invert_scale_latents``: every array within 1e-4."""
    jpipe, tpipe = pipes
    clip = np.random.RandomState(3).uniform(-1, 1, (5, 3, 32, 32)).astype(np.float32)
    got = TPC.encode_cogvideox(tpipe, clip, PROMPT, 8)
    want = JPC.encode_cogvideox(jpipe, clip, PROMPT, 8)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].shape == want[key].shape and got[key].dtype == np.float32, key
        np.testing.assert_allclose(got[key], want[key], atol=1e-4, rtol=1e-4, err_msg=key)
    assert got["latents"].shape == (2, 4, 4, 4)


def _cog_draws(key, shape):
    kt, kn = jax.random.split(key)
    t = np.asarray(jax.random.randint(kt, (shape[0],), 0, 1000))
    noise = np.asarray(jax.random.normal(kn, shape, jnp.float32))
    return {"t": torch.from_numpy(t.astype(np.int64)), "noise": torch.from_numpy(noise.copy())}


@pytest.mark.parametrize("variant", ["1.5", "no-rope"])
def test_lora_train_step_matches_alg_tpu(variant):
    """One LoRA step at 2 latent frames through each package's ``build_loss``,
    as ``alg_tpu`` trains it: the 1.5 DiT (one temporal patch, RoPE from the
    slice grid, no ofs in the loss) and a DiT without RoPE (no tables, so no
    qk_prep): loss rtol 1e-5, adapters atol 1e-5."""
    tcfg = _dit_cfg(**({"patch_size_t": 2, "ofs_embed_dim": 16} if variant == "1.5"
                       else {"use_rotary_positional_embeddings": False}))
    tree = random_tree(lambda k: init_cogvideox_transformer(k, tcfg), 7)
    rng = np.random.RandomState(8)
    batch = {"latents": rng.randn(2, 2, 4, 8, 8).astype(np.float32),
             "image_latents": rng.randn(2, 2, 4, 8, 8).astype(np.float32),
             "encoder_hidden_states": rng.randn(2, 3, 12).astype(np.float32)}
    key = jax.random.PRNGKey(9)
    tc = dict(learning_rate=1e-2, weight_decay=0.1, grad_clip=1.0, eps=1e-6)
    jloras = jax.tree.map(lambda x: np.asarray(x) + np.float32(0.03),
                          JT.init_lora_params(jax.random.PRNGKey(5), tree, rank=4, prefixes=("blocks",)))
    geom = (2, 8, 8)
    jbase = JTC.build_loss(SimpleNamespace(transformer_cfg=tcfg), "cogvideox",
                           SimpleNamespace(compute_dtype="float32", shift=None), geom)
    jloss = JT.make_lora_loss(jbase, jax.tree.map(jnp.asarray, tree), attach=True)
    step, opt = JT.make_train_step(jloss, JT.TrainConfig(**tc))
    params = jax.tree.map(jnp.asarray, jloras)
    jparams, _, jm = step(params, opt.init(params), {k: jnp.asarray(v) for k, v in batch.items()}, key)

    model = port_module("dit", tcfg, tree)
    base = {n: p.detach().clone() for n, p in model.named_parameters()}
    loss = TL.make_lora_loss(train_cli.build_loss(model, "cogvideox", geom, None, None, 6.0), base, attach=True)
    tstep, topt = TT.make_train_step(loss, TT.TrainConfig(**tc))
    loras = load_jax_lora(jloras)
    loras, _, m = tstep(loras, topt.init(loras), {k: torch.from_numpy(v) for k, v in batch.items()},
                        _cog_draws(key, batch["latents"].shape))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    for path, ab in jax.tree.map(np.asarray, jparams).items():
        for name in ("A", "B"):
            np.testing.assert_allclose(loras[path][name].detach().numpy(), ab[name], atol=1e-5,
                                       err_msg=f"{path}/{name}")


def test_train_cli_over_the_1_5_directory(ckpts, tmp_path):
    """prepare -> train over the tiny 1.5 directory: 5-frame clips (2 latent
    frames) train; 9-frame ones (3 latent frames) raise a ValueError naming
    patch_size_t, where ``alg_tpu``'s reshape fails."""
    root, name = os.path.split(ckpts["invert"])
    config = {"model": {"path": name, "dtype": "float32"},
              "generation": {"height": 32, "width": 32, "num_frames": 5, "max_sequence_length": 8}}
    for frames, data in ((5, tmp_path / "even"), (9, tmp_path / "odd")):
        clip = np.random.RandomState(frames).randint(0, 256, (frames, 32, 32, 3), dtype=np.uint8)
        np.save(tmp_path / f"clip{frames}.npy", clip)
        TPC.run(TPC.build_parser().parse_args([
            "--config", "unused.yaml", "--device", "cpu", "--output_dir", str(data), "--model_cache_dir", root,
            "--video", str(tmp_path / f"clip{frames}.npy"), "--prompt", PROMPT]),
            {**config, "generation": {**config["generation"], "num_frames": frames}})

    def args(data, out):
        return train_cli.make_parser().parse_args([
            "--config", "unused.yaml", "--device", "cpu", "--model_cache_dir", root, "--data", str(data),
            "--steps", "2", "--batch_size", "1", "--rank", "2", "--log_every", "100", "--output", str(out)])

    out = train_cli.run(config, args(tmp_path / "even", tmp_path / "a.npz"))
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    with np.load(tmp_path / "a.npz") as z:
        assert z.files
    with pytest.raises(ValueError, match="patch_size_t"):
        train_cli.run(config, args(tmp_path / "odd", tmp_path / "b.npz"))


# -- decode_latents(vae_tiling=) and the fusion flags -------------------------------------------------


def _vae_pair(family):
    """(JAX pipeline, port pipeline) holding only a VAE: ``decode_latents``
    needs nothing else. Each is ``build_pair``'s or ``build_wan_pair``'s cut
    to its first two levels (spatial scale 2), whose reference traces and
    compiles in half the time at each tile shape."""
    from alg_tpu.models.cogvideox import init_cogvideox_vae
    from alg_tpu.models.wan import init_wan_vae

    from alg_tpu_torch.pipelines.wan import WanPipeline

    if family == "cogvideox":
        tcfg, vcfg, t5cfg = tiny_configs()
        vcfg = dataclasses.replace(vcfg, block_out_channels=vcfg.block_out_channels[:2], layers_per_block=0)
        vp = random_tree(lambda k: init_cogvideox_vae(k, vcfg), 2)
        return (JP.CogVideoXPipeline(transformer_cfg=tcfg, transformer_params=None, vae_cfg=vcfg, vae_params=vp,
                                     t5_cfg=t5cfg, t5_params=None, tokenize=None),
                CogVideoXPipeline(transformer=None, vae=port_module("vae", vcfg, vp), device="cpu"))
    tcfg, vcfg, t5cfg, _ = tiny_wan_configs()
    vcfg = dataclasses.replace(vcfg, dim_mult=vcfg.dim_mult[:2], temperal_downsample=vcfg.temperal_downsample[:1])
    vp = random_tree(lambda k: init_wan_vae(k, vcfg), 12)
    return (JP.WanPipeline(transformer_cfg=tcfg, transformer_params=None, vae_cfg=vcfg, vae_params=vp, t5_cfg=t5cfg,
                           t5_params=None, tokenize=None),
            WanPipeline(transformer=None, vae=port_module("wan_vae", vcfg, vp), device="cpu"))


@pytest.mark.parametrize("family", ["cogvideox", "wan"])
def test_decode_latents_vae_tiling_matches_alg_tpu(family):
    """A 34 x 34 latent (below the 48 x 48 of the automatic rule): forced
    tiles (32 wide at stride 24, a seam each way) and one whole decode, each
    against ``alg_tpu``'s with the same flag; the two differ at the seams.
    The pipelines hold the VAE alone."""
    jpipe, tpipe = _vae_pair(family)
    shape = (1, 1, 4, 34, 34) if family == "cogvideox" else (1, 4, 1, 34, 34)
    z = np.random.RandomState(2).randn(*shape).astype(np.float32)
    outs = {}
    for tiling in (True, False, None):
        with one_torch_thread():
            got = tpipe.decode_latents(torch.from_numpy(z), vae_tiling=tiling).numpy()
        want = np.asarray(jpipe.decode_latents(jnp.asarray(z), vae_tiling=tiling))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0, err_msg=str(tiling))
        outs[tiling] = got
    assert np.array_equal(outs[None], outs[False]) and np.abs(outs[True] - outs[False]).max() > 1e-4


def test_fuse_qkv_flags_change_nothing(caplog):
    jpipe, tpipe = build_pair()
    kw = dict(_call_kwargs(num_inference_steps=2, num_frames=5), max_sequence_length=4)
    before = tpipe(output_type="latent", **kw)
    for pipe in (tpipe, jpipe):
        with caplog.at_level(logging.WARNING):
            caplog.clear()
            pipe.unfuse_qkv_projections()
            assert "not initially fused" in caplog.text
        pipe.fuse_qkv_projections()
        assert pipe.fusing_transformer
    assert np.array_equal(tpipe(output_type="latent", **kw), before)
    caplog.clear()
    tpipe.unfuse_qkv_projections()
    assert not tpipe.fusing_transformer and "not initially fused" not in caplog.text

