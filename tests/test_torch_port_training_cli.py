"""The port's train entry point on the CPU at a tiny size: the run body
(``train_cli.run``) over synthetic examples and over a data directory, LoRA
and full fine-tune, accumulation with remat and bf16 compute, EMA export,
checkpoint and resume (the counterpart of the JAX package's
``test_train_cli_*`` tests, which run its CLI the same way)."""

import os

import numpy as np
import pytest
import torch

from alg_tpu_torch import train_cli
from alg_tpu_torch.io.lora import merge_lora_cogvideox
from alg_tpu_torch.models import layers as L
from alg_tpu_torch.models.cogvideox.transformer import CogVideoXTransformer, CogVideoXTransformerConfig
from alg_tpu_torch.models.hunyuan.transformer import HunyuanVideoTransformer, HunyuanVideoTransformerConfig
from alg_tpu_torch.models.wan.transformer import WanTransformer, WanTransformerConfig
from alg_tpu_torch.training.train import load_params_npz

GEN = {"height": 32, "width": 32, "num_frames": 5, "max_sequence_length": 4, "guidance_scale": 6.0}


def _tiny(family):
    gen = torch.Generator().manual_seed(0)
    if family == "cogvideox":
        model = CogVideoXTransformer(CogVideoXTransformerConfig(
            num_attention_heads=2, attention_head_dim=16, in_channels=8, out_channels=4, time_embed_dim=16,
            text_embed_dim=12, num_layers=2, sample_height=4, sample_width=4, max_text_seq_length=4))
        path = "THUDM/CogVideoX-5b-I2V"
    elif family == "wan":
        model = WanTransformer(WanTransformerConfig(num_attention_heads=2, attention_head_dim=12, in_channels=12,
                                                    out_channels=4, num_layers=2, ffn_dim=32, freq_dim=16, text_dim=8,
                                                    image_dim=10))
        path = "Wan-AI/Wan2.1-I2V-14B-480P-Diffusers"
    else:
        model = HunyuanVideoTransformer(HunyuanVideoTransformerConfig(
            in_channels=4, out_channels=4, num_attention_heads=2, attention_head_dim=8, num_layers=1,
            num_single_layers=1, num_refiner_layers=1, mlp_ratio=2.0, text_embed_dim=12, pooled_projection_dim=6,
            rope_axes_dim=(2, 4, 2)))
        path = "hunyuanvideo-community/HunyuanVideo-I2V"
    return L.init_random_(model, gen), {"model": {"path": path, "dtype": "float32"}, "generation": dict(GEN)}


def _args(tmp_path, *extra):
    return train_cli.make_parser().parse_args([
        "--config", "unused.yaml", "--random_init", "--device", "cpu", "--output", str(tmp_path / "out.npz"),
        "--lr", "1e-2", "--log_every", "100", *extra])


@pytest.mark.parametrize("family", train_cli.FAMILIES)
def test_lora_run_exports_peft_adapters(tmp_path, family):
    model, config = _tiny(family)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    out = train_cli.run(config, _args(tmp_path, "--synthetic", "4", "--steps", "6", "--rank", "2", "--batch_size", "2"),
                        transformer=model)
    assert out["steps"] == 6 and np.isfinite(out["losses"]).all()
    assert all(torch.equal(p, before[n]) for n, p in model.named_parameters())  # the base never moves
    with np.load(tmp_path / "out.npz") as z:
        state = {k: z[k] for k in z.files}
    assert state and all(k.startswith("transformer.") and k.endswith((".lora_A.weight", ".lora_B.weight"))
                         for k in state)
    assert any(np.abs(v).max() > 0 for k, v in state.items() if "lora_B" in k)
    if family == "cogvideox":  # the export merges into the DiT's parameters
        merged = merge_lora_cogvideox(dict(model.named_parameters()), state)
        assert not torch.equal(merged["blocks.0.attn.to_q.weight"], before["blocks.0.attn.to_q.weight"])


def test_resume_continues_the_straight_run(tmp_path):
    """4 steps straight == 2 steps, then ``--resume`` to 4: the same exported adapters (EMA on)."""
    common = ("--synthetic", "4", "--rank", "2", "--ema_decay", "0.9", "--save_every", "2", "--remat", "--accum", "2",
              "--batch_size", "2")
    model, config = _tiny("cogvideox")
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    straight = train_cli.run(config, _args(tmp_path / "a", "--steps", "4", *common), transformer=model)
    ckpt = str(tmp_path / "b" / "ckpt")
    first = train_cli.run(config, _args(tmp_path / "b", "--steps", "2", "--checkpoint_dir", ckpt, *common),
                          transformer=model)
    assert sorted(os.listdir(ckpt)) == ["step_00000002.npz"]
    second = train_cli.run(config, _args(tmp_path / "b", "--steps", "4", "--checkpoint_dir", ckpt, "--resume", *common),
                           transformer=model)
    assert second["steps"] == 4 and first["losses"] + second["losses"] == straight["losses"]
    with np.load(tmp_path / "a" / "out.npz") as za, np.load(tmp_path / "b" / "out.npz") as zb:
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
            np.testing.assert_array_equal(za[k], zb[k], err_msg=k)


def test_full_finetune_over_a_data_directory_in_bf16_compute(tmp_path):
    model, config = _tiny("cogvideox")
    data = tmp_path / "data"
    data.mkdir()
    for i, ex in enumerate(train_cli.synth_examples("cogvideox", model.cfg, 3, GEN, seed=1)):
        np.savez(data / f"ex{i}.npz", **ex)
    out = train_cli.run(config, _args(tmp_path, "--data", str(data), "--steps", "3", "--mode", "full",
                                      "--compute_dtype", "bfloat16", "--prefetch", "0"), transformer=model)
    assert np.isfinite(out["losses"]).all()
    like = {n: p.detach().clone() for n, p in model.named_parameters()}
    saved = load_params_npz(str(tmp_path / "out.npz"), like)
    assert set(saved) == set(like) and all(t.dtype == torch.float32 for t in saved.values())  # fp32 masters
    assert any(not torch.equal(saved[n], like[n]) for n in like)
    assert all(torch.equal(p, like[n]) for n, p in model.named_parameters())  # the module itself is not trained


@pytest.mark.parametrize("family", train_cli.FAMILIES)
@pytest.mark.parametrize("mode", ["lora", "full"])
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_run_over_a_bf16_base(tmp_path, family, mode, compute_dtype):
    """A bf16 base, as the shipped configs name it, trains under either
    compute dtype: fp32 casts the base up inside the loss (PyTorch's linears
    do not promote), bf16 casts the fp32 adapters down and the LoRA products
    back up."""
    model, config = _tiny(family)
    model = model.to(torch.bfloat16)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    out = train_cli.run(config, _args(tmp_path, "--synthetic", "2", "--steps", "2", "--rank", "2", "--remat", "--mode",
                                      mode, "--compute_dtype", compute_dtype), transformer=model)
    assert out["steps"] == 2 and np.isfinite(out["losses"]).all()
    assert all(torch.equal(p, before[n]) for n, p in model.named_parameters())
    if mode == "lora":
        leaves = [t for ab in out["trainable"].values() for t in ab.values()]
        assert all(t.dtype == torch.float32 for t in leaves)  # the adapters stay fp32 masters
        assert all(bool(ab["B"].abs().max() > 0) for ab in out["trainable"].values())


def test_run_refuses_what_is_not_ported_and_bad_input(tmp_path):
    model, config = _tiny("cogvideox")
    args = train_cli.make_parser().parse_args(["--config", "c.yaml", "--device", "cpu", "--output", "o.npz",
                                               "--synthetic", "2"])
    with pytest.raises(NotImplementedError, match="A8"):
        train_cli.run(config, args)
    with pytest.raises(ValueError, match="--data or --synthetic"):
        train_cli.run(config, _args(tmp_path), transformer=model)
    with pytest.raises(ValueError, match="--checkpoint_dir"):
        train_cli.run(config, _args(tmp_path, "--synthetic", "2", "--resume"), transformer=model)
    with pytest.raises(ValueError, match="family"):
        train_cli.family_of("stabilityai/svd")
    assert [train_cli.family_of(p) for p in ("THUDM/CogVideoX-5b-I2V", "Wan-AI/Wan2.1-I2V-14B-480P-Diffusers",
                                             "hunyuanvideo-community/HunyuanVideo-I2V")] == list(train_cli.FAMILIES)
