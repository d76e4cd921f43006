"""The port's train entry point on the CPU at a tiny size: the run body
(``train_cli.run``) over synthetic examples and over a data directory, LoRA
and full fine-tune, accumulation with remat and bf16 compute, EMA export,
checkpoint and resume (the counterpart of the JAX package's
``test_train_cli_*`` tests, which run its CLI the same way); training over
a checkpoint directory (``io/model_zoo.load_transformer``, bit-equal to the
pipeline loaders' DiT), the whole fine-tuning loop (the port's prepare, then
train over the checkpoint, then the adapters merged by both packages and by
``cli.run --lora``; the counterpart of ``tests/test_prepare.py``), the
validation holdout against ``alg_tpu``'s rule, and the profiler trace."""

import json
import os
import sys

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
from alg_tpu_torch.utils.profiling import span, trace_to

from torch_port_common import one_thread


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
    with pytest.raises(SystemExit):  # alg_tpu's parser error: --quantize trains adapters only
        train_cli.run(config, _args(tmp_path, "--synthetic", "2", "--quantize", "w8", "--mode", "full"),
                      transformer=model)
    with pytest.raises(ValueError, match="shards a full fine-tune"):  # LoRA runs on one rank
        train_cli.run(config, _args(tmp_path, "--synthetic", "2", "--tp", "2"), transformer=model)
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):  # a mesh larger than the launch
        train_cli.run(config, _args(tmp_path, "--synthetic", "2", "--tp", "2", "--mode", "full"), transformer=model)
    with pytest.raises(ValueError, match="--data or --synthetic"):
        train_cli.run(config, _args(tmp_path), transformer=model)
    with pytest.raises(ValueError, match="--checkpoint_dir"):
        train_cli.run(config, _args(tmp_path, "--synthetic", "2", "--resume"), transformer=model)
    with pytest.raises(ValueError, match="family"):
        train_cli.family_of("stabilityai/svd")
    assert [train_cli.family_of(p) for p in ("THUDM/CogVideoX-5b-I2V", "Wan-AI/Wan2.1-I2V-14B-480P-Diffusers",
                                             "hunyuanvideo-community/HunyuanVideo-I2V")] == list(train_cli.FAMILIES)


# -- training over a checkpoint directory ---------------------------------------------------


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    from alg_tpu_torch.io import hf_checkpoint as H

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
    import make_tiny_checkpoint

    root = tmp_path_factory.mktemp("train_ckpts")
    H.write_cogvideox(str(root / "TinyCogVideoX"), dtype=torch.float32)
    H.write_wan(str(root / "TinyWan"), dtype=torch.float32)
    make_tiny_checkpoint.build_hunyuan(str(root / "TinyHunyuanVideo"))
    make_tiny_checkpoint.build(str(root / "TinyCogVideoX-1.5"), patch_size_t=2)
    return {"cogvideox": str(root / "TinyCogVideoX"), "wan": str(root / "TinyWan"),
            "hunyuan": str(root / "TinyHunyuanVideo"), "cogvideox-1.5": str(root / "TinyCogVideoX-1.5")}


def _pipeline_dit(family, path, dtype=torch.float32):
    from alg_tpu_torch.io import model_zoo

    load = {"cogvideox": model_zoo.load_cogvideox_pipeline, "wan": model_zoo.load_wan_pipeline,
            "hunyuan": model_zoo.load_hunyuan_pipeline}[family]
    return load(path, dtype=dtype, device="cpu").transformer


@pytest.mark.parametrize("family", train_cli.FAMILIES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_load_transformer_is_the_pipeline_loaders_dit(ckpts, family, dtype):
    from alg_tpu_torch.io import model_zoo

    dit = model_zoo.load_transformer(ckpts[family], family, dtype=dtype, device="cpu")
    want = _pipeline_dit(family, ckpts[family], dtype).state_dict()
    got = dit.state_dict()
    assert type(dit) is type(_pipeline_dit(family, ckpts[family])) and list(got) == list(want)
    for name, t in got.items():
        assert t.dtype == want[name].dtype and t.device.type == "cpu"
        assert torch.equal(t.view(torch.int16) if t.dtype == torch.bfloat16 else t,
                           want[name].view(torch.int16) if t.dtype == torch.bfloat16 else want[name]), name
    assert not any(p.requires_grad for p in dit.parameters())


def test_load_transformer_keeps_the_loaders_refusals(ckpts):
    from alg_tpu_torch.io import model_zoo

    # quantize, once refused (A12), loads: the tiny DiTs' linears are narrower than 128, so none is quantized
    for name, mode in (("cogvideox", "w8"), ("cogvideox-1.5", "w4")):
        got = model_zoo.load_transformer(ckpts[name], "cogvideox", quantize=mode, device="cpu").state_dict()
        want = model_zoo.load_transformer(ckpts[name], "cogvideox", device="cpu").state_dict()
        assert list(got) == list(want) and all(torch.equal(got[n], want[n]) for n in want)
    with pytest.raises(ValueError, match="quantization mode"):
        model_zoo.load_transformer(ckpts["cogvideox"], "cogvideox", quantize="w2", device="cpu")
    with pytest.raises(ValueError, match="family"):
        model_zoo.load_transformer(ckpts["cogvideox"], "svd", device="cpu")


def _ckpt_args(tmp_path, *extra):
    return train_cli.make_parser().parse_args([
        "--config", "unused.yaml", "--device", "cpu", "--output", str(tmp_path / "out.npz"), "--lr", "1e-2",
        "--log_every", "100", "--rank", "2", *extra])


@pytest.mark.parametrize("family", train_cli.FAMILIES)
def test_training_over_a_checkpoint_directory_matches_the_dit_passed_in(ckpts, tmp_path, family):
    """``model.path`` as a directory, and as a name under ``--model_cache_dir``."""
    root, name = os.path.split(ckpts[family])
    config = {"model": {"path": name, "dtype": "float32"}, "generation": dict(GEN)}
    common = ("--synthetic", "3", "--steps", "3", "--batch_size", "2")
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    loaded = train_cli.run(config, _ckpt_args(tmp_path / "a", "--model_cache_dir", root, *common))
    passed = train_cli.run(config, _ckpt_args(tmp_path / "b", *common), transformer=_pipeline_dit(family, ckpts[family]))
    assert loaded["losses"] == passed["losses"] and np.isfinite(loaded["losses"]).all()
    with np.load(tmp_path / "a" / "out.npz") as za, np.load(tmp_path / "b" / "out.npz") as zb:
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
            np.testing.assert_array_equal(za[k], zb[k], err_msg=k)
    with pytest.raises(FileNotFoundError, match="not found locally"):
        train_cli.run(config, _ckpt_args(tmp_path, *common))


def test_prepare_train_merge_loop(ckpts, tmp_path):
    """The port's prepare -> train over the checkpoint -> the adapters merged
    by both packages and by ``cli.run --lora`` to a written video."""
    import jax.numpy as jnp

    from alg_tpu.io import model_zoo as JZ
    from alg_tpu.io.lora import merge_lora_cogvideox as jax_merge
    from alg_tpu_torch import cli, prepare_cli
    from alg_tpu_torch.io import model_zoo

    rng = np.random.RandomState(7)
    items = []
    for i, frames in enumerate((5, 7, 5)):
        np.save(tmp_path / f"clip{i}.npy", rng.randint(0, 256, (frames, 32, 32, 3)).astype(np.uint8))
        items.append({"video": str(tmp_path / f"clip{i}.npy"), "prompt": "a red double decker bus"})
    (tmp_path / "manifest.jsonl").write_text("".join(json.dumps(it) + "\n" for it in items))
    config = {"model": {"path": ckpts["cogvideox"], "dtype": "float32"},
              "generation": {"height": 32, "width": 32, "num_frames": 5, "num_inference_steps": 2,
                             "guidance_scale": 6.0, "max_sequence_length": 8},
              "video": {"fps": 8}}
    data = tmp_path / "latents"
    prepare_cli.run(prepare_cli.build_parser().parse_args(
        ["--config", "-", "--manifest", str(tmp_path / "manifest.jsonl"), "--output_dir", str(data),
         "--device", "cpu"]), config)
    assert sorted(os.listdir(data)) == [f"example_{i:05d}.npz" for i in range(3)]

    out = train_cli.run(config, _ckpt_args(tmp_path, "--data", str(data), "--steps", "3", "--batch_size", "2",
                                           "--val_frac", "0.34", "--eval_every", "2"))
    assert len(out["losses"]) == 3 and len(out["val_losses"]) == 2 and np.isfinite(out["val_losses"]).all()
    with np.load(tmp_path / "out.npz") as z:
        state = {k: z[k] for k in z.files}

    dit = model_zoo.load_transformer(ckpts["cogvideox"], "cogvideox", dtype=torch.float32, device="cpu")
    base = dict(dit.named_parameters())
    merged = merge_lora_cogvideox(base, state)
    jax_tree = JZ.load_cogvideox_pipeline(ckpts["cogvideox"], dtype=jnp.float32).transformer_params
    jax_merged = jax_merge(jax_tree, state, scale=1.0)
    for layer in range(dit.cfg.num_layers):
        for path, module in (("attn/to_q", "attn.to_q"), ("ff/fc_out", "ff.fc_out")):
            a, b = path.split("/")
            name = f"blocks.{layer}.{module}.weight"
            assert not torch.equal(merged[name], base[name]), name
            np.testing.assert_allclose(np.asarray(jax_merged["blocks"][a][b]["kernel"][layer]).T,
                                       merged[name].numpy(), atol=1e-6, rtol=1e-6, err_msg=name)

    image = rng.randint(0, 256, (32, 32, 3)).astype(np.uint8)
    args = cli.build_parser().parse_args(["--lora", str(tmp_path / "out.npz"), "--device", "cpu",
                                          "--output_path", str(tmp_path / "video.mp4")])
    written = cli.run(args, config=config, image=image)
    assert os.path.exists(written)


def _jax_holdout(n, val_frac, batch_size):
    """``alg_tpu/train_cli.py``'s holdout, line for line: the indices of the held-out examples in batch order."""
    n_val = max(1, int(n * val_frac))
    val_examples = list(range(n - n_val, n))
    while len(val_examples) % batch_size:
        val_examples.append(val_examples[len(val_examples) % n_val])
    return n - n_val, val_examples


@pytest.mark.parametrize("n", [2, 3, 5, 7, 10])
@pytest.mark.parametrize("val_frac", [0.1, 0.34, 0.5])
@pytest.mark.parametrize("batch_size", [1, 2, 3])
def test_validation_split_is_alg_tpus_rule(n, val_frac, batch_size):
    assert train_cli.validation_split(n, val_frac, batch_size) == _jax_holdout(n, val_frac, batch_size)


def test_validation_split_refuses_to_hold_out_everything():
    with pytest.raises(ValueError, match="all 1 examples"):
        train_cli.validation_split(1, 0.5, 1)


@pytest.mark.parametrize("source", ["synthetic", "data"])
def test_validation_means_are_the_loss_on_the_held_out_batches(tmp_path, source):
    from alg_tpu_torch.training.lora import make_lora_loss

    model, config = _tiny("cogvideox")
    examples = train_cli.synth_examples("cogvideox", model.cfg, 7, GEN, seed=42)
    if source == "data":
        data = tmp_path / "data"
        data.mkdir()
        for i, ex in enumerate(examples):
            np.savez(data / f"ex{i}.npz", **ex)
        picked = ("--data", str(data))
    else:
        picked = ("--synthetic", "7")
    out = train_cli.run(config, _args(tmp_path, *picked, "--steps", "4", "--rank", "2", "--batch_size", "2",
                                      "--val_frac", "0.5", "--eval_every", "3"), transformer=model)
    assert len(out["val_losses"]) == 2  # at step 3 and at the last step

    _, held = _jax_holdout(7, 0.5, 2)
    assert held == [4, 5, 6, 4]
    loss = make_lora_loss(train_cli.build_loss(model, "cogvideox", (2, 4, 4), torch.float32, None, 6.0), None,
                          attach=True)
    base = dict(model.named_parameters())
    vals = []
    with torch.no_grad():
        for j in range(0, len(held), 2):
            batch = {k: torch.from_numpy(np.stack([examples[i][k] for i in held[j:j + 2]])) for k in examples[0]}
            draws = loss.draw(batch, torch.Generator().manual_seed(10_000 + j // 2))
            vals.append(float(loss(out["trainable"], batch, draws, base)))
    assert out["val_losses"][-1] == float(np.mean(vals))


def test_profile_dir_writes_a_trace(tmp_path):
    model, config = _tiny("cogvideox")
    prof = tmp_path / "prof"
    out = train_cli.run(config, _args(tmp_path, "--synthetic", "2", "--steps", "3", "--rank", "2",
                                      "--profile_dir", str(prof)), transformer=model)
    assert len(out["losses"]) == 3
    trace, spans_file = sorted(os.listdir(prof), reverse=True)  # the Chrome trace, and the spans beside it
    assert trace.startswith("trace_") and trace.endswith(".json") and spans_file == "spans_" + trace[len("trace_"):]
    with open(prof / trace) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
    with open(prof / spans_file) as f:  # the spans of the traced steps
        assert any(r["name"] == "dit.block" for r in json.load(f))
    # a run of one step has no step after the warm-up to trace
    train_cli.run(config, _args(tmp_path, "--synthetic", "2", "--steps", "1", "--profile_dir", str(tmp_path / "p1")),
                  transformer=model)
    assert not os.path.exists(tmp_path / "p1") or not os.listdir(tmp_path / "p1")


def test_trace_to_writes_spans(tmp_path):
    """``trace_to`` writes the Chrome trace and, beside it, the spans made inside the block."""
    with trace_to(str(tmp_path / "t")):
        with span("operator.stage", rows=2):
            torch.ones(8, 8) @ torch.ones(8, 8)
    trace, spans_file = sorted(os.listdir(tmp_path / "t"), reverse=True)
    assert spans_file == "spans_" + trace[len("trace_"):]
    with open(tmp_path / "t" / trace) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"aten::mm", "operator.stage"} <= names
    with open(tmp_path / "t" / spans_file) as f:
        (rec,) = json.load(f)
    assert rec["name"] == "operator.stage" and rec["attrs"] == {"rows": 2} and rec["parent"] is None
    assert rec["device_ms"] >= 0.0 and rec["clock"] == "host"
