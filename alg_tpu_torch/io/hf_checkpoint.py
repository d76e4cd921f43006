"""Write random CogVideoX-I2V, Wan2.1-I2V and HunyuanVideo-I2V checkpoints in
HF repo layout.

The port's counterpart of ``tools/make_tiny_checkpoint.py``'s CogVideoX (1.0
and 1.5), Wan and HunyuanVideo writers, at any width and depth:
``transformer/``, ``vae/``, ``text_encoder/`` (and Wan's ``image_encoder/``,
HunyuanVideo's ``text_encoder_2/``), each with its ``config.json`` and one
safetensors shard under the diffusers / transformers tensor names,
``tokenizer/`` (and HunyuanVideo's ``tokenizer_2/``: WordLevel
``tokenizer.json`` files written as plain JSON) and CogVideoX's
``scheduler/``. The widths and depths come from a config dict
(:data:`TINY_COGVIDEOX`, :data:`COGVIDEOX_5B_I2V`, :data:`TINY_COGVIDEOX15`,
:data:`COGVIDEOX15_5B_I2V`, :data:`TINY_WAN`, :data:`WAN21_I2V_14B`,
:data:`TINY_HUNYUAN`, :data:`HUNYUAN_VIDEO_I2V`): at the published widths it
is a checkpoint that :mod:`alg_tpu_torch.io.model_zoo` loads as it would the
published one.

Tensors are drawn in order from one ``torch.Generator`` seeded with
``seed`` on ``device``: linear and conv weights N(0, 1/fan_in), biases and
tables N(0, 0.02²), embeddings N(0, 1); norm weights are ones and norm
biases zeros. They are saved in ``dtype`` (bf16 unless asked), as the
published transformer and text-encoder shards are, one tensor at a time
through the host. The writers return the tensors they drew, by
subdirectory and name, on ``device``.
"""

from __future__ import annotations

import copy
import json
import math
import os
from typing import Dict, List, Tuple

import torch

from alg_tpu_torch.io.safetensors import save_safetensors
from alg_tpu_torch.models.wan.vae import WAN21_LATENTS_MEAN, WAN21_LATENTS_STD

TINY_COGVIDEOX = {
    "transformer": {
        "num_attention_heads": 2, "attention_head_dim": 16, "in_channels": 8, "out_channels": 4,
        "time_embed_dim": 16, "text_embed_dim": 16, "num_layers": 2, "attention_bias": True,
        "sample_width": 8, "sample_height": 8, "sample_frames": 9, "patch_size": 2, "patch_size_t": None,
        "max_text_seq_length": 16, "norm_eps": 1e-5, "use_rotary_positional_embeddings": True,
    },
    "vae": {
        "block_out_channels": [8, 16, 16, 16], "latent_channels": 4, "layers_per_block": 1, "norm_num_groups": 4,
        "norm_eps": 1e-6, "temporal_compression_ratio": 4, "scaling_factor": 0.7, "invert_scale_latents": False,
    },
    "text_encoder": {
        "vocab_size": 64, "d_model": 16, "d_kv": 4, "d_ff": 32, "num_layers": 2, "num_heads": 4,
        "relative_attention_num_buckets": 8, "relative_attention_max_distance": 16,
    },
}

# THUDM/CogVideoX-5b-I2V's published widths and depths (its transformer/, vae/ and text_encoder/ config.json)
COGVIDEOX_5B_I2V = {
    "transformer": {
        "num_attention_heads": 48, "attention_head_dim": 64, "in_channels": 32, "out_channels": 16,
        "time_embed_dim": 512, "text_embed_dim": 4096, "num_layers": 42, "attention_bias": True,
        "sample_width": 90, "sample_height": 60, "sample_frames": 49, "patch_size": 2, "patch_size_t": None,
        "max_text_seq_length": 226, "norm_eps": 1e-5, "use_rotary_positional_embeddings": True,
    },
    "vae": {
        "block_out_channels": [128, 256, 256, 512], "latent_channels": 16, "layers_per_block": 3,
        "norm_num_groups": 32, "norm_eps": 1e-6, "temporal_compression_ratio": 4, "scaling_factor": 0.7,
        "invert_scale_latents": False,
    },
    "text_encoder": {
        "vocab_size": 32128, "d_model": 4096, "d_kv": 64, "d_ff": 10240, "num_layers": 24, "num_heads": 64,
        "relative_attention_num_buckets": 32, "relative_attention_max_distance": 128,
    },
}

# tools/make_tiny_checkpoint.build(patch_size_t=2): the tiny 1.0 checkpoint with temporal patches of 2 and the ofs
# embedding (a linear patch embed over C·pt·p·p, ofs_embedding as wide as the time embedding)
TINY_COGVIDEOX15 = {**TINY_COGVIDEOX,
                    "transformer": {**TINY_COGVIDEOX["transformer"], "patch_size_t": 2, "ofs_embed_dim": 16}}

# THUDM/CogVideoX1.5-5B-I2V's published widths and depths (its transformer/, vae/, text_encoder/ and scheduler/
# config.json): the DiT as 5b-I2V's but with temporal patches of 2, the ofs embedding (512) and no learned
# positional embedding; the VAE and T5-XXL as 5b-I2V's, the VAE with invert_scale_latents. Not confirmed offline:
# sample_height / sample_width 300 (the "slice" RoPE grid of 1.5 does not read them; the pipeline's default size
# does) and the scheduler's snr_shift_scale 1.0.
COGVIDEOX15_5B_I2V = {
    "transformer": {**COGVIDEOX_5B_I2V["transformer"], "ofs_embed_dim": 512, "sample_width": 300,
                    "sample_height": 300, "sample_frames": 81, "patch_size_t": 2,
                    "use_learned_positional_embeddings": False},
    "vae": {**COGVIDEOX_5B_I2V["vae"], "invert_scale_latents": True},
    "text_encoder": dict(COGVIDEOX_5B_I2V["text_encoder"]),
    "scheduler": {"snr_shift_scale": 1.0},
}

TINY_WAN = {
    "transformer": {
        "num_attention_heads": 2, "attention_head_dim": 12, "in_channels": 12, "out_channels": 4, "num_layers": 2,
        "ffn_dim": 32, "freq_dim": 16, "text_dim": 16, "image_dim": 16, "patch_size": [1, 2, 2], "eps": 1e-6,
    },
    "vae": {
        "base_dim": 8, "z_dim": 4, "dim_mult": [1, 2, 2, 2], "num_res_blocks": 1,
        "temperal_downsample": [False, True, True],
        "latents_mean": [-0.5 + i / 3 for i in range(4)], "latents_std": [1.0 + i / 3 for i in range(4)],
    },
    "text_encoder": {
        "vocab_size": 64, "d_model": 16, "d_kv": 4, "d_ff": 32, "num_layers": 2, "num_heads": 4,
        "relative_attention_num_buckets": 8, "relative_attention_max_distance": 16,
    },
    "image_encoder": {
        "hidden_size": 16, "intermediate_size": 32, "num_hidden_layers": 2, "num_attention_heads": 4,
        "image_size": 28, "patch_size": 14, "hidden_act": "gelu",
    },
}

# Wan-AI/Wan2.1-I2V-14B-480P-Diffusers' published widths and depths: the port's WanTransformerConfig,
# WanVAEConfig, UMT5-XXL (models/t5.UMT5_XXL) and CLIP ViT-H/14 (CLIPVisionConfig) defaults
WAN21_I2V_14B = {
    "transformer": {
        "num_attention_heads": 40, "attention_head_dim": 128, "in_channels": 36, "out_channels": 16, "num_layers": 40,
        "ffn_dim": 13824, "freq_dim": 256, "text_dim": 4096, "image_dim": 1280, "patch_size": [1, 2, 2], "eps": 1e-6,
    },
    "vae": {
        "base_dim": 96, "z_dim": 16, "dim_mult": [1, 2, 4, 4], "num_res_blocks": 2,
        "temperal_downsample": [False, True, True],
        "latents_mean": list(WAN21_LATENTS_MEAN), "latents_std": list(WAN21_LATENTS_STD),
    },
    "text_encoder": {
        "vocab_size": 256384, "d_model": 4096, "d_kv": 64, "d_ff": 10240, "num_layers": 24, "num_heads": 64,
        "relative_attention_num_buckets": 32, "relative_attention_max_distance": 128,
    },
    "image_encoder": {
        "hidden_size": 1280, "intermediate_size": 5120, "num_hidden_layers": 32, "num_attention_heads": 16,
        "image_size": 224, "patch_size": 14, "hidden_act": "gelu",
    },
}

# tools/make_tiny_checkpoint.build_hunyuan: the DiT, the HunyuanVideo VAE, Llava (a Llama with GQA and a CLIP
# vision tower, the legacy language_model.model.* layout) and the CLIP text model, the <image> token at 60
TINY_HUNYUAN = {
    "transformer": {
        "in_channels": 4, "out_channels": 4, "num_attention_heads": 2, "attention_head_dim": 8, "num_layers": 1,
        "num_single_layers": 2, "num_refiner_layers": 1, "mlp_ratio": 2.0, "patch_size": 2, "patch_size_t": 1,
        "text_embed_dim": 16, "pooled_projection_dim": 8, "guidance_embeds": True, "rope_theta": 256.0,
        "rope_axes_dim": [2, 4, 2], "image_condition_type": "token_replace",
    },
    "vae": {
        "latent_channels": 4, "block_out_channels": [8, 16, 16, 16], "layers_per_block": 1, "norm_num_groups": 4,
        "scaling_factor": 0.476986, "temporal_compression_ratio": 4,
    },
    "text_encoder": {
        "image_token_index": 60, "pad_token_id": 0,
        "text_config": {"vocab_size": 64, "hidden_size": 16, "intermediate_size": 32, "num_hidden_layers": 2,
                        "num_attention_heads": 4, "num_key_value_heads": 2, "rope_theta": 10000.0},
        "vision_config": {"hidden_size": 12, "intermediate_size": 24, "num_hidden_layers": 2, "num_attention_heads": 4,
                          "image_size": 28, "patch_size": 14, "hidden_act": "quick_gelu"},
    },
    "text_encoder_2": {
        "vocab_size": 64, "hidden_size": 8, "intermediate_size": 16, "num_hidden_layers": 2, "num_attention_heads": 4,
        "max_position_embeddings": 16, "hidden_act": "quick_gelu", "eos_token_id": 1,
    },
}

# HunyuanVideo-I2V's published widths and depths as the port's config defaults give them:
# HunyuanVideoTransformerConfig() (20 double, 40 single and 2 refiner blocks, 24 x 128 heads), HunyuanVAEConfig(),
# LlavaConfig() (Llama-3-8B with Llava's vocabulary, CLIP ViT-L/14-336) and CLIPTextConfig() (OpenAI ViT-L/14's
# text model). Not confirmed offline: the DiT's in_channels 16 and image_condition_type "token_replace" (a
# latent_concat release takes 2·16 + 1 channels), Llava's pad_token_id 128258 and the CLIP text model's
# eos_token_id 49407; the tensors are written in the legacy language_model.model.* layout, which the loader
# reads as it reads the newer model.language_model.* one.
HUNYUAN_VIDEO_I2V = {
    "transformer": {
        "in_channels": 16, "out_channels": 16, "num_attention_heads": 24, "attention_head_dim": 128, "num_layers": 20,
        "num_single_layers": 40, "num_refiner_layers": 2, "mlp_ratio": 4.0, "patch_size": 2, "patch_size_t": 1,
        "text_embed_dim": 4096, "pooled_projection_dim": 768, "guidance_embeds": True, "rope_theta": 256.0,
        "rope_axes_dim": [16, 56, 56], "image_condition_type": "token_replace",
    },
    "vae": {
        "latent_channels": 16, "block_out_channels": [128, 256, 512, 512], "layers_per_block": 2,
        "norm_num_groups": 32, "scaling_factor": 0.476986, "temporal_compression_ratio": 4,
    },
    "text_encoder": {
        "image_token_index": 128257, "pad_token_id": 128258,
        "text_config": {"vocab_size": 128320, "hidden_size": 4096, "intermediate_size": 14336, "num_hidden_layers": 32,
                        "num_attention_heads": 32, "num_key_value_heads": 8, "rope_theta": 500000.0},
        "vision_config": {"hidden_size": 1024, "intermediate_size": 4096, "num_hidden_layers": 24,
                          "num_attention_heads": 16, "image_size": 336, "patch_size": 14, "hidden_act": "quick_gelu"},
    },
    "text_encoder_2": {
        "vocab_size": 49408, "hidden_size": 768, "intermediate_size": 3072, "num_hidden_layers": 12,
        "num_attention_heads": 12, "max_position_embeddings": 77, "hidden_act": "quick_gelu", "eos_token_id": 49407,
    },
}

COGVIDEOX_SCHEDULER = {
    "_class_name": "CogVideoXDDIMScheduler", "num_train_timesteps": 1000, "beta_start": 0.00085, "beta_end": 0.012,
    "beta_schedule": "scaled_linear", "snr_shift_scale": 3.0, "rescale_betas_zero_snr": True,
    "set_alpha_to_one": True, "timestep_spacing": "trailing", "prediction_type": "v_prediction",
}

Spec = List[Tuple[str, Tuple[int, ...], str]]  # (tensor name, shape, kind)


class _Spec:
    """The tensors of one shard in the order they are drawn. Kinds: ``w`` a
    weight (N(0, 1/fan_in), fan_in the product of the dims after the first),
    ``b`` a bias or table (N(0, 0.02²)), ``e`` an embedding (N(0, 1)),
    ``1`` and ``0`` a norm's weight and bias."""

    def __init__(self):
        self.items: Spec = []

    def add(self, name: str, shape, kind: str = "w") -> None:
        self.items.append((name, tuple(int(d) for d in shape), kind))

    def linear(self, name: str, n_out: int, n_in: int, bias: bool = True) -> None:
        self.add(f"{name}.weight", (n_out, n_in))
        if bias:
            self.add(f"{name}.bias", (n_out,), "b")

    def conv(self, name: str, cin: int, cout: int, *kernel) -> None:
        self.add(f"{name}.weight", (cout, cin, *kernel))
        self.add(f"{name}.bias", (cout,), "b")

    def norm(self, name: str, ch: int, bias: bool = True) -> None:
        self.add(f"{name}.weight", (ch,), "1")
        if bias:
            self.add(f"{name}.bias", (ch,), "0")


# -- CogVideoX ------------------------------------------------------------------------


def cogvideox_transformer_spec(cfg: dict) -> Spec:
    s = _Spec()
    heads, hd = cfg["num_attention_heads"], cfg["attention_head_dim"]
    dim, te, p = heads * hd, cfg["time_embed_dim"], cfg["patch_size"]
    pt, ofs = cfg.get("patch_size_t"), cfg.get("ofs_embed_dim")
    if pt is None:
        s.conv("patch_embed.proj", cfg["in_channels"], dim, p, p)  # 1.0 ships a conv2d patch embed
    else:
        s.linear("patch_embed.proj", dim, cfg["in_channels"] * pt * p * p)  # 1.5 a linear over (pt, p, p, C)
    s.linear("patch_embed.text_proj", dim, cfg["text_embed_dim"])
    s.linear("time_embedding.linear_1", te, dim)
    s.linear("time_embedding.linear_2", te, te)
    s.norm("norm_final", dim)
    s.linear("norm_out.linear", 2 * dim, te)
    s.norm("norm_out.norm", dim)
    s.linear("proj_out", (pt or 1) * p * p * cfg["out_channels"], dim)
    if ofs is not None:
        s.linear("ofs_embedding.linear_1", ofs, ofs)
        s.linear("ofs_embedding.linear_2", ofs, ofs)
    qkv_bias = cfg.get("attention_bias", True)
    for i in range(cfg["num_layers"]):
        b = f"transformer_blocks.{i}"
        for nm in ("norm1", "norm2"):
            s.linear(f"{b}.{nm}.linear", 6 * dim, te)
            s.norm(f"{b}.{nm}.norm", dim)
        for nm in ("to_q", "to_k", "to_v"):
            s.linear(f"{b}.attn1.{nm}", dim, dim, bias=qkv_bias)
        s.linear(f"{b}.attn1.to_out.0", dim, dim)
        s.norm(f"{b}.attn1.norm_q", hd)
        s.norm(f"{b}.attn1.norm_k", hd)
        s.linear(f"{b}.ff.net.0.proj", 4 * dim, dim)
        s.linear(f"{b}.ff.net.2", dim, 4 * dim)
    return s.items


def cogvideox_vae_spec(cfg: dict) -> Spec:
    s = _Spec()
    boc, z = cfg["block_out_channels"], cfg["latent_channels"]

    def conv3d(name, cin, cout, k=3):
        s.conv(f"{name}.conv", cin, cout, k, k, k)

    def resnet(name, cin, cout, spatial=False):
        conv3d(f"{name}.conv1", cin, cout)
        conv3d(f"{name}.conv2", cout, cout)
        if spatial:
            for nm, ch in (("norm1", cin), ("norm2", cout)):
                s.norm(f"{name}.{nm}.norm_layer", ch)
                conv3d(f"{name}.{nm}.conv_y", z, ch, k=1)
                conv3d(f"{name}.{nm}.conv_b", z, ch, k=1)
        else:
            s.norm(f"{name}.norm1", cin)
            s.norm(f"{name}.norm2", cout)
        if cin != cout:
            conv3d(f"{name}.conv_shortcut", cin, cout, k=1)

    conv3d("encoder.conv_in", 3, boc[0])
    ch = boc[0]
    for i, out in enumerate(boc):
        for j in range(cfg["layers_per_block"]):
            resnet(f"encoder.down_blocks.{i}.resnets.{j}", ch, out)
            ch = out
        if i < len(boc) - 1:
            s.conv(f"encoder.down_blocks.{i}.downsamplers.0.conv", out, out, 3, 3)
    for j in range(2):
        resnet(f"encoder.mid_block.resnets.{j}", ch, ch)
    s.norm("encoder.norm_out", ch)
    conv3d("encoder.conv_out", ch, 2 * z)

    rev = list(reversed(boc))
    conv3d("decoder.conv_in", z, rev[0])
    for j in range(2):
        resnet(f"decoder.mid_block.resnets.{j}", rev[0], rev[0], spatial=True)
    ch = rev[0]
    for i, out in enumerate(rev):
        for j in range(cfg["layers_per_block"] + 1):
            resnet(f"decoder.up_blocks.{i}.resnets.{j}", ch if j == 0 else out, out, spatial=True)
        ch = out
        if i < len(rev) - 1:
            s.conv(f"decoder.up_blocks.{i}.upsamplers.0.conv", out, out, 3, 3)
    s.norm("decoder.norm_out.norm_layer", ch)
    conv3d("decoder.norm_out.conv_y", z, ch, k=1)
    conv3d("decoder.norm_out.conv_b", z, ch, k=1)
    conv3d("decoder.conv_out", ch, 3)
    return s.items


def t5_spec(cfg: dict, per_layer_bias: bool = False) -> Spec:
    """T5 (one relative-bias table, in block 0) or UMT5 (one a block)."""
    s = _Spec()
    d, inner, heads = cfg["d_model"], cfg["num_heads"] * cfg["d_kv"], cfg["num_heads"]
    s.add("shared.weight", (cfg["vocab_size"], d), "e")
    for i in range(cfg["num_layers"]):
        b = f"encoder.block.{i}"
        for nm in ("q", "k", "v"):
            s.linear(f"{b}.layer.0.SelfAttention.{nm}", inner, d, bias=False)
        s.linear(f"{b}.layer.0.SelfAttention.o", d, inner, bias=False)
        if per_layer_bias or i == 0:
            s.add(f"{b}.layer.0.SelfAttention.relative_attention_bias.weight",
                  (cfg["relative_attention_num_buckets"], heads), "b")
        s.norm(f"{b}.layer.0.layer_norm", d, bias=False)
        s.linear(f"{b}.layer.1.DenseReluDense.wi_0", cfg["d_ff"], d, bias=False)
        s.linear(f"{b}.layer.1.DenseReluDense.wi_1", cfg["d_ff"], d, bias=False)
        s.linear(f"{b}.layer.1.DenseReluDense.wo", d, cfg["d_ff"], bias=False)
        s.norm(f"{b}.layer.1.layer_norm", d, bias=False)
    s.norm("encoder.final_layer_norm", d, bias=False)
    return s.items


# -- Wan --------------------------------------------------------------------------------


def wan_transformer_spec(cfg: dict) -> Spec:
    s = _Spec()
    dim = cfg["num_attention_heads"] * cfg["attention_head_dim"]
    pt, ph, pw = cfg["patch_size"]
    s.conv("patch_embedding", cfg["in_channels"], dim, pt, ph, pw)
    s.linear("condition_embedder.time_embedder.linear_1", dim, cfg["freq_dim"])
    s.linear("condition_embedder.time_embedder.linear_2", dim, dim)
    s.linear("condition_embedder.time_proj", 6 * dim, dim)
    s.linear("condition_embedder.text_embedder.linear_1", dim, cfg["text_dim"])
    s.linear("condition_embedder.text_embedder.linear_2", dim, dim)
    image_dim = cfg.get("image_dim")
    if image_dim is not None:
        s.norm("condition_embedder.image_embedder.norm1", image_dim)
        s.linear("condition_embedder.image_embedder.ff.net.0.proj", image_dim, image_dim)
        s.linear("condition_embedder.image_embedder.ff.net.2", dim, image_dim)
        s.norm("condition_embedder.image_embedder.norm2", dim)
    s.add("scale_shift_table", (1, 2, dim), "b")
    s.linear("proj_out", pt * ph * pw * cfg["out_channels"], dim)
    for i in range(cfg["num_layers"]):
        b = f"blocks.{i}"
        s.add(f"{b}.scale_shift_table", (1, 6, dim), "b")
        for an, added in (("attn1", False), ("attn2", image_dim is not None)):
            for nm in ("to_q", "to_k", "to_v", "to_out.0"):
                s.linear(f"{b}.{an}.{nm}", dim, dim)
            s.norm(f"{b}.{an}.norm_q", dim, bias=False)
            s.norm(f"{b}.{an}.norm_k", dim, bias=False)
            if added:
                s.linear(f"{b}.{an}.add_k_proj", dim, dim)
                s.linear(f"{b}.{an}.add_v_proj", dim, dim)
                s.norm(f"{b}.{an}.norm_added_k", dim, bias=False)
        s.norm(f"{b}.norm2", dim)
        s.linear(f"{b}.ffn.net.0.proj", cfg["ffn_dim"], dim)
        s.linear(f"{b}.ffn.net.2", dim, cfg["ffn_dim"])
    return s.items


def wan_vae_spec(cfg: dict) -> Spec:
    s = _Spec()
    dims = [cfg["base_dim"] * m for m in cfg["dim_mult"]]
    z = cfg["z_dim"]

    def gamma(name, ch):
        s.add(f"{name}.gamma", (ch, 1, 1), "1")

    def resnet(name, cin, cout):
        gamma(f"{name}.norm1", cin)
        s.conv(f"{name}.conv1", cin, cout, 3, 3, 3)
        gamma(f"{name}.norm2", cout)
        s.conv(f"{name}.conv2", cout, cout, 3, 3, 3)
        if cin != cout:
            s.conv(f"{name}.conv_shortcut", cin, cout, 1, 1, 1)

    def attention(name, ch):
        gamma(f"{name}.norm", ch)
        s.conv(f"{name}.to_qkv", ch, 3 * ch, 1, 1)
        s.conv(f"{name}.proj", ch, ch, 1, 1)

    def mid(prefix, ch):
        resnet(f"{prefix}.resnets.0", ch, ch)
        attention(f"{prefix}.attentions.0", ch)
        resnet(f"{prefix}.resnets.1", ch, ch)

    s.conv("encoder.conv_in", 3, dims[0], 3, 3, 3)
    idx, ch = 0, dims[0]
    for i, out in enumerate(dims):
        for _ in range(cfg["num_res_blocks"]):
            resnet(f"encoder.down_blocks.{idx}", ch, out)
            ch, idx = out, idx + 1
        if i < len(dims) - 1:
            s.conv(f"encoder.down_blocks.{idx}.resample.1", out, out, 3, 3)
            if cfg["temperal_downsample"][i]:
                s.conv(f"encoder.down_blocks.{idx}.time_conv", out, out, 3, 1, 1)
            idx += 1
    mid("encoder.mid_block", ch)
    gamma("encoder.norm_out", ch)
    s.conv("encoder.conv_out", ch, 2 * z, 3, 3, 3)
    s.conv("quant_conv", 2 * z, 2 * z, 1, 1, 1)
    s.conv("post_quant_conv", z, z, 1, 1, 1)
    rdims = list(reversed(dims))
    s.conv("decoder.conv_in", z, rdims[0], 3, 3, 3)
    mid("decoder.mid_block", rdims[0])
    idx, ch = 0, rdims[0]
    up_temporal = list(reversed(cfg["temperal_downsample"]))
    for i, out in enumerate(rdims):
        for j in range(cfg["num_res_blocks"] + 1):
            resnet(f"decoder.up_blocks.{idx}", ch if j == 0 else out, out)
            ch, idx = out, idx + 1
        if i < len(rdims) - 1:
            s.conv(f"decoder.up_blocks.{idx}.resample.1", out, out // 2, 3, 3)
            if up_temporal[i]:
                s.conv(f"decoder.up_blocks.{idx}.time_conv", out, out * 2, 3, 1, 1)
            ch, idx = out // 2, idx + 1
    gamma("decoder.norm_out", ch)
    s.conv("decoder.conv_out", ch, 3, 3, 3, 3)
    return s.items


def clip_vision_spec(cfg: dict, p: str = "vision_model") -> Spec:
    s = _Spec()
    d, inter = cfg["hidden_size"], cfg["intermediate_size"]
    n_pos = (cfg["image_size"] // cfg["patch_size"]) ** 2 + 1
    s.add(f"{p}.embeddings.class_embedding", (d,), "b")
    s.add(f"{p}.embeddings.patch_embedding.weight", (d, 3, cfg["patch_size"], cfg["patch_size"]))
    s.add(f"{p}.embeddings.position_embedding.weight", (n_pos, d), "b")
    s.norm(f"{p}.pre_layrnorm", d)  # [sic] the HF name
    s.norm(f"{p}.post_layernorm", d)
    for i in range(cfg["num_hidden_layers"]):
        b = f"{p}.encoder.layers.{i}"
        for nm in ("q_proj", "k_proj", "v_proj", "out_proj"):
            s.linear(f"{b}.self_attn.{nm}", d, d)
        s.norm(f"{b}.layer_norm1", d)
        s.norm(f"{b}.layer_norm2", d)
        s.linear(f"{b}.mlp.fc1", inter, d)
        s.linear(f"{b}.mlp.fc2", d, inter)
    return s.items


# -- HunyuanVideo ------------------------------------------------------------------------


def hunyuan_transformer_spec(cfg: dict) -> Spec:
    s = _Spec()
    dim, hd = cfg["num_attention_heads"] * cfg["attention_head_dim"], cfg["attention_head_dim"]
    mlp, p, pt = int(dim * cfg["mlp_ratio"]), cfg["patch_size"], cfg["patch_size_t"]
    s.conv("x_embedder.proj", cfg["in_channels"], dim, pt, p, p)
    s.linear("context_embedder.proj_in", dim, cfg["text_embed_dim"])
    s.linear("context_embedder.time_text_embed.timestep_embedder.linear_1", dim, 256)
    s.linear("context_embedder.time_text_embed.timestep_embedder.linear_2", dim, dim)
    s.linear("context_embedder.time_text_embed.text_embedder.linear_1", dim, cfg["text_embed_dim"])
    s.linear("context_embedder.time_text_embed.text_embedder.linear_2", dim, dim)
    for i in range(cfg["num_refiner_layers"]):
        b = f"context_embedder.token_refiner.refiner_blocks.{i}"
        s.norm(f"{b}.norm1", dim)
        s.norm(f"{b}.norm2", dim)
        for nm in ("to_q", "to_k", "to_v", "to_out.0"):
            s.linear(f"{b}.attn.{nm}", dim, dim)
        s.linear(f"{b}.ff.net.0.proj", mlp, dim)
        s.linear(f"{b}.ff.net.2", dim, mlp)
        s.linear(f"{b}.norm_out.linear", 2 * dim, dim)
    s.linear("time_text_embed.timestep_embedder.linear_1", dim, 256)
    s.linear("time_text_embed.timestep_embedder.linear_2", dim, dim)
    if cfg.get("guidance_embeds", True):
        s.linear("time_text_embed.guidance_embedder.linear_1", dim, 256)
        s.linear("time_text_embed.guidance_embedder.linear_2", dim, dim)
    s.linear("time_text_embed.text_embedder.linear_1", dim, cfg["pooled_projection_dim"])
    s.linear("time_text_embed.text_embedder.linear_2", dim, dim)
    for i in range(cfg["num_layers"]):  # double-stream blocks: the image and the text stream
        b = f"transformer_blocks.{i}"
        s.linear(f"{b}.norm1.linear", 6 * dim, dim)
        s.linear(f"{b}.norm1_context.linear", 6 * dim, dim)
        for nm in ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj", "add_v_proj", "to_out.0", "to_add_out"):
            s.linear(f"{b}.attn.{nm}", dim, dim)
        for nm in ("norm_q", "norm_k", "norm_added_q", "norm_added_k"):
            s.norm(f"{b}.attn.{nm}", hd, bias=False)
        for ff in ("ff", "ff_context"):
            s.linear(f"{b}.{ff}.net.0.proj", mlp, dim)
            s.linear(f"{b}.{ff}.net.2", dim, mlp)
    for i in range(cfg["num_single_layers"]):  # single-stream blocks: q/k/v beside the MLP's input
        b = f"single_transformer_blocks.{i}"
        s.linear(f"{b}.norm.linear", 3 * dim, dim)
        for nm in ("to_q", "to_k", "to_v"):
            s.linear(f"{b}.attn.{nm}", dim, dim)
        s.norm(f"{b}.attn.norm_q", hd, bias=False)
        s.norm(f"{b}.attn.norm_k", hd, bias=False)
        s.linear(f"{b}.proj_mlp", mlp, dim)
        s.linear(f"{b}.proj_out", dim, dim + mlp)
    s.linear("norm_out.linear", 2 * dim, dim)
    s.linear("proj_out", pt * p * p * cfg["out_channels"], dim)
    return s.items


def hunyuan_vae_spec(cfg: dict) -> Spec:
    s = _Spec()
    boc, z, n = cfg["block_out_channels"], cfg["latent_channels"], cfg["layers_per_block"]

    def conv3d(name, cin, cout, k=3):
        s.conv(name, cin, cout, k, k, k)

    def resnet(name, cin, cout):
        s.norm(f"{name}.norm1", cin)
        conv3d(f"{name}.conv1", cin, cout)
        s.norm(f"{name}.norm2", cout)
        conv3d(f"{name}.conv2", cout, cout)
        if cin != cout:
            conv3d(f"{name}.conv_shortcut", cin, cout, k=1)

    def mid(prefix, ch):
        resnet(f"{prefix}.resnets.0", ch, ch)
        a = f"{prefix}.attentions.0"
        s.norm(f"{a}.group_norm", ch)
        for nm in ("to_q", "to_k", "to_v", "to_out.0"):
            s.linear(f"{a}.{nm}", ch, ch)
        resnet(f"{prefix}.resnets.1", ch, ch)

    conv3d("encoder.conv_in", 3, boc[0])
    ch = boc[0]
    for i, out in enumerate(boc):
        for j in range(n):
            resnet(f"encoder.down_blocks.{i}.resnets.{j}", ch if j == 0 else out, out)
        ch = out
        if i < len(boc) - 1:
            conv3d(f"encoder.down_blocks.{i}.downsamplers.0.conv", out, out)
    mid("encoder.mid_block", ch)
    s.norm("encoder.conv_norm_out", ch)
    conv3d("encoder.conv_out", ch, 2 * z)
    conv3d("quant_conv", 2 * z, 2 * z, k=1)
    conv3d("post_quant_conv", z, z, k=1)
    rev = list(reversed(boc))
    conv3d("decoder.conv_in", z, rev[0])
    mid("decoder.mid_block", rev[0])
    ch = rev[0]
    for i, out in enumerate(rev):
        for j in range(n + 1):
            resnet(f"decoder.up_blocks.{i}.resnets.{j}", ch if j == 0 else out, out)
        ch = out
        if i < len(rev) - 1:
            conv3d(f"decoder.up_blocks.{i}.upsamplers.0.conv", out, out)
    s.norm("decoder.conv_norm_out", ch)
    conv3d("decoder.conv_out", ch, 3)
    return s.items


def llava_spec(cfg: dict) -> Spec:
    """transformers ``LlavaForConditionalGeneration`` in the legacy layout:
    the Llama decoder (no biases), the CLIP vision tower, the projector."""
    s = _Spec()
    t, v = cfg["text_config"], cfg["vision_config"]
    d, inter = t["hidden_size"], t["intermediate_size"]
    kv = t["num_key_value_heads"] * (d // t["num_attention_heads"])
    lm = "language_model.model"
    s.add(f"{lm}.embed_tokens.weight", (t["vocab_size"], d), "e")
    for i in range(t["num_hidden_layers"]):
        b = f"{lm}.layers.{i}"
        s.norm(f"{b}.input_layernorm", d, bias=False)
        s.norm(f"{b}.post_attention_layernorm", d, bias=False)
        for nm, n_out in (("q_proj", d), ("k_proj", kv), ("v_proj", kv), ("o_proj", d)):
            s.linear(f"{b}.self_attn.{nm}", n_out, d, bias=False)
        s.linear(f"{b}.mlp.gate_proj", inter, d, bias=False)
        s.linear(f"{b}.mlp.up_proj", inter, d, bias=False)
        s.linear(f"{b}.mlp.down_proj", d, inter, bias=False)
    s.norm(f"{lm}.norm", d, bias=False)
    s.items += clip_vision_spec(v, "vision_tower.vision_model")
    s.linear("multi_modal_projector.linear_1", d, v["hidden_size"])
    s.linear("multi_modal_projector.linear_2", d, d)
    return s.items


def clip_text_spec(cfg: dict) -> Spec:
    s = _Spec()
    p, d, inter = "text_model", cfg["hidden_size"], cfg["intermediate_size"]
    s.add(f"{p}.embeddings.token_embedding.weight", (cfg["vocab_size"], d), "e")
    s.add(f"{p}.embeddings.position_embedding.weight", (cfg["max_position_embeddings"], d), "b")
    s.norm(f"{p}.final_layer_norm", d)
    for i in range(cfg["num_hidden_layers"]):
        b = f"{p}.encoder.layers.{i}"
        for nm in ("q_proj", "k_proj", "v_proj", "out_proj"):
            s.linear(f"{b}.self_attn.{nm}", d, d)
        s.norm(f"{b}.layer_norm1", d)
        s.norm(f"{b}.layer_norm2", d)
        s.linear(f"{b}.mlp.fc1", inter, d)
        s.linear(f"{b}.mlp.fc2", d, inter)
    return s.items


# -- writing --------------------------------------------------------------------------------


def _draw(shape, kind: str, gen: torch.Generator, device) -> torch.Tensor:
    if kind == "1":
        return torch.ones(shape, device=device)
    if kind == "0":
        return torch.zeros(shape, device=device)
    std = {"b": 0.02, "e": 1.0}.get(kind) or math.prod(shape[1:]) ** -0.5
    return torch.randn(shape, generator=gen, device=device) * std


def write_shard(root: str, sub: str, fname: str, cfg: dict, spec: Spec, gen: torch.Generator, device,
                dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """``root/sub/config.json`` and ``root/sub/fname`` with ``spec``'s
    tensors drawn from ``gen``; returns them (on ``device``, in ``dtype``)."""
    os.makedirs(os.path.join(root, sub), exist_ok=True)
    with open(os.path.join(root, sub, "config.json"), "w") as f:
        json.dump(cfg, f)
    tensors = {name: _draw(shape, kind, gen, device).to(dtype) for name, shape, kind in spec}
    save_safetensors(tensors, os.path.join(root, sub, fname))
    return tensors


def write_tokenizer(root: str, vocab_size: int, max_length: int = 16, image_token_id: int = 60,
                    sub: str = "tokenizer") -> None:
    """``root/sub``: a WordLevel vocabulary of ``vocab_size`` words with a
    Whitespace pre-tokenizer, as the ``tokenizers`` package writes it:
    ``<pad>`` 0, ``</s>`` 1, ``<unk>`` 2, ten common words of prompts from 3,
    an added special ``<image>`` at ``image_token_id`` when the vocabulary
    has one (Llava's ``image_token_index``), ``tok<i>`` elsewhere."""
    words = {"<pad>": 0, "</s>": 1, "<unk>": 2}
    common = ["a", "red", "double", "decker", "bus", "driving", "down", "street", "the", "panda"]
    for i in range(3, vocab_size):
        j = i - 3
        words["<image>" if i == image_token_id else common[j] if j < len(common) else f"tok{i}"] = i
    added = [{"id": image_token_id, "content": "<image>", "single_word": False, "lstrip": False, "rstrip": False,
              "normalized": False, "special": True}] if vocab_size > image_token_id else []
    data = {"version": "1.0", "truncation": None, "padding": None, "added_tokens": added, "normalizer": None,
            "pre_tokenizer": {"type": "Whitespace"}, "post_processor": None, "decoder": None,
            "model": {"type": "WordLevel", "vocab": words, "unk_token": "<unk>"}}
    tok_dir = os.path.join(root, sub)
    os.makedirs(tok_dir, exist_ok=True)
    with open(os.path.join(tok_dir, "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump(data, f, ensure_ascii=False)
    with open(os.path.join(tok_dir, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "PreTrainedTokenizerFast", "pad_token": "<pad>", "eos_token": "</s>",
                   "unk_token": "<unk>", "model_max_length": max_length}, f)


def write_cogvideox(root: str, config: dict = None, seed: int = 0, device="cpu", dtype=torch.bfloat16,
                    scheduler_class: str = "CogVideoXDDIMScheduler") -> Dict[str, Dict[str, torch.Tensor]]:
    """A CogVideoX-I2V checkpoint (1.0, or 1.5 when the transformer config
    sets ``patch_size_t``) at ``config``'s widths and depths
    (:data:`TINY_COGVIDEOX` when None) under ``root``; returns the tensors
    drawn, ``{subdirectory: {name: tensor}}``. ``scheduler_class``: the
    scheduler config's ``_class_name`` (``"CogVideoXDPMScheduler"`` for the
    DPM checkpoints); ``config["scheduler"]``, when present, overrides
    fields of :data:`COGVIDEOX_SCHEDULER`."""
    cfg = copy.deepcopy(config or TINY_COGVIDEOX)
    gen = torch.Generator(device).manual_seed(seed)
    out = {
        "transformer": write_shard(root, "transformer", "diffusion_pytorch_model.safetensors", cfg["transformer"],
                                   cogvideox_transformer_spec(cfg["transformer"]), gen, device, dtype),
        "vae": write_shard(root, "vae", "diffusion_pytorch_model.safetensors", cfg["vae"],
                           cogvideox_vae_spec(cfg["vae"]), gen, device, dtype),
        "text_encoder": write_shard(root, "text_encoder", "model.safetensors", cfg["text_encoder"],
                                    t5_spec(cfg["text_encoder"]), gen, device, dtype),
    }
    write_tokenizer(root, cfg["text_encoder"]["vocab_size"], cfg["transformer"]["max_text_seq_length"])
    os.makedirs(os.path.join(root, "scheduler"), exist_ok=True)
    with open(os.path.join(root, "scheduler", "scheduler_config.json"), "w") as f:
        json.dump({**COGVIDEOX_SCHEDULER, **cfg.get("scheduler", {}), "_class_name": scheduler_class}, f)
    return out


def write_wan(root: str, config: dict = None, seed: int = 0, device="cpu",
              dtype=torch.bfloat16) -> Dict[str, Dict[str, torch.Tensor]]:
    """A Wan2.1-I2V checkpoint at ``config``'s widths and depths
    (:data:`TINY_WAN` when None) under ``root``; returns the tensors drawn."""
    cfg = copy.deepcopy(config or TINY_WAN)
    gen = torch.Generator(device).manual_seed(seed)
    out = {
        "transformer": write_shard(root, "transformer", "diffusion_pytorch_model.safetensors", cfg["transformer"],
                                   wan_transformer_spec(cfg["transformer"]), gen, device, dtype),
        "vae": write_shard(root, "vae", "diffusion_pytorch_model.safetensors", cfg["vae"],
                           wan_vae_spec(cfg["vae"]), gen, device, dtype),
        "text_encoder": write_shard(root, "text_encoder", "model.safetensors", cfg["text_encoder"],
                                    t5_spec(cfg["text_encoder"], per_layer_bias=True), gen, device, dtype),
        "image_encoder": write_shard(root, "image_encoder", "model.safetensors", cfg["image_encoder"],
                                     clip_vision_spec(cfg["image_encoder"]), gen, device, dtype),
    }
    write_tokenizer(root, cfg["text_encoder"]["vocab_size"])
    return out


def write_hunyuan(root: str, config: dict = None, seed: int = 0, device="cpu",
                  dtype=torch.bfloat16) -> Dict[str, Dict[str, torch.Tensor]]:
    """A HunyuanVideo-I2V checkpoint at ``config``'s widths and depths
    (:data:`TINY_HUNYUAN` when None) under ``root``: the subdirectories
    :func:`alg_tpu_torch.io.model_zoo.load_hunyuan_pipeline` reads, with the
    Llava tokenizer's ``<image>`` at the config's ``image_token_index`` and a
    CLIP tokenizer in ``tokenizer_2``; returns the tensors drawn."""
    cfg = copy.deepcopy(config or TINY_HUNYUAN)
    gen = torch.Generator(device).manual_seed(seed)
    out = {
        "transformer": write_shard(root, "transformer", "diffusion_pytorch_model.safetensors", cfg["transformer"],
                                   hunyuan_transformer_spec(cfg["transformer"]), gen, device, dtype),
        "vae": write_shard(root, "vae", "diffusion_pytorch_model.safetensors", cfg["vae"],
                           hunyuan_vae_spec(cfg["vae"]), gen, device, dtype),
        "text_encoder": write_shard(root, "text_encoder", "model.safetensors", cfg["text_encoder"],
                                    llava_spec(cfg["text_encoder"]), gen, device, dtype),
        "text_encoder_2": write_shard(root, "text_encoder_2", "model.safetensors", cfg["text_encoder_2"],
                                      clip_text_spec(cfg["text_encoder_2"]), gen, device, dtype),
    }
    image_token, clip_len = cfg["text_encoder"]["image_token_index"], cfg["text_encoder_2"]["max_position_embeddings"]
    write_tokenizer(root, cfg["text_encoder"]["text_config"]["vocab_size"], clip_len, image_token)
    write_tokenizer(root, cfg["text_encoder_2"]["vocab_size"], clip_len, image_token, sub="tokenizer_2")
    return out
