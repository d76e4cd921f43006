"""HF checkpoint -> the port's modules (counterpart of ``alg_tpu/io/weights.py``).

Each converter maps a diffusers / transformers state dict (names to tensors,
as :func:`alg_tpu_torch.io.safetensors.load_safetensors_dir` returns them)
onto a nested dict laid out as ``alg_tpu``'s parameter tree for the same
model, with one difference: the leaves are the checkpoint's tensors in
torch layout, so nothing is transposed. An HF linear ``[out, in]``, a conv
``[out, in, (t,) h, w]`` and a norm's ``weight`` are already what the port's
modules hold; only a few tensors are reshaped (the CogVideoX 1.0 conv2d
patch embed flattened in ``(c, p, p)`` order (1.5's is a linear already), the Wan and HunyuanVideo conv3d
patch embeds, Wan's ``scale_shift_table`` rows and its VAE's ``gamma`` and
1x1 attention convs). Block stacks stay lists, one entry a layer.

:func:`load_tree` names each leaf by the rules of
:mod:`alg_tpu_torch.io.jax_params` (``kernel`` and ``scale`` become
``weight``, a list entry ``<name>.<i>``) and copies it into the module,
casting to the parameter's dtype and device. Missing or unused names and
shape mismatches raise, as :func:`~alg_tpu_torch.io.jax_params.load_jax_params`
does. A converter's missing checkpoint key raises ``KeyError``.
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, Tuple

import torch
from torch import nn

from alg_tpu_torch.io.jax_params import copy_state_, leaf_name


def flatten_tree(tree, prefix: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    """(state-dict name, tensor) for every leaf of a converter's tree."""
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from flatten_tree(val, f"{prefix}{key}.")
        elif isinstance(val, (list, tuple)):
            for i, item in enumerate(val):
                yield from flatten_tree(item, f"{prefix}{key}.{i}.")
        else:
            yield leaf_name(prefix, key), val


def load_tree(module: nn.Module, tree) -> nn.Module:
    """Copy a converter's tree into ``module`` (strict: every parameter
    once, every leaf used, shapes equal)."""
    return copy_state_(module, dict(flatten_tree(tree)))


def linear(state: Mapping, prefix: str) -> Dict:
    p = {"kernel": state[f"{prefix}.weight"]}
    if f"{prefix}.bias" in state:
        p["bias"] = state[f"{prefix}.bias"]
    return p


def norm(state: Mapping, prefix: str) -> Dict:
    p = {"scale": state[f"{prefix}.weight"]}
    if f"{prefix}.bias" in state:
        p["bias"] = state[f"{prefix}.bias"]
    return p


conv3d = conv2d = linear  # torch keeps a conv as [out, in, (t,) h, w]: its name map is a linear's


def _flat_kernel(state: Mapping, key: str):
    """A patch-embed conv ``[dim, C, (pt,) p, p]`` as the linear over its
    patch, ``[dim, C·(pt·)p·p]``: the ``(c, (t,) h, w)`` flatten order of the
    DiTs' patchify (a linear's ``[dim, n]`` stays as it is)."""
    w = state[key]
    return w.reshape(w.shape[0], -1)


# ---------------------------------------------------------------------------
# per-model converters
# ---------------------------------------------------------------------------


def convert_t5_encoder(state: Mapping, cfg) -> Dict:
    """transformers ``T5EncoderModel`` / ``UMT5EncoderModel`` state dict."""
    blocks = []
    for i in range(cfg.num_layers):
        b = f"encoder.block.{i}"
        attn = {nm: linear(state, f"{b}.layer.0.SelfAttention.{nm}") for nm in ("q", "k", "v", "o")}
        rb = f"{b}.layer.0.SelfAttention.relative_attention_bias.weight"
        if rb in state:
            attn["relative_attention_bias"] = state[rb]
        blocks.append({
            "attn_norm": norm(state, f"{b}.layer.0.layer_norm"),
            "attn": attn,
            "ff_norm": norm(state, f"{b}.layer.1.layer_norm"),
            "wi_0": linear(state, f"{b}.layer.1.DenseReluDense.wi_0"),
            "wi_1": linear(state, f"{b}.layer.1.DenseReluDense.wi_1"),
            "wo": linear(state, f"{b}.layer.1.DenseReluDense.wo"),
        })
    return {"embed": state["shared.weight"], "blocks": blocks,
            "final_norm": norm(state, "encoder.final_layer_norm")}


def _convert_clip_layers(state: Mapping, prefix: str, n_layers: int) -> list:
    layers = []
    for i in range(n_layers):
        b = f"{prefix}.encoder.layers.{i}"
        layers.append({
            "layer_norm1": norm(state, f"{b}.layer_norm1"),
            "attn": {"q": linear(state, f"{b}.self_attn.q_proj"), "k": linear(state, f"{b}.self_attn.k_proj"),
                     "v": linear(state, f"{b}.self_attn.v_proj"), "out": linear(state, f"{b}.self_attn.out_proj")},
            "layer_norm2": norm(state, f"{b}.layer_norm2"),
            "mlp": {"fc1": linear(state, f"{b}.mlp.fc1"), "fc2": linear(state, f"{b}.mlp.fc2")},
        })
    return layers


def convert_clip_vision(state: Mapping, cfg) -> Dict:
    """transformers ``CLIPVisionModel`` state dict."""
    p = "vision_model"
    return {
        "class_embedding": state[f"{p}.embeddings.class_embedding"],
        "patch_embedding": {"kernel": state[f"{p}.embeddings.patch_embedding.weight"]},
        "position_embedding": state[f"{p}.embeddings.position_embedding.weight"],
        "pre_layrnorm": norm(state, f"{p}.pre_layrnorm"),  # [sic] HF name
        "layers": _convert_clip_layers(state, p, cfg.num_hidden_layers),
        "post_layernorm": norm(state, f"{p}.post_layernorm"),
    }


def convert_clip_text(state: Mapping, cfg) -> Dict:
    """transformers ``CLIPTextModel`` state dict."""
    p = "text_model"
    return {
        "token_embedding": state[f"{p}.embeddings.token_embedding.weight"],
        "position_embedding": state[f"{p}.embeddings.position_embedding.weight"],
        "layers": _convert_clip_layers(state, p, cfg.num_hidden_layers),
        "final_layer_norm": norm(state, f"{p}.final_layer_norm"),
    }


def convert_llama(state: Mapping, cfg, prefix: str = "model") -> Dict:
    """transformers ``LlamaModel`` state dict (decoder weights only)."""
    dot = f"{prefix}." if prefix else ""
    blocks = []
    for i in range(cfg.num_hidden_layers):
        b = f"{dot}layers.{i}"
        blocks.append({
            "input_norm": norm(state, f"{b}.input_layernorm"),
            "q": linear(state, f"{b}.self_attn.q_proj"),
            "k": linear(state, f"{b}.self_attn.k_proj"),
            "v": linear(state, f"{b}.self_attn.v_proj"),
            "o": linear(state, f"{b}.self_attn.o_proj"),
            "post_norm": norm(state, f"{b}.post_attention_layernorm"),
            "gate": linear(state, f"{b}.mlp.gate_proj"),
            "up": linear(state, f"{b}.mlp.up_proj"),
            "down": linear(state, f"{b}.mlp.down_proj"),
        })
    return {"embed": state[f"{dot}embed_tokens.weight"], "blocks": blocks,
            "final_norm": norm(state, f"{dot}norm")}


def convert_llava(state: Mapping, cfg) -> Dict:
    """transformers ``LlavaForConditionalGeneration`` state dict, in the
    legacy (``language_model.model.*``) or the new
    (``model.language_model.*``) layout."""
    if any(k.startswith("language_model.model.") for k in state):
        lm_prefix, vt_prefix, mp_prefix = "language_model.model", "vision_tower", "multi_modal_projector"
    else:
        lm_prefix, vt_prefix, mp_prefix = "model.language_model", "model.vision_tower", "model.multi_modal_projector"
    vt_state = {k[len(vt_prefix) + 1:]: v for k, v in state.items() if k.startswith(vt_prefix + ".")}
    return {
        "language_model": convert_llama(state, cfg.text, prefix=lm_prefix),
        "vision_tower": convert_clip_vision(vt_state, cfg.vision),
        "projector": {"linear_1": linear(state, f"{mp_prefix}.linear_1"),
                      "linear_2": linear(state, f"{mp_prefix}.linear_2")},
    }


def convert_cogvideox_transformer(state: Mapping, cfg) -> Dict:
    """diffusers ``CogVideoXTransformer3DModel`` state dict: 1.0's conv2d
    patch embed flattened to the linear over ``(c, p, p)``, 1.5's linear over
    ``(pt, p, p, c)`` as it is, 1.5's ``ofs_embedding`` where the checkpoint
    has one; q/k/v without biases where the checkpoint has none
    (``attention_bias`` false)."""

    def block(i):
        b = f"transformer_blocks.{i}"
        return {
            "norm1": {"linear": linear(state, f"{b}.norm1.linear"), "norm": norm(state, f"{b}.norm1.norm")},
            "attn": {
                "to_q": linear(state, f"{b}.attn1.to_q"),
                "to_k": linear(state, f"{b}.attn1.to_k"),
                "to_v": linear(state, f"{b}.attn1.to_v"),
                "to_out": linear(state, f"{b}.attn1.to_out.0"),
                "norm_q": norm(state, f"{b}.attn1.norm_q"),
                "norm_k": norm(state, f"{b}.attn1.norm_k"),
            },
            "norm2": {"linear": linear(state, f"{b}.norm2.linear"), "norm": norm(state, f"{b}.norm2.norm")},
            "ff": {"fc_in": linear(state, f"{b}.ff.net.0.proj"), "fc_out": linear(state, f"{b}.ff.net.2")},
        }

    tree = {
        "patch_embed": {
            "proj": {"kernel": _flat_kernel(state, "patch_embed.proj.weight"), "bias": state["patch_embed.proj.bias"]},
            "text_proj": linear(state, "patch_embed.text_proj"),
        },
        "time_embedding": {"linear_1": linear(state, "time_embedding.linear_1"),
                           "linear_2": linear(state, "time_embedding.linear_2")},
        "blocks": [block(i) for i in range(cfg.num_layers)],
        "norm_final": norm(state, "norm_final"),
        "norm_out": {"linear": linear(state, "norm_out.linear"), "norm": norm(state, "norm_out.norm")},
        "proj_out": linear(state, "proj_out"),
    }
    if "ofs_embedding.linear_1.weight" in state:
        tree["ofs_embedding"] = {"linear_1": linear(state, "ofs_embedding.linear_1"),
                                 "linear_2": linear(state, "ofs_embedding.linear_2")}
    return tree


def convert_wan_transformer(state: Mapping, cfg) -> Dict:
    """diffusers ``WanTransformer3DModel`` state dict."""
    ce = {
        "time_embedder": {"linear_1": linear(state, "condition_embedder.time_embedder.linear_1"),
                          "linear_2": linear(state, "condition_embedder.time_embedder.linear_2")},
        "time_proj": linear(state, "condition_embedder.time_proj"),
        "text_embedder": {"linear_1": linear(state, "condition_embedder.text_embedder.linear_1"),
                          "linear_2": linear(state, "condition_embedder.text_embedder.linear_2")},
    }
    if "condition_embedder.image_embedder.norm1.weight" in state:
        ce["image_embedder"] = {
            "norm1": norm(state, "condition_embedder.image_embedder.norm1"),
            "ff_in": linear(state, "condition_embedder.image_embedder.ff.net.0.proj"),
            "ff_out": linear(state, "condition_embedder.image_embedder.ff.net.2"),
            "norm2": norm(state, "condition_embedder.image_embedder.norm2"),
        }

    def attn(prefix, with_added):
        p = {
            "to_q": linear(state, f"{prefix}.to_q"),
            "to_k": linear(state, f"{prefix}.to_k"),
            "to_v": linear(state, f"{prefix}.to_v"),
            "to_out": linear(state, f"{prefix}.to_out.0"),
            "norm_q": norm(state, f"{prefix}.norm_q"),
            "norm_k": norm(state, f"{prefix}.norm_k"),
        }
        if with_added:
            p["add_k_proj"] = linear(state, f"{prefix}.add_k_proj")
            p["add_v_proj"] = linear(state, f"{prefix}.add_v_proj")
            p["norm_added_k"] = norm(state, f"{prefix}.norm_added_k")
        return p

    blocks = []
    for i in range(cfg.num_layers):
        b = f"blocks.{i}"
        blocks.append({
            "scale_shift_table": state[f"{b}.scale_shift_table"].reshape(6, -1),
            "attn1": attn(f"{b}.attn1", False),
            "attn2": attn(f"{b}.attn2", cfg.image_dim is not None),
            "norm2": norm(state, f"{b}.norm2"),
            "ffn": {"fc_in": linear(state, f"{b}.ffn.net.0.proj"), "fc_out": linear(state, f"{b}.ffn.net.2")},
        })
    return {
        "patch_embedding": {"kernel": _flat_kernel(state, "patch_embedding.weight"),
                            "bias": state["patch_embedding.bias"]},
        "condition_embedder": ce,
        "blocks": blocks,
        "scale_shift_table": state["scale_shift_table"].reshape(2, -1),
        "proj_out": linear(state, "proj_out"),
    }


def convert_hunyuan_transformer(state: Mapping, cfg) -> Dict:
    """diffusers ``HunyuanVideoTransformer3DModel`` state dict."""
    refiner = "context_embedder.token_refiner.refiner_blocks"
    params = {
        "x_embedder": {"kernel": _flat_kernel(state, "x_embedder.proj.weight"), "bias": state["x_embedder.proj.bias"]},
        "context_embedder": {
            "input_embedder": linear(state, "context_embedder.proj_in"),
            "t_embedder": {
                "linear_1": linear(state, "context_embedder.time_text_embed.timestep_embedder.linear_1"),
                "linear_2": linear(state, "context_embedder.time_text_embed.timestep_embedder.linear_2"),
            },
            "c_embedder": {
                "linear_1": linear(state, "context_embedder.time_text_embed.text_embedder.linear_1"),
                "linear_2": linear(state, "context_embedder.time_text_embed.text_embedder.linear_2"),
            },
            "blocks": [
                {
                    "norm1": norm(state, f"{refiner}.{i}.norm1"),
                    "attn": {
                        "to_q": linear(state, f"{refiner}.{i}.attn.to_q"),
                        "to_k": linear(state, f"{refiner}.{i}.attn.to_k"),
                        "to_v": linear(state, f"{refiner}.{i}.attn.to_v"),
                        "to_out": linear(state, f"{refiner}.{i}.attn.to_out.0"),
                    },
                    "norm2": norm(state, f"{refiner}.{i}.norm2"),
                    "ff": {"fc_in": linear(state, f"{refiner}.{i}.ff.net.0.proj"),
                           "fc_out": linear(state, f"{refiner}.{i}.ff.net.2")},
                    "ada": linear(state, f"{refiner}.{i}.norm_out.linear"),
                }
                for i in range(cfg.num_refiner_layers)
            ],
        },
        "time_text_embed": {
            "timestep_embedder": {"linear_1": linear(state, "time_text_embed.timestep_embedder.linear_1"),
                                  "linear_2": linear(state, "time_text_embed.timestep_embedder.linear_2")},
            "text_embedder": {"linear_1": linear(state, "time_text_embed.text_embedder.linear_1"),
                              "linear_2": linear(state, "time_text_embed.text_embedder.linear_2")},
        },
        "norm_out": {"linear": linear(state, "norm_out.linear")},
        "proj_out": linear(state, "proj_out"),
    }
    if "time_text_embed.guidance_embedder.linear_1.weight" in state:
        params["time_text_embed"]["guidance_embedder"] = {
            "linear_1": linear(state, "time_text_embed.guidance_embedder.linear_1"),
            "linear_2": linear(state, "time_text_embed.guidance_embedder.linear_2"),
        }

    def double(i):  # image and text streams: q/k/v and add_q/k/v, each with its RMS norm
        b = f"transformer_blocks.{i}"
        return {
            "norm1_linear": linear(state, f"{b}.norm1.linear"),
            "norm1_context_linear": linear(state, f"{b}.norm1_context.linear"),
            "attn": {
                **{nm: linear(state, f"{b}.attn.{nm}") for nm in
                   ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj", "add_v_proj", "to_add_out")},
                "to_out": linear(state, f"{b}.attn.to_out.0"),
                **{nm: norm(state, f"{b}.attn.{nm}") for nm in
                   ("norm_q", "norm_k", "norm_added_q", "norm_added_k")},
            },
            "ff": {"fc_in": linear(state, f"{b}.ff.net.0.proj"), "fc_out": linear(state, f"{b}.ff.net.2")},
            "ff_context": {"fc_in": linear(state, f"{b}.ff_context.net.0.proj"),
                           "fc_out": linear(state, f"{b}.ff_context.net.2")},
        }

    def single(i):  # one stream: q/k/v beside the MLP's input, one output projection over both
        b = f"single_transformer_blocks.{i}"
        return {
            "norm_linear": linear(state, f"{b}.norm.linear"),
            "attn": {"to_q": linear(state, f"{b}.attn.to_q"), "to_k": linear(state, f"{b}.attn.to_k"),
                     "to_v": linear(state, f"{b}.attn.to_v"), "norm_q": norm(state, f"{b}.attn.norm_q"),
                     "norm_k": norm(state, f"{b}.attn.norm_k")},
            "proj_mlp": linear(state, f"{b}.proj_mlp"),
            "proj_out": linear(state, f"{b}.proj_out"),
        }

    params["transformer_blocks"] = [double(i) for i in range(cfg.num_layers)]
    params["single_transformer_blocks"] = [single(i) for i in range(cfg.num_single_layers)]
    return params


def _gamma(state: Mapping, key: str) -> Dict:
    """The Wan VAE's channel RMS norm: its ``gamma`` is stored ``[C, 1, 1(, 1)]``."""
    return {"gamma": state[key].reshape(-1)}


def convert_wan_vae(state: Mapping, cfg) -> Dict:
    """diffusers ``AutoencoderKLWan`` state dict (flat down/up block lists:
    resnets interleaved with resamples)."""

    def resnet(prefix):
        p = {"norm1": _gamma(state, f"{prefix}.norm1.gamma"), "conv1": conv3d(state, f"{prefix}.conv1"),
             "norm2": _gamma(state, f"{prefix}.norm2.gamma"), "conv2": conv3d(state, f"{prefix}.conv2")}
        if f"{prefix}.conv_shortcut.weight" in state:
            p["conv_shortcut"] = conv3d(state, f"{prefix}.conv_shortcut")
        return p

    def attention(prefix):
        def conv1x1_as_3d(name):  # a 2D 1x1 conv [out, in, 1, 1] as the 3D one the port holds
            w = state[f"{prefix}.{name}.weight"]
            return {"kernel": w.reshape(w.shape[0], w.shape[1], 1, 1, 1), "bias": state[f"{prefix}.{name}.bias"]}

        return {"norm": _gamma(state, f"{prefix}.norm.gamma"), "to_qkv": conv1x1_as_3d("to_qkv"),
                "proj": conv1x1_as_3d("proj")}

    def mid(prefix):
        return {"resnet1": resnet(f"{prefix}.resnets.0"), "attn": attention(f"{prefix}.attentions.0"),
                "resnet2": resnet(f"{prefix}.resnets.1")}

    def resample(pre):
        r = {"conv": conv2d(state, f"{pre}.resample.1")}
        if f"{pre}.time_conv.weight" in state:
            r["time_conv"] = conv3d(state, f"{pre}.time_conv")
        return r

    n_stages = len(cfg.dim_mult)
    enc = {"conv_in": conv3d(state, "encoder.conv_in"), "down": []}
    idx = 0
    for i in range(n_stages):
        blk = {"resnets": []}
        for _ in range(cfg.num_res_blocks):
            blk["resnets"].append(resnet(f"encoder.down_blocks.{idx}"))
            idx += 1
        if i < n_stages - 1:
            blk["downsample"] = resample(f"encoder.down_blocks.{idx}")
            idx += 1
        enc["down"].append(blk)
    enc["mid"] = mid("encoder.mid_block")
    enc["norm_out"] = _gamma(state, "encoder.norm_out.gamma")
    enc["conv_out"] = conv3d(state, "encoder.conv_out")

    dec = {"conv_in": conv3d(state, "decoder.conv_in"), "mid": mid("decoder.mid_block"), "up": []}
    idx = 0
    for i in range(n_stages):
        blk = {"resnets": []}
        for _ in range(cfg.num_res_blocks + 1):
            blk["resnets"].append(resnet(f"decoder.up_blocks.{idx}"))
            idx += 1
        if i < n_stages - 1:
            blk["upsample"] = resample(f"decoder.up_blocks.{idx}")
            idx += 1
        dec["up"].append(blk)
    dec["norm_out"] = _gamma(state, "decoder.norm_out.gamma")
    dec["conv_out"] = conv3d(state, "decoder.conv_out")
    return {"encoder": enc, "decoder": dec, "quant_conv": conv3d(state, "quant_conv"),
            "post_quant_conv": conv3d(state, "post_quant_conv")}


def convert_hunyuan_vae(state: Mapping, cfg) -> Dict:
    """diffusers ``AutoencoderKLHunyuanVideo`` state dict."""

    def resnet(prefix):
        p = {"norm1": norm(state, f"{prefix}.norm1"), "conv1": conv3d(state, f"{prefix}.conv1"),
             "norm2": norm(state, f"{prefix}.norm2"), "conv2": conv3d(state, f"{prefix}.conv2")}
        if f"{prefix}.conv_shortcut.weight" in state:
            p["conv_shortcut"] = conv3d(state, f"{prefix}.conv_shortcut")
        return p

    def mid(prefix):
        a = f"{prefix}.attentions.0"
        return {
            "resnet1": resnet(f"{prefix}.resnets.0"),
            "attn": {"group_norm": norm(state, f"{a}.group_norm"), "to_q": linear(state, f"{a}.to_q"),
                     "to_k": linear(state, f"{a}.to_k"), "to_v": linear(state, f"{a}.to_v"),
                     "to_out": linear(state, f"{a}.to_out.0")},
            "resnet2": resnet(f"{prefix}.resnets.1"),
        }

    n = len(cfg.block_out_channels)
    enc = {"conv_in": conv3d(state, "encoder.conv_in"), "down": []}
    for i in range(n):
        blk = {"resnets": [resnet(f"encoder.down_blocks.{i}.resnets.{j}") for j in range(cfg.layers_per_block)]}
        dkey = f"encoder.down_blocks.{i}.downsamplers.0.conv"
        if f"{dkey}.weight" in state:
            blk["downsample"] = {"conv": conv3d(state, dkey)}
        enc["down"].append(blk)
    enc["mid"] = mid("encoder.mid_block")
    enc["norm_out"] = norm(state, "encoder.conv_norm_out")
    enc["conv_out"] = conv3d(state, "encoder.conv_out")

    dec = {"conv_in": conv3d(state, "decoder.conv_in"), "mid": mid("decoder.mid_block"), "up": []}
    for i in range(n):
        blk = {"resnets": [resnet(f"decoder.up_blocks.{i}.resnets.{j}") for j in range(cfg.layers_per_block + 1)]}
        ukey = f"decoder.up_blocks.{i}.upsamplers.0.conv"
        if f"{ukey}.weight" in state:
            blk["upsample"] = {"conv": conv3d(state, ukey)}
        dec["up"].append(blk)
    dec["norm_out"] = norm(state, "decoder.conv_norm_out")
    dec["conv_out"] = conv3d(state, "decoder.conv_out")
    return {"encoder": enc, "decoder": dec, "quant_conv": conv3d(state, "quant_conv"),
            "post_quant_conv": conv3d(state, "post_quant_conv")}


def convert_cogvideox_vae(state: Mapping, cfg) -> Dict:
    """diffusers ``AutoencoderKLCogVideoX`` state dict."""
    n = len(cfg.block_out_channels)

    def spatial_norm(prefix):  # the decoder's norm conditioned on the latent
        return {"norm": norm(state, f"{prefix}.norm_layer"), "conv_y": conv3d(state, f"{prefix}.conv_y.conv"),
                "conv_b": conv3d(state, f"{prefix}.conv_b.conv")}

    def resnet(prefix, spatial: bool):
        p = {"conv1": conv3d(state, f"{prefix}.conv1.conv"), "conv2": conv3d(state, f"{prefix}.conv2.conv")}
        for nm in ("norm1", "norm2"):
            p[nm] = spatial_norm(f"{prefix}.{nm}") if spatial else norm(state, f"{prefix}.{nm}")
        if f"{prefix}.conv_shortcut.conv.weight" in state:
            p["conv_shortcut"] = conv3d(state, f"{prefix}.conv_shortcut.conv")
        return p

    enc = {
        "conv_in": conv3d(state, "encoder.conv_in.conv"),
        "down": [],
        "mid": [resnet(f"encoder.mid_block.resnets.{j}", False) for j in range(2)],
        "norm_out": norm(state, "encoder.norm_out"),
        "conv_out": conv3d(state, "encoder.conv_out.conv"),
    }
    for i in range(n):
        blk = {"resnets": [resnet(f"encoder.down_blocks.{i}.resnets.{j}", False) for j in range(cfg.layers_per_block)]}
        dkey = f"encoder.down_blocks.{i}.downsamplers.0.conv"
        if f"{dkey}.weight" in state:
            blk["downsample"] = {"conv": conv2d(state, dkey)}
        enc["down"].append(blk)

    dec = {
        "conv_in": conv3d(state, "decoder.conv_in.conv"),
        "mid": [resnet(f"decoder.mid_block.resnets.{j}", True) for j in range(2)],
        "up": [],
        "norm_out": spatial_norm("decoder.norm_out"),
        "conv_out": conv3d(state, "decoder.conv_out.conv"),
    }
    for i in range(n):
        blk = {"resnets": [resnet(f"decoder.up_blocks.{i}.resnets.{j}", True) for j in range(cfg.layers_per_block + 1)]}
        ukey = f"decoder.up_blocks.{i}.upsamplers.0.conv"
        if f"{ukey}.weight" in state:
            blk["upsample"] = {"conv": conv2d(state, ukey)}
        dec["up"].append(blk)
    return {"encoder": enc, "decoder": dec}
