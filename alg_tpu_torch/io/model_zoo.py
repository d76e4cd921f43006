"""Build pipelines from local HF-layout checkpoints (counterpart of
``alg_tpu/io/model_zoo.py``).

A checkpoint directory holds ``transformer/``, ``vae/``, the text and image
encoders, ``tokenizer/`` and ``scheduler/``, each with its ``config.json``
and safetensors shards. Each loader reads the configs into the port's config
dataclasses, builds every module on the target device in its dtype (the
DiT and text encoders in ``dtype``, the VAEs and CLIP towers in fp32, as
the reference does), with no initialisation (``meta`` then
``to_empty``), and copies the converted checkpoint tensors in: a bf16
shard goes to a bf16 module without passing through any other type. The
tokenizers are the port's own ``tokenizer.json`` interpreter
(:mod:`alg_tpu_torch.io.hf_tokenizer`); a tokenizer directory without
``tokenizer.json`` raises. Nothing is downloaded: :func:`resolve_model_dir`
finds local directories only. :func:`load_transformer` loads the DiT
alone, for fine-tuning. The CogVideoX loader reads 1.0 and 1.5
checkpoints (``patch_size_t``, ``ofs_embed_dim``, ``invert_scale_latents``),
DiTs without RoPE or attention biases, and picks DDIM or DPM from the
scheduler config. ``quantize`` ("w8" | "w4") replaces the DiT's big block
linears with W8A8 / W4A8 ones (``ops/quant.quantize_transformer_``, without
the modulation linears, as the JAX package's loaders do) after the copy-in,
one linear at a time on the device, so the bf16 and the quantized blocks are
never held whole together.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

import torch

from alg_tpu_torch.io import weights as W
from alg_tpu_torch.io.safetensors import load_safetensors_dir

def _load_config(model_dir: str, sub: str) -> Dict[str, Any]:
    with open(os.path.join(model_dir, sub, "config.json")) as f:
        return json.load(f)


def _quantized(dit, quantize):
    """``dit`` with its block linears quantized (``quantize`` "w8" | "w4"), or as it is (None)."""
    if quantize is None:
        return dit
    from alg_tpu_torch.ops.quant import quantize_transformer_

    return quantize_transformer_(dit, mode=quantize)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _load_module(cls, cfg, model_dir: str, sub: str, convert, dtype, device, timings: Optional[dict],
                 generator: Optional[torch.Generator] = None):
    """``cls(cfg)`` on ``device`` in ``dtype``, its parameters copied from
    ``model_dir/sub``'s shards through ``convert``, or drawn from
    ``generator`` (``layers.init_random_``) when one is given. ``timings``,
    when given, gets ``timings[sub]``: the seconds to map the shards
    (``read_s``), to convert the names (``convert_s``) and to copy into the
    module (``copy_s``: the pages come from disk or the page cache here),
    and the checkpoint bytes."""
    if generator is not None:
        from alg_tpu_torch.models.layers import init_random_

        return init_random_(cls(cfg, device=device, dtype=dtype), generator).requires_grad_(False)
    t0 = time.perf_counter()
    state = load_safetensors_dir(os.path.join(model_dir, sub))
    t1 = time.perf_counter()
    tree = convert(state, cfg)
    t2 = time.perf_counter()
    module = cls(cfg, device="meta", dtype=dtype).to_empty(device=device)
    W.load_tree(module, tree)
    _sync(device)
    t3 = time.perf_counter()
    if timings is not None:
        timings[sub] = {"read_s": t1 - t0, "convert_s": t2 - t1, "copy_s": t3 - t2,
                        "bytes": sum(t.numel() * t.element_size() for t in state.values())}
    return module.requires_grad_(False)


def _random_generator(device) -> torch.Generator:
    """``random_init``: the checkpoint's configs and tokenizers, and every
    tensor drawn on ``device`` from seed 0 instead of read."""
    return torch.Generator(device).manual_seed(0)


# -- the DiTs -----------------------------------------------------------------------


def cogvideox_configs(configs: Dict[str, Dict[str, Any]]):
    """(DiT, VAE, T5) configs of a CogVideoX checkpoint from the contents of
    its ``transformer``, ``vae`` and ``text_encoder`` ``config.json``, as a
    dict of the three (the form of ``io/hf_checkpoint``'s constants)."""
    from alg_tpu_torch.models.cogvideox.vae import CogVideoXVAEConfig
    from alg_tpu_torch.models.t5 import T5Config

    vc, te = configs["vae"], configs["text_encoder"]
    vcfg = CogVideoXVAEConfig(
        block_out_channels=tuple(vc["block_out_channels"]),
        latent_channels=vc["latent_channels"],
        layers_per_block=vc["layers_per_block"],
        norm_num_groups=vc.get("norm_num_groups", 32),
        norm_eps=vc.get("norm_eps", 1e-6),
        temporal_compression_ratio=vc.get("temporal_compression_ratio", 4),
        scaling_factor=vc.get("scaling_factor", 0.7),
        invert_scale_latents=vc.get("invert_scale_latents", False),
    )
    t5cfg = T5Config(
        vocab_size=te["vocab_size"],
        d_model=te["d_model"],
        d_kv=te["d_kv"],
        d_ff=te["d_ff"],
        num_layers=te["num_layers"],
        num_heads=te["num_heads"],
        relative_attention_num_buckets=te.get("relative_attention_num_buckets", 32),
        relative_attention_max_distance=te.get("relative_attention_max_distance", 128),
    )
    return _cogvideox_dit_cfg(configs["transformer"]), vcfg, t5cfg


def _cogvideox_transformer_cfg(model_dir: str):
    return _cogvideox_dit_cfg(_load_config(model_dir, "transformer"))


def _cogvideox_dit_cfg(tc: Dict[str, Any]):
    from alg_tpu_torch.models.cogvideox.transformer import CogVideoXTransformerConfig

    return CogVideoXTransformerConfig(
        num_attention_heads=tc["num_attention_heads"],
        attention_head_dim=tc["attention_head_dim"],
        in_channels=tc["in_channels"],
        out_channels=tc["out_channels"],
        time_embed_dim=tc["time_embed_dim"],
        ofs_embed_dim=tc.get("ofs_embed_dim"),
        text_embed_dim=tc["text_embed_dim"],
        num_layers=tc["num_layers"],
        attention_bias=tc.get("attention_bias", True),
        sample_width=tc["sample_width"],
        sample_height=tc["sample_height"],
        patch_size=tc["patch_size"],
        patch_size_t=tc.get("patch_size_t"),
        max_text_seq_length=tc.get("max_text_seq_length", 226),
        norm_eps=tc.get("norm_eps", 1e-5),
        use_rotary_positional_embeddings=tc.get("use_rotary_positional_embeddings", True),
    )


def _wan_transformer_cfg(model_dir: str):
    from alg_tpu_torch.models.wan.transformer import WanTransformerConfig

    tc = _load_config(model_dir, "transformer")
    return WanTransformerConfig(
        num_attention_heads=tc["num_attention_heads"],
        attention_head_dim=tc["attention_head_dim"],
        in_channels=tc["in_channels"],
        out_channels=tc["out_channels"],
        num_layers=tc["num_layers"],
        ffn_dim=tc["ffn_dim"],
        freq_dim=tc["freq_dim"],
        text_dim=tc["text_dim"],
        image_dim=tc.get("image_dim"),
        patch_size=tuple(tc["patch_size"]),
        eps=tc.get("eps", 1e-6),
    )


def _hunyuan_transformer_cfg(model_dir: str):
    from alg_tpu_torch.models.hunyuan.transformer import HunyuanVideoTransformerConfig

    tc = _load_config(model_dir, "transformer")
    return HunyuanVideoTransformerConfig(
        in_channels=tc["in_channels"],
        out_channels=tc["out_channels"],
        num_attention_heads=tc["num_attention_heads"],
        attention_head_dim=tc["attention_head_dim"],
        num_layers=tc["num_layers"],
        num_single_layers=tc["num_single_layers"],
        num_refiner_layers=tc.get("num_refiner_layers", 2),
        mlp_ratio=tc.get("mlp_ratio", 4.0),
        patch_size=tc.get("patch_size", 2),
        patch_size_t=tc.get("patch_size_t", 1),
        text_embed_dim=tc.get("text_embed_dim", 4096),
        pooled_projection_dim=tc.get("pooled_projection_dim", 768),
        guidance_embeds=tc.get("guidance_embeds", True),
        rope_theta=tc.get("rope_theta", 256.0),
        rope_axes_dim=tuple(tc.get("rope_axes_dim", (16, 56, 56))),
        image_condition_type=tc.get("image_condition_type", "token_replace"),
    )


def _transformer_parts(family: str):
    """(module class, config reader, name map) of the family's DiT."""
    if family == "cogvideox":
        from alg_tpu_torch.models.cogvideox.transformer import CogVideoXTransformer

        return CogVideoXTransformer, _cogvideox_transformer_cfg, W.convert_cogvideox_transformer
    if family == "wan":
        from alg_tpu_torch.models.wan.transformer import WanTransformer

        return WanTransformer, _wan_transformer_cfg, W.convert_wan_transformer
    if family == "hunyuan":
        from alg_tpu_torch.models.hunyuan.transformer import HunyuanVideoTransformer

        return HunyuanVideoTransformer, _hunyuan_transformer_cfg, W.convert_hunyuan_transformer
    raise ValueError(f"unknown model family {family!r}")


def load_transformer(model_dir: str, family: str, dtype=torch.bfloat16, quantize=None, device="cuda",
                     timings: Optional[dict] = None):
    """The family's DiT alone from ``model_dir/transformer`` on ``device`` in
    ``dtype``: what fine-tuning needs, without the text and image encoders
    and the VAE. It goes through the config reader and name map of the
    pipeline loaders, with their refusals, so the module is bit for bit the
    ``transformer`` of :func:`load_cogvideox_pipeline`,
    :func:`load_wan_pipeline` or :func:`load_hunyuan_pipeline` on the same
    directory, dtype, device and ``quantize``."""
    cls, read_cfg, convert = _transformer_parts(family)
    return _quantized(_load_module(cls, read_cfg(model_dir), model_dir, "transformer", convert, dtype, device,
                                   timings), quantize)


def load_cogvideox_pipeline(model_dir: str, dtype=torch.bfloat16, quantize=None, device="cuda",
                            timings: Optional[dict] = None, random_init: bool = False):
    """CogVideoX-I2V checkpoint dir -> :class:`CogVideoXPipeline` on ``device``."""
    from alg_tpu_torch.models.cogvideox.transformer import CogVideoXTransformer
    from alg_tpu_torch.models.cogvideox.vae import CogVideoXVAE
    from alg_tpu_torch.models.t5 import T5Encoder
    from alg_tpu_torch.pipelines.cogvideox import CogVideoXPipeline
    from alg_tpu_torch.schedulers.ddim_cogvideox import CogVideoXDDIMConfig

    gen = _random_generator(device) if random_init else None
    tcfg, vcfg, t5cfg = cogvideox_configs({sub: _load_config(model_dir, sub)
                                           for sub in ("transformer", "vae", "text_encoder")})
    sc = _load_config(model_dir, "scheduler") if os.path.exists(
        os.path.join(model_dir, "scheduler", "config.json")) else _load_scheduler_cfg(model_dir)
    scfg = CogVideoXDDIMConfig(
        num_train_timesteps=sc.get("num_train_timesteps", 1000),
        beta_start=sc.get("beta_start", 0.00085),
        beta_end=sc.get("beta_end", 0.012),
        beta_schedule=sc.get("beta_schedule", "scaled_linear"),
        snr_shift_scale=sc.get("snr_shift_scale", 3.0),
        rescale_betas_zero_snr=sc.get("rescale_betas_zero_snr", True),
        set_alpha_to_one=sc.get("set_alpha_to_one", True),
        timestep_spacing=sc.get("timestep_spacing", "trailing"),
        steps_offset=sc.get("steps_offset", 0),
        prediction_type=sc.get("prediction_type", "v_prediction"),
    )

    dit = _quantized(_load_module(CogVideoXTransformer, tcfg, model_dir, "transformer",
                                  W.convert_cogvideox_transformer, dtype, device, timings, gen), quantize)
    vae = _load_module(CogVideoXVAE, vcfg, model_dir, "vae", W.convert_cogvideox_vae, torch.float32, device,
                       timings, gen)
    t5 = _load_module(T5Encoder, t5cfg, model_dir, "text_encoder", W.convert_t5_encoder, dtype, device, timings,
                      gen)
    return CogVideoXPipeline(transformer=dit, vae=vae, t5=t5, tokenize=_make_tokenizer(model_dir),
                             scheduler="dpm" if "DPM" in sc.get("_class_name", "") else "ddim", scheduler_cfg=scfg,
                             dtype=dtype, device=device)


def load_wan_pipeline(model_dir: str, dtype=torch.bfloat16, flow_shift: float = 5.0, quantize=None, device="cuda",
                      timings: Optional[dict] = None, random_init: bool = False):
    """Wan2.1-I2V checkpoint dir -> :class:`WanPipeline` on ``device``: fp32
    CLIP vision tower and VAE, UniPC with ``flow_shift``."""
    from alg_tpu_torch.models.clip import CLIPVisionConfig, CLIPVisionModel
    from alg_tpu_torch.models.t5 import T5Config, T5Encoder
    from alg_tpu_torch.models.wan.transformer import WanTransformer
    from alg_tpu_torch.models.wan.vae import WanVAE, WanVAEConfig
    from alg_tpu_torch.pipelines.wan import WanPipeline
    from alg_tpu_torch.schedulers.unipc import UniPCConfig

    gen = _random_generator(device) if random_init else None
    tcfg = _wan_transformer_cfg(model_dir)
    vc = _load_config(model_dir, "vae")
    vcfg = WanVAEConfig(
        base_dim=vc.get("base_dim", 96),
        z_dim=vc.get("z_dim", 16),
        dim_mult=tuple(vc.get("dim_mult", (1, 2, 4, 4))),
        num_res_blocks=vc.get("num_res_blocks", 2),
        temperal_downsample=tuple(vc.get("temperal_downsample", (False, True, True))),
        latents_mean=tuple(vc["latents_mean"]),
        latents_std=tuple(vc["latents_std"]),
    )
    te = _load_config(model_dir, "text_encoder")
    t5cfg = T5Config(
        vocab_size=te["vocab_size"],
        d_model=te["d_model"],
        d_kv=te["d_kv"],
        d_ff=te["d_ff"],
        num_layers=te["num_layers"],
        num_heads=te["num_heads"],
        # alg_tpu's loader keeps the defaults (32, 128), which UMT5-XXL ships; a checkpoint with other
        # values gets them here, since its bias tables must fit (ROADMAP.md C, R9)
        relative_attention_num_buckets=te.get("relative_attention_num_buckets", 32),
        relative_attention_max_distance=te.get("relative_attention_max_distance", 128),
        per_layer_relative_bias=True,  # UMT5
    )
    ic = _load_config(model_dir, "image_encoder")
    ccfg = CLIPVisionConfig(
        hidden_size=ic["hidden_size"],
        intermediate_size=ic["intermediate_size"],
        num_hidden_layers=ic["num_hidden_layers"],
        num_attention_heads=ic["num_attention_heads"],
        image_size=ic["image_size"],
        patch_size=ic["patch_size"],
        hidden_act=ic.get("hidden_act", "gelu"),
    )

    dit = _quantized(_load_module(WanTransformer, tcfg, model_dir, "transformer", W.convert_wan_transformer, dtype,
                                  device, timings, gen), quantize)
    vae = _load_module(WanVAE, vcfg, model_dir, "vae", W.convert_wan_vae, torch.float32, device, timings, gen)
    t5 = _load_module(T5Encoder, t5cfg, model_dir, "text_encoder", W.convert_t5_encoder, dtype, device, timings,
                      gen)
    clip = _load_module(CLIPVisionModel, ccfg, model_dir, "image_encoder", W.convert_clip_vision, torch.float32,
                        device, timings, gen)
    return WanPipeline(transformer=dit, vae=vae, t5=t5, clip=clip, tokenize=_make_wan_tokenizer(model_dir),
                       scheduler_cfg=UniPCConfig(flow_shift=flow_shift), dtype=dtype, device=device)


def load_hunyuan_pipeline(model_dir: str, dtype=torch.bfloat16, flow_shift: float = 7.0, invert_sigmas: bool = False,
                          quantize=None, device="cuda", timings: Optional[dict] = None, random_init: bool = False):
    """HunyuanVideo-I2V checkpoint dir -> :class:`HunyuanVideoPipeline` on
    ``device``: Llava in ``dtype``, the CLIP text model and the VAE in fp32,
    flow-match Euler. The image processor is the pipeline's default
    (``clip_preprocess``, which needs PIL)."""
    from alg_tpu_torch.models.clip import CLIPTextConfig, CLIPTextModel, CLIPVisionConfig
    from alg_tpu_torch.models.hunyuan.transformer import HunyuanVideoTransformer
    from alg_tpu_torch.models.hunyuan.vae import HunyuanVAE, HunyuanVAEConfig
    from alg_tpu_torch.models.llama import LlamaConfig, LlavaConfig, LlavaModel
    from alg_tpu_torch.pipelines.hunyuan import HunyuanVideoPipeline
    from alg_tpu_torch.schedulers.flow_match_euler import FlowMatchEulerConfig

    gen = _random_generator(device) if random_init else None
    tcfg = _hunyuan_transformer_cfg(model_dir)
    vc = _load_config(model_dir, "vae")
    vcfg = HunyuanVAEConfig(
        latent_channels=vc.get("latent_channels", 16),
        block_out_channels=tuple(vc.get("block_out_channels", (128, 256, 512, 512))),
        layers_per_block=vc.get("layers_per_block", 2),
        norm_num_groups=vc.get("norm_num_groups", 32),
        scaling_factor=vc.get("scaling_factor", 0.476986),
        temporal_compression_ratio=vc.get("temporal_compression_ratio", 4),
    )
    llava_raw = _load_config(model_dir, "text_encoder")
    text_raw = llava_raw.get("text_config", {})
    vision_raw = llava_raw.get("vision_config", {})
    lcfg = LlavaConfig(
        text=LlamaConfig(
            vocab_size=text_raw.get("vocab_size", 128320),
            hidden_size=text_raw.get("hidden_size", 4096),
            intermediate_size=text_raw.get("intermediate_size", 14336),
            num_hidden_layers=text_raw.get("num_hidden_layers", 32),
            num_attention_heads=text_raw.get("num_attention_heads", 32),
            num_key_value_heads=text_raw.get("num_key_value_heads", 8),
            rope_theta=text_raw.get("rope_theta", 500000.0),
        ),
        vision=CLIPVisionConfig(
            hidden_size=vision_raw.get("hidden_size", 1024),
            intermediate_size=vision_raw.get("intermediate_size", 4096),
            num_hidden_layers=vision_raw.get("num_hidden_layers", 24),
            num_attention_heads=vision_raw.get("num_attention_heads", 16),
            image_size=vision_raw.get("image_size", 336),
            patch_size=vision_raw.get("patch_size", 14),
            hidden_act=vision_raw.get("hidden_act", "quick_gelu"),
        ),
        image_token_index=llava_raw.get("image_token_index", 128257),
        pad_token_id=llava_raw.get("pad_token_id", 128258),
    )
    c2 = _load_config(model_dir, "text_encoder_2")
    ccfg = CLIPTextConfig(
        vocab_size=c2["vocab_size"],
        hidden_size=c2["hidden_size"],
        intermediate_size=c2["intermediate_size"],
        num_hidden_layers=c2["num_hidden_layers"],
        num_attention_heads=c2["num_attention_heads"],
        max_position_embeddings=c2.get("max_position_embeddings", 77),
        hidden_act=c2.get("hidden_act", "quick_gelu"),
        eos_token_id=c2.get("eos_token_id", 49407),
    )

    dit = _quantized(_load_module(HunyuanVideoTransformer, tcfg, model_dir, "transformer",
                                  W.convert_hunyuan_transformer, dtype, device, timings, gen), quantize)
    vae = _load_module(HunyuanVAE, vcfg, model_dir, "vae", W.convert_hunyuan_vae, torch.float32, device, timings,
                       gen)
    llava = _load_module(LlavaModel, lcfg, model_dir, "text_encoder", W.convert_llava, dtype, device, timings, gen)
    clip = _load_module(CLIPTextModel, ccfg, model_dir, "text_encoder_2", W.convert_clip_text, torch.float32,
                        device, timings, gen)
    return HunyuanVideoPipeline(
        transformer=dit, vae=vae, llava=llava, clip=clip,
        tokenize_llama=_make_plain_tokenizer(model_dir, "tokenizer", with_mask=True),
        tokenize_clip=_make_plain_tokenizer(model_dir, "tokenizer_2", with_mask=False),
        scheduler_cfg=FlowMatchEulerConfig(shift=flow_shift, invert_sigmas=invert_sigmas), dtype=dtype, device=device)


# -- tokenizers ------------------------------------------------------------------


def _native_tokenize(model_dir: str, sub: str = "tokenizer"):
    """The ``tokenizer.json`` interpreter over ``model_dir/sub``: None when
    that directory is absent (the pipeline then needs prompt embeddings),
    and an error when it holds no ``tokenizer.json``: the port has no other
    tokenizer to fall back on."""
    tok_dir = os.path.join(model_dir, sub)
    if not os.path.isdir(tok_dir):
        return None
    from alg_tpu_torch.io.hf_tokenizer import load_tokenizer

    native = load_tokenizer(tok_dir)
    if native is None:
        raise FileNotFoundError(f"{tok_dir} holds no tokenizer.json: the port reads HF fast-tokenizer files only")
    return native


def _make_tokenizer(model_dir: str):
    """CogVideoX's T5 hook: ``(prompts, max_length) -> int32 ids``."""
    native = _native_tokenize(model_dir)
    if native is None:
        return None

    def tokenize(prompts, max_length):
        ids, _ = native(prompts, max_length)
        return ids.astype("int32")

    return tokenize


def _make_wan_tokenizer(model_dir: str):
    """Wan's UMT5 hook: ``(prompts, max_length) -> (int32 ids, int32 mask)``."""
    native = _native_tokenize(model_dir)
    if native is None:
        return None

    def tokenize(prompts, max_length):
        ids, mask = native(prompts, max_length)
        return ids.astype("int32"), mask.astype("int32")

    return tokenize


def _make_plain_tokenizer(model_dir: str, sub: str, with_mask: bool):
    """HunyuanVideo's hooks: int64 ids, with the mask for Llava."""
    native = _native_tokenize(model_dir, sub)
    if native is None:
        return None

    def tokenize(prompts, max_length):
        ids, mask = native(prompts, max_length)
        if with_mask:
            return ids.astype("int64"), mask.astype("int64")
        return ids.astype("int64")

    return tokenize


def _load_scheduler_cfg(model_dir: str) -> Dict[str, Any]:
    path = os.path.join(model_dir, "scheduler", "scheduler_config.json")
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {}


def resolve_model_dir(model_path: str, cache_dir: Optional[str]) -> str:
    """A local checkout for an HF repo id: ``model_path`` itself, or
    ``cache_dir/<id>``, or the newest snapshot under the HF hub cache layout
    ``cache_dir/models--<org>--<name>/snapshots``. Nothing is downloaded."""
    if os.path.isdir(model_path):
        return model_path
    candidates = []
    if cache_dir:
        candidates.append(os.path.join(cache_dir, model_path))
        candidates.append(os.path.join(cache_dir, "models--" + model_path.replace("/", "--"), "snapshots"))
    for c in candidates:
        if os.path.isdir(c):
            if c.endswith("snapshots"):
                snaps = sorted(os.listdir(c))
                if snaps:
                    return os.path.join(c, snaps[-1])
            else:
                return c
    raise FileNotFoundError(f"Model {model_path!r} not found locally (nothing is downloaded). "
                            "Provide --model_cache_dir with an HF-layout checkout.")
