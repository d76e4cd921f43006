"""Shared builders for the ``test_torch_port_*`` tests: tiny JAX-package
models and their ``alg_tpu_torch`` counterparts with the same weights.

Weights are seeded numpy arrays laid out as the JAX package's parameter
trees (the tree shapes come from ``jax.eval_shape`` of its ``init_*``
functions, which compiles nothing), so both packages run the same numbers
and the port gets them through its own weights bridge."""

import dataclasses

import numpy as np

import jax


def port_cfg(port_cls, jax_cfg):
    """The port's config dataclass with the JAX config's values."""
    return port_cls(**{f.name: getattr(jax_cfg, f.name) for f in dataclasses.fields(port_cls)})


def random_tree(init_fn, seed):
    """A numpy parameter tree shaped like ``init_fn(key)``: kernels
    N(0, 1/fan_in), norm scales 1 + N(0, 0.1²), biases N(0, 0.1²), other
    tables N(0, 0.5²)."""
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        x = rng.randn(*shape).astype(np.float32)
        if name == "kernel":
            fan_in = shape[-2] if len(shape) <= 3 else int(np.prod(shape[:-1]))
            return x / np.sqrt(fan_in)
        if name == "scale":
            return 1.0 + 0.1 * x
        if name == "bias":
            return 0.1 * x
        return 0.5 * x

    return jax.tree_util.tree_map_with_path(fill, jax.eval_shape(init_fn, jax.random.PRNGKey(0)))


def tiny_configs():
    """``__graft_entry__._build_tiny_cogvideox``'s DiT and VAE configs and a
    2-layer T5 whose width matches the DiT's text dim."""
    from alg_tpu.models.cogvideox import CogVideoXTransformerConfig, CogVideoXVAEConfig
    from alg_tpu.models.t5 import T5Config

    tcfg = CogVideoXTransformerConfig(
        num_attention_heads=4, attention_head_dim=16, in_channels=8, out_channels=4,
        time_embed_dim=16, text_embed_dim=12, num_layers=2,
        sample_height=4, sample_width=4, max_text_seq_length=4,
    )
    vcfg = CogVideoXVAEConfig(block_out_channels=(8, 16, 16, 32), latent_channels=4,
                              layers_per_block=1, norm_num_groups=4)
    t5cfg = T5Config(vocab_size=64, d_model=12, d_kv=4, d_ff=24, num_layers=2, num_heads=3,
                     relative_attention_num_buckets=8, relative_attention_max_distance=16)
    return tcfg, vcfg, t5cfg


def port_module(kind, jax_cfg, tree):
    """The port's ``kind`` ("dit" | "vae" | "t5" | "wan_dit" | "wan_vae" |
    "clip") module on the CPU in fp32, loaded from the JAX tree through the
    weights bridge."""
    from alg_tpu_torch.io.jax_params import load_jax_params
    from alg_tpu_torch.models import clip, t5
    from alg_tpu_torch.models.cogvideox import transformer as T
    from alg_tpu_torch.models.cogvideox import vae as V
    from alg_tpu_torch.models.wan import transformer as WT
    from alg_tpu_torch.models.wan import vae as WV

    cls, cfg_cls = {
        "dit": (T.CogVideoXTransformer, T.CogVideoXTransformerConfig),
        "vae": (V.CogVideoXVAE, V.CogVideoXVAEConfig),
        "t5": (t5.T5Encoder, t5.T5Config),
        "wan_dit": (WT.WanTransformer, WT.WanTransformerConfig),
        "wan_vae": (WV.WanVAE, WV.WanVAEConfig),
        "clip": (clip.CLIPVisionModel, clip.CLIPVisionConfig),
    }[kind]
    return load_jax_params(cls(port_cfg(cfg_cls, jax_cfg)), tree)


def jax_trees(tcfg, vcfg, t5cfg):
    from alg_tpu.models.cogvideox import init_cogvideox_transformer, init_cogvideox_vae
    from alg_tpu.models.t5 import init_t5_encoder

    return (
        random_tree(lambda k: init_cogvideox_transformer(k, tcfg), 1),
        random_tree(lambda k: init_cogvideox_vae(k, vcfg), 2),
        random_tree(lambda k: init_t5_encoder(k, t5cfg), 3),
    )


def tokenize_stub(prompts, max_len=226):
    """Seeded token ids ``[len(prompts), max_len]`` in [0, 64): a tokenizer
    stand-in that differs per prompt text."""
    return np.stack([
        np.random.RandomState(sum(map(ord, p)) + 7).randint(0, 64, size=max_len) for p in prompts
    ]).astype(np.int32)


def build_pair():
    """(JAX pipeline, port pipeline) on the CPU in fp32 with identical weights."""
    from alg_tpu.pipelines import CogVideoXPipeline as JaxPipeline

    from alg_tpu_torch.pipelines.cogvideox import CogVideoXPipeline

    tcfg, vcfg, t5cfg = tiny_configs()
    tp, vp, t5p = jax_trees(tcfg, vcfg, t5cfg)
    jpipe = JaxPipeline(transformer_cfg=tcfg, transformer_params=tp, vae_cfg=vcfg, vae_params=vp,
                        t5_cfg=t5cfg, t5_params=t5p, tokenize=tokenize_stub)
    tpipe = CogVideoXPipeline(transformer=port_module("dit", tcfg, tp), vae=port_module("vae", vcfg, vp),
                              t5=port_module("t5", t5cfg, t5p), tokenize=tokenize_stub, device="cpu")
    return jpipe, tpipe


def tiny_wan_configs(head_dim=12):
    """``__graft_entry__._build_tiny_wan``'s DiT and VAE configs, a 2-layer
    UMT5 (one bias table per block) as wide as the DiT's text dim and a
    2-layer CLIP vision tower as wide as its image dim."""
    from alg_tpu.models.clip import CLIPVisionConfig
    from alg_tpu.models.t5 import T5Config
    from alg_tpu.models.wan import WanTransformerConfig, WanVAEConfig

    tcfg = WanTransformerConfig(num_attention_heads=4, attention_head_dim=head_dim, in_channels=12, out_channels=4,
                                num_layers=2, ffn_dim=32, freq_dim=16, text_dim=8, image_dim=10)
    vcfg = WanVAEConfig(base_dim=8, z_dim=4, dim_mult=(1, 2, 2, 2), num_res_blocks=1,
                        latents_mean=tuple(float(x) for x in np.linspace(-0.5, 0.5, 4)),
                        latents_std=tuple(float(x) for x in np.linspace(1.0, 2.0, 4)))
    t5cfg = T5Config(vocab_size=64, d_model=8, d_kv=4, d_ff=16, num_layers=2, num_heads=3,
                     relative_attention_num_buckets=8, relative_attention_max_distance=16,
                     per_layer_relative_bias=True)
    ccfg = CLIPVisionConfig(hidden_size=10, intermediate_size=20, num_hidden_layers=2, num_attention_heads=2,
                            image_size=28, patch_size=14)
    return tcfg, vcfg, t5cfg, ccfg


def wan_trees(tcfg, vcfg, t5cfg, ccfg):
    from alg_tpu.models.clip import init_clip_vision
    from alg_tpu.models.t5 import init_t5_encoder
    from alg_tpu.models.wan import init_wan_transformer, init_wan_vae

    return (
        random_tree(lambda k: init_wan_transformer(k, tcfg), 11),
        random_tree(lambda k: init_wan_vae(k, vcfg), 12),
        random_tree(lambda k: init_t5_encoder(k, t5cfg), 13),
        random_tree(lambda k: init_clip_vision(k, ccfg), 14),
    )


def tokenize_mask_stub(prompts, max_len=512):
    """Seeded ``(ids, mask)``, each ``[len(prompts), max_len]``: ids in
    [0, 64), a prefix mask whose length depends on the prompt text (the
    empty prompt gets one token, as a tokenizer's end-of-sequence)."""
    ids = tokenize_stub(prompts, max_len)
    lens = [min(max_len, 1 + len(p) % max_len) for p in prompts]
    mask = (np.arange(max_len)[None, :] < np.asarray(lens)[:, None]).astype(np.int32)
    return ids * mask, mask


def build_wan_pair(**port_kwargs):
    """(JAX Wan pipeline, port Wan pipeline) on the CPU in fp32 with
    identical weights; UMT5 behind ``tokenize_mask_stub``, no CLIP tower
    (callers pass ``image_embeds``)."""
    from alg_tpu.pipelines import WanPipeline as JaxPipeline
    from alg_tpu.schedulers import UniPCConfig as JaxUniPCConfig

    from alg_tpu_torch.pipelines.wan import WanPipeline
    from alg_tpu_torch.schedulers.unipc import UniPCConfig

    tcfg, vcfg, t5cfg, ccfg = tiny_wan_configs()
    tp, vp, t5p, _ = wan_trees(tcfg, vcfg, t5cfg, ccfg)
    jpipe = JaxPipeline(transformer_cfg=tcfg, transformer_params=tp, vae_cfg=vcfg, vae_params=vp, t5_cfg=t5cfg,
                        t5_params=t5p, tokenize=tokenize_mask_stub, scheduler_cfg=JaxUniPCConfig(flow_shift=5.0))
    tpipe = WanPipeline(transformer=port_module("wan_dit", tcfg, tp), vae=port_module("wan_vae", vcfg, vp),
                        t5=port_module("t5", t5cfg, t5p), tokenize=tokenize_mask_stub,
                        scheduler_cfg=UniPCConfig(flow_shift=5.0), device="cpu", **port_kwargs)
    return jpipe, tpipe


def psnr(a, b, peak=1.0):
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else 10 * np.log10(peak**2 / mse)
