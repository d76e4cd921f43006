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
    """The port's ``kind`` ("dit" | "vae" | "t5") module on the CPU in fp32,
    loaded from the JAX tree through the weights bridge."""
    from alg_tpu_torch.io.jax_params import load_jax_params
    from alg_tpu_torch.models.cogvideox import transformer as T
    from alg_tpu_torch.models.cogvideox import vae as V
    from alg_tpu_torch.models import t5

    cls, cfg_cls = {
        "dit": (T.CogVideoXTransformer, T.CogVideoXTransformerConfig),
        "vae": (V.CogVideoXVAE, V.CogVideoXVAEConfig),
        "t5": (t5.T5Encoder, t5.T5Config),
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
                              t5=port_module("t5", t5cfg, t5p), tokenize=tokenize_stub)
    return jpipe, tpipe


def psnr(a, b, peak=1.0):
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else 10 * np.log10(peak**2 / mse)
