"""Shared builders for the ``test_torch_port_*`` tests: tiny JAX-package
models and their ``alg_tpu_torch`` counterparts with the same weights.

Weights are seeded numpy arrays laid out as the JAX package's parameter
trees (the tree shapes come from ``jax.eval_shape`` of its ``init_*``
functions, which compiles nothing), so both packages run the same numbers
and the port gets them through its own weights bridge."""

import contextlib
import dataclasses

import numpy as np
import pytest

import jax

from quant_feed import QuantFeed, kernel_key


@contextlib.contextmanager
def one_torch_thread():
    """PyTorch on one thread inside the block. The suite's workers share the
    machine, and there a small op's parallel region waits until every one of
    PyTorch's threads is scheduled: tiny tensors run faster on one."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """:func:`one_torch_thread` over a whole module: a test module takes it by importing this name."""
    with one_torch_thread():
        yield


def port_cfg(port_cls, jax_cfg):
    """The port's config dataclass with the JAX config's values (a nested
    config, as Llava's text and vision ones, becomes the port's class too)."""
    kw = {}
    for f in dataclasses.fields(port_cls):
        val = getattr(jax_cfg, f.name)
        if dataclasses.is_dataclass(val):
            val = port_cfg(type(getattr(port_cls(), f.name)), val)
        kw[f.name] = val
    return port_cls(**kw)


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
    "clip" | "clip_text" | "llama" | "llava" | "hunyuan_dit" | "hunyuan_vae")
    module on the CPU in fp32, loaded from the JAX tree through the weights
    bridge."""
    from alg_tpu_torch.io.jax_params import load_jax_params
    from alg_tpu_torch.models import clip, llama, t5
    from alg_tpu_torch.models.hunyuan import transformer as HT
    from alg_tpu_torch.models.hunyuan import vae as HV
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
        "clip_text": (clip.CLIPTextModel, clip.CLIPTextConfig),
        "llama": (llama.LlamaModel, llama.LlamaConfig),
        "llava": (llama.LlavaModel, llama.LlavaConfig),
        "hunyuan_dit": (HT.HunyuanVideoTransformer, HT.HunyuanVideoTransformerConfig),
        "hunyuan_vae": (HV.HunyuanVAE, HV.HunyuanVAEConfig),
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


# -- HunyuanVideo ----------------------------------------------------------------

HY_IMG, HY_PAD, HY_DRT = 60, 0, 7  # the tiny Llava's <image>, pad and double-return token ids
# a prompt template cut to the tiny Llava: a 4-token head, the image block at [5, 9) (28/14 = 2 x 2 patches)
HY_TEMPLATE = {"template": "{}", "crop_start": 4, "image_emb_start": 5, "image_emb_end": 9, "image_emb_len": 4,
               "double_return_token_id": HY_DRT}


def tiny_hunyuan_configs(**dit_over):
    """``__graft_entry__._build_tiny_hunyuan``'s DiT and VAE configs, a
    3-layer Llava (GQA 2 heads / 1 kv head, a 2-layer CLIP tower) as wide as
    the DiT's text dim and a 2-layer CLIP text model as wide as its pooled
    dim."""
    from alg_tpu.models.clip import CLIPTextConfig, CLIPVisionConfig
    from alg_tpu.models.hunyuan import HunyuanVAEConfig, HunyuanVideoTransformerConfig
    from alg_tpu.models.llama import LlamaConfig, LlavaConfig

    tcfg = HunyuanVideoTransformerConfig(**{**dict(
        in_channels=4, out_channels=4, num_attention_heads=4, attention_head_dim=8, num_layers=1,
        num_single_layers=1, num_refiner_layers=1, mlp_ratio=2.0, text_embed_dim=12, pooled_projection_dim=6,
        rope_axes_dim=(2, 4, 2)), **dit_over})
    vcfg = HunyuanVAEConfig(block_out_channels=(8, 16, 16, 16), latent_channels=4, layers_per_block=1,
                            norm_num_groups=4)
    lcfg = LlavaConfig(
        text=LlamaConfig(vocab_size=128, hidden_size=12, intermediate_size=24, num_hidden_layers=3,
                         num_attention_heads=2, num_key_value_heads=1, rope_theta=10000.0, rms_norm_eps=1e-6),
        vision=CLIPVisionConfig(hidden_size=8, intermediate_size=16, num_hidden_layers=2, num_attention_heads=2,
                                image_size=28, patch_size=14, hidden_act="quick_gelu"),
        image_token_index=HY_IMG, pad_token_id=HY_PAD)
    ccfg = CLIPTextConfig(vocab_size=64, hidden_size=6, intermediate_size=12, num_hidden_layers=2,
                          num_attention_heads=2, max_position_embeddings=10, eos_token_id=63)
    return tcfg, vcfg, lcfg, ccfg


def hunyuan_trees(tcfg, vcfg, lcfg, ccfg):
    from alg_tpu.models.clip import init_clip_text
    from alg_tpu.models.hunyuan import init_hunyuan_transformer, init_hunyuan_vae
    from alg_tpu.models.llama import init_llava

    return (
        random_tree(lambda k: init_hunyuan_transformer(k, tcfg), 31),
        random_tree(lambda k: init_hunyuan_vae(k, vcfg), 32),
        random_tree(lambda k: init_llava(k, lcfg), 33),
        random_tree(lambda k: init_clip_text(k, ccfg), 34),
    )


def tokenize_llama_stub(prompts, max_len):
    """Seeded ``(ids, mask)``, each ``[len(prompts), max_len]``, laid out as
    the Llava tokenizer lays out the template: one ``<image>`` token at
    position 5, four double-return tokens (the last two before the end),
    right padding; the length depends on the prompt text."""
    rows = []
    for p in prompts:
        row = np.random.RandomState(sum(map(ord, p)) + 5).randint(10, 50, size=max_len).astype(np.int64)
        n_real = min(max_len, 18 + len(p) % 5)
        row[n_real:] = HY_PAD
        row[5] = HY_IMG
        row[[2, 9, 14, n_real - 2]] = HY_DRT
        rows.append(row)
    ids = np.stack(rows)
    return ids, (ids != HY_PAD).astype(np.int64)


def tokenize_clip_stub(prompts, max_len=77):
    """Seeded CLIP ids ``[len(prompts), max_len]`` in [0, 63) with the
    end-of-sequence id 63 in the middle of the row and again at its end."""
    rows = []
    for p in prompts:
        row = np.random.RandomState(sum(map(ord, p)) + 9).randint(0, 63, size=max_len).astype(np.int32)
        row[[2 + len(p) % (max_len - 3), max_len - 1]] = 63
        rows.append(row)
    return np.stack(rows)


def build_hunyuan_pair(with_encoders=False, **dit_over):
    """(JAX Hunyuan pipeline, port Hunyuan pipeline) on the CPU in fp32 with
    identical weights; ``with_encoders`` adds the tiny Llava and CLIP text
    model behind the tokenizer stubs (else callers pass prompt embeds)."""
    from alg_tpu.pipelines import HunyuanVideoPipeline as JaxPipeline

    from alg_tpu_torch.pipelines.hunyuan import HunyuanVideoPipeline

    tcfg, vcfg, lcfg, ccfg = tiny_hunyuan_configs(**dit_over)
    tp, vp, lp, cp = hunyuan_trees(tcfg, vcfg, lcfg, ccfg)
    jkw, tkw = {}, {}
    if with_encoders:
        jkw = dict(llava_cfg=lcfg, llava_params=lp, clip_cfg=ccfg, clip_params=cp,
                   tokenize_llama=tokenize_llama_stub, tokenize_clip=tokenize_clip_stub)
        tkw = dict(llava=port_module("llava", lcfg, lp), clip=port_module("clip_text", ccfg, cp),
                   tokenize_llama=tokenize_llama_stub, tokenize_clip=tokenize_clip_stub)
    jpipe = JaxPipeline(transformer_cfg=tcfg, transformer_params=tp, vae_cfg=vcfg, vae_params=vp, **jkw)
    tpipe = HunyuanVideoPipeline(transformer=port_module("hunyuan_dit", tcfg, tp),
                                 vae=port_module("hunyuan_vae", vcfg, vp), device="cpu", **tkw)
    return jpipe, tpipe


def psnr(a, b, peak=1.0):
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else 10 * np.log10(peak**2 / mse)


# -- quantized DiTs -----------------------------------------------------------------


def quant_dit_configs():
    """JAX DiT configs whose block linears are wide enough to quantize (in and
    out at least 128), with in-dims that are and are not multiples of 128
    (W4A8's int8 fallback), and modulation linears of at least 128 in."""
    from alg_tpu.models.cogvideox import CogVideoXTransformerConfig
    from alg_tpu.models.hunyuan import HunyuanVideoTransformerConfig
    from alg_tpu.models.wan import WanTransformerConfig

    return {
        # inner 192 (to_q falls back in w4), ff 768 (fc_out takes w4), norm linears 128 -> 1152
        "cogvideox": CogVideoXTransformerConfig(num_attention_heads=3, attention_head_dim=64, in_channels=8,
                                                out_channels=4, time_embed_dim=128, text_embed_dim=16, num_layers=2,
                                                sample_height=4, sample_width=4, max_text_seq_length=4),
        # inner 128 (w4), ffn 320 (fc_out falls back)
        "wan": WanTransformerConfig(num_attention_heads=2, attention_head_dim=64, in_channels=12, out_channels=4,
                                    num_layers=2, ffn_dim=320, freq_dim=16, text_dim=16, image_dim=16),
        # inner 128, mlp 320: proj_out's in 448 falls back, ff's fc_out too; modulation 128 -> 768
        "hunyuan": HunyuanVideoTransformerConfig(in_channels=4, out_channels=4, num_attention_heads=2,
                                                 attention_head_dim=64, num_layers=1, num_single_layers=2,
                                                 num_refiner_layers=1, mlp_ratio=2.5, text_embed_dim=16,
                                                 pooled_projection_dim=8, rope_axes_dim=(16, 24, 24)),
    }


_QUANT_FAMILIES = {
    "cogvideox": ("alg_tpu.models.cogvideox", "init_cogvideox_transformer", "dit"),
    "wan": ("alg_tpu.models.wan", "init_wan_transformer", "wan_dit"),
    "hunyuan": ("alg_tpu.models.hunyuan", "init_hunyuan_transformer", "hunyuan_dit"),
}


def quant_dit(family, seed=21):
    """(JAX config of :func:`quant_dit_configs`, its seeded numpy tree, tree -> the port's DiT on the CPU in
    fp32 loaded through the weights bridge; a quantized tree gives ``QuantizedLinear`` modules)."""
    import importlib

    jmod, jinit, kind = _QUANT_FAMILIES[family]
    cfg = quant_dit_configs()[family]
    tree = random_tree(lambda k: getattr(importlib.import_module(jmod), jinit)(k, cfg), seed)
    return cfg, tree, lambda t: port_module(kind, cfg, t)


class QuantTeacher(QuantFeed):
    """A :class:`quant_feed.QuantFeed` of the JAX package's run: records the input and output of each quantized
    linear call of its forward, by weight and in call order; :meth:`feeding` feeds them to the port's, each checked
    against the port's own as ``quant_feed`` says. What is left of the comparison is the rest of the model and
    which linears run where, held at the usual bounds (``test_torch_port_quant.py`` holds the linears themselves
    bit-equal on one input)."""

    def __init__(self, monkeypatch):
        from alg_tpu.ops import quant as JQ

        super().__init__()
        original = JQ.quantized_linear

        def store(kernel, x, y):
            self.put(kernel_key(np.asarray(kernel)), np.array(x), np.array(y))

        def recorded(p, x):  # the values reach the host in program order, under jit too
            y = original(p, x)
            jax.debug.callback(store, p.get("kernel_q", p.get("kernel_q4")), x, y, ordered=True)
            return y

        monkeypatch.setattr(JQ, "quantized_linear", recorded)
