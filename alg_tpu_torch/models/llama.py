"""Llama-3 decoder and the Llava multimodal encoder (counterpart of
``alg_tpu/models/llama.py``).

HunyuanVideo's first text encoder is a Llava-Llama3-8B run as a feature
extractor: the prompt template's ``<image>`` token is expanded to 576
positions, the CLIP ViT-L/14-336 tower's penultimate patch features are
projected into the token stream at those positions, and the hidden states
three layers from the top (``hidden_states[-3]``) are returned.

Llama: RMSNorm pre-norm, half-split rotary embedding with a configurable
theta, grouped-query attention, SwiGLU MLP, no biases. Every layer's
attention is causal with the prompt's ``kv_len`` and goes through the port's
flash kernel at head dim 128; keys and values are repeated to the query
heads before the call, so the kernel sees ``[B, heads, S, head_dim]``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch
from torch import nn

from alg_tpu_torch.models import layers as L
from alg_tpu_torch.models import rope as R
from alg_tpu_torch.models.clip import CLIPVisionConfig, CLIPVisionModel
from alg_tpu_torch.ops.attention import attention


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    """Defaults = Llama-3-8B with Llava's extended vocabulary."""

    vocab_size: int = 128320
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    rms_norm_eps: float = 1e-5
    rope_theta: float = 500000.0

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


@dataclasses.dataclass(frozen=True)
class LlavaConfig:
    text: LlamaConfig = dataclasses.field(default_factory=LlamaConfig)
    vision: CLIPVisionConfig = dataclasses.field(
        default_factory=lambda: CLIPVisionConfig(hidden_size=1024, intermediate_size=4096, num_hidden_layers=24,
                                                 num_attention_heads=16, image_size=336, patch_size=14,
                                                 hidden_act="quick_gelu"))
    image_token_index: int = 128257
    pad_token_id: int = 128258
    vision_feature_layer: int = -2  # penultimate CLIP layer
    vision_feature_select_strategy: str = "default"  # drop the CLS token


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(bias=False, device=device, dtype=dtype)
        self.nh, self.nkv, self.hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
        kv_dim = self.nkv * self.hd
        self.input_norm = L.RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, device=device, dtype=dtype)
        self.q = nn.Linear(cfg.hidden_size, cfg.hidden_size, **kw)
        self.k = nn.Linear(cfg.hidden_size, kv_dim, **kw)
        self.v = nn.Linear(cfg.hidden_size, kv_dim, **kw)
        self.o = nn.Linear(cfg.hidden_size, cfg.hidden_size, **kw)
        self.post_norm = L.RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, device=device, dtype=dtype)
        self.gate = nn.Linear(cfg.hidden_size, cfg.intermediate_size, **kw)
        self.up = nn.Linear(cfg.hidden_size, cfg.intermediate_size, **kw)
        self.down = nn.Linear(cfg.intermediate_size, cfg.hidden_size, **kw)

    def forward(self, x, cos, sin, kv_len):
        b, s, hdim = x.shape
        h = self.input_norm(x)
        q = self.q(h).view(b, s, self.nh, self.hd).transpose(1, 2)
        k = self.k(h).view(b, s, self.nkv, self.hd).transpose(1, 2)
        v = self.v(h).view(b, s, self.nkv, self.hd).transpose(1, 2)
        q = R.apply_rope_half(q, cos, sin)
        k = R.apply_rope_half(k, cos, sin)
        if self.nkv != self.nh:
            k = k.repeat_interleave(self.nh // self.nkv, dim=1)
            v = v.repeat_interleave(self.nh // self.nkv, dim=1)
        o = attention(q, k, v, causal=True, kv_len=kv_len)
        x = x + self.o(o.transpose(1, 2).reshape(b, s, hdim))
        h = self.post_norm(x)
        return x + self.down(L.silu(self.gate(h)) * self.up(h))


class LlamaModel(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype)
        self.embed = nn.Embedding(cfg.vocab_size, cfg.hidden_size, **kw)
        self.embed.init_std = 0.02
        self.blocks = nn.ModuleList(LlamaBlock(cfg, **kw) for _ in range(cfg.num_hidden_layers))
        self.final_norm = L.RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, **kw)

    def forward(self, inputs_embeds: torch.Tensor, position_ids: Optional[torch.Tensor] = None,
                kv_len: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
        """``inputs_embeds`` [B, S, H], ``position_ids`` [B, S] or None (0 ..
        S − 1), ``kv_len`` int32 [B] (a right-padding mask) -> the hidden
        states in transformers' convention: ``[embeddings, after layer 1,
        ..., after layer n − 1, final_norm(after layer n)]``. The last entry
        is final-normed and the un-normed last layer is not in the list."""
        cfg = self.cfg
        s, hd = inputs_embeds.shape[1], cfg.head_dim
        if position_ids is None:
            angles = R.rope_frequencies(hd, np.arange(s), cfg.rope_theta)
            cos, sin = (torch.from_numpy(a).to(inputs_embeds.device)[None] for a in R.cos_sin_half(angles))
        else:
            inv = 1.0 / (cfg.rope_theta ** (np.arange(0, hd, 2, dtype=np.float64) / hd))
            inv = torch.from_numpy(inv.astype(np.float32)).to(inputs_embeds.device)
            ang = position_ids.float()[..., None] * inv[None, None]
            cos = torch.cat([torch.cos(ang), torch.cos(ang)], dim=-1)
            sin = torch.cat([torch.sin(ang), torch.sin(ang)], dim=-1)
        cos, sin = cos[:, None], sin[:, None]  # over the heads

        x = inputs_embeds
        hidden_states = [x]
        for i, blk in enumerate(self.blocks):
            x = blk(x, cos, sin, kv_len)
            hidden_states.append(self.final_norm(x) if i == len(self.blocks) - 1 else x)
        return hidden_states


class _Projector(nn.Module):
    def __init__(self, vision_dim: int, text_dim: int, device=None, dtype=None):
        super().__init__()
        self.linear_1 = nn.Linear(vision_dim, text_dim, device=device, dtype=dtype)
        self.linear_2 = nn.Linear(text_dim, text_dim, device=device, dtype=dtype)

    def forward(self, x):
        return self.linear_2(L.gelu(self.linear_1(x)))


class LlavaModel(nn.Module):
    def __init__(self, cfg: LlavaConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype)
        self.language_model = LlamaModel(cfg.text, **kw)
        self.vision_tower = CLIPVisionModel(cfg.vision, **kw)
        self.projector = _Projector(cfg.vision.hidden_size, cfg.text.hidden_size, **kw)

    def image_features(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """CLIP patch features (CLS dropped) through the 2-layer exact-GELU
        projector: ``[B, (image_size / patch_size)², H]``."""
        feats = self.vision_tower(pixel_values)[self.cfg.vision_feature_layer]
        if self.cfg.vision_feature_select_strategy == "default":
            feats = feats[:, 1:]
        return self.projector(feats)

    def forward(self, input_ids: torch.Tensor, pixel_values: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                position_ids: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
        """Token embeddings with the image features scattered over the
        image-token span (the n-th image token of a row takes feature n);
        returns Llama's hidden-state list."""
        embeds = self.language_model.embed(input_ids)
        img = self.image_features(pixel_values).to(embeds.dtype)
        is_image = input_ids == self.cfg.image_token_index
        idx = (torch.cumsum(is_image.to(torch.int32), dim=1) - 1).clamp(0, img.shape[1] - 1)
        gathered = torch.gather(img, 1, idx[..., None].expand(-1, -1, img.shape[-1]).long())
        embeds = torch.where(is_image[..., None], gathered, embeds)
        kv_len = None if attention_mask is None else attention_mask.sum(dim=1).to(torch.int32)
        return self.language_model(embeds, position_ids, kv_len)
