"""CLIP vision and text encoders (counterpart of ``alg_tpu/models/clip.py``).

transformers ``CLIPVisionModel`` (Wan's image encoder, and the ViT-L/14-336
tower inside HunyuanVideo's Llava): a stride-``patch_size`` patch
convolution without bias, a class token, learned position embeddings, a
pre-LayerNorm and ``num_hidden_layers`` pre-norm encoder layers. Both
callers take ``hidden_states[-2]``: the penultimate layer's output, without
the final norm. Each layer's attention goes through the port's flash kernel
(head dim 80 in ViT-H, 64 in ViT-L).

transformers ``CLIPTextModel`` (HunyuanVideo's pooled text encoder): token
and position tables, the same encoder layers with causal attention (the
flash kernel's ``causal`` at head dim 64), a final LayerNorm, and the pooled
output taken at the first end-of-sequence token.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch
from torch import nn

from alg_tpu_torch.models import layers as L
from alg_tpu_torch.ops.attention import attention

# OpenAI CLIP normalisation (CLIPImageProcessor defaults)
CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    """Defaults = the laion ViT-H/14 tower that Wan2.1-I2V ships."""

    hidden_size: int = 1280
    intermediate_size: int = 5120
    num_hidden_layers: int = 32
    num_attention_heads: int = 16
    image_size: int = 224
    patch_size: int = 14
    layer_norm_eps: float = 1e-5
    hidden_act: str = "gelu"  # laion ViT-H; OpenAI models use quick_gelu


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    """Defaults = the OpenAI ViT-L/14 text model that HunyuanVideo ships."""

    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 77
    layer_norm_eps: float = 1e-5
    hidden_act: str = "quick_gelu"
    eos_token_id: int = 49407


def _act(name: str):
    if name == "quick_gelu":
        return lambda x: x * torch.sigmoid(1.702 * x)
    if name == "gelu":
        return L.gelu
    if name == "gelu_new":
        return L.gelu_tanh
    raise ValueError(name)


class _Attention(nn.Module):
    def __init__(self, dim: int, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.q = nn.Linear(dim, dim, **kw)
        self.k = nn.Linear(dim, dim, **kw)
        self.v = nn.Linear(dim, dim, **kw)
        self.out = nn.Linear(dim, dim, **kw)


class _MLP(nn.Module):
    def __init__(self, dim: int, inter: int, device=None, dtype=None):
        super().__init__()
        self.fc1 = nn.Linear(dim, inter, device=device, dtype=dtype)
        self.fc2 = nn.Linear(inter, dim, device=device, dtype=dtype)


class CLIPEncoderLayer(nn.Module):
    """One pre-norm layer of either tower; ``causal`` for the text model."""

    def __init__(self, cfg, causal: bool = False, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.num_heads, self.causal = cfg.num_attention_heads, causal
        self.act = _act(cfg.hidden_act)
        self.layer_norm1 = L.LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, **kw)
        self.attn = _Attention(cfg.hidden_size, **kw)
        self.layer_norm2 = L.LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, **kw)
        self.mlp = _MLP(cfg.hidden_size, cfg.intermediate_size, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, dim = x.shape

        def heads(t):
            return t.view(b, s, self.num_heads, dim // self.num_heads).transpose(1, 2)

        h = self.layer_norm1(x)
        o = attention(heads(self.attn.q(h)), heads(self.attn.k(h)), heads(self.attn.v(h)), causal=self.causal)
        x = x + self.attn.out(o.transpose(1, 2).reshape(b, s, dim))
        h = self.layer_norm2(x)
        return x + self.mlp.fc2(self.act(self.mlp.fc1(h)))


class CLIPVisionModel(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype)
        n_pos = (cfg.image_size // cfg.patch_size) ** 2 + 1
        self.class_embedding = L.table((cfg.hidden_size,), 0.02, **kw)
        self.patch_embedding = nn.Conv2d(3, cfg.hidden_size, cfg.patch_size, stride=cfg.patch_size, bias=False, **kw)
        self.position_embedding = L.table((n_pos, cfg.hidden_size), 0.02, **kw)
        self.pre_layrnorm = L.LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, **kw)  # [sic], as in transformers
        self.layers = nn.ModuleList(CLIPEncoderLayer(cfg, **kw) for _ in range(cfg.num_hidden_layers))
        self.post_layernorm = L.LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, **kw)  # pooled output only: unused

    def forward(self, pixel_values: torch.Tensor) -> List[torch.Tensor]:
        """``pixel_values`` [B, 3, H, W] (CLIP-normalised) -> the hidden
        states entering layer 0 and leaving every layer, each [B, 1 + N,
        hidden]; index [-2] is the penultimate layer's output."""
        b = pixel_values.shape[0]
        patches = self.patch_embedding(pixel_values).flatten(2).transpose(1, 2)  # [B, N, hidden], row-major patches
        cls = self.class_embedding.to(patches.dtype).expand(b, 1, -1)
        h = torch.cat([cls, patches], dim=1) + self.position_embedding.to(patches.dtype)[None]
        h = self.pre_layrnorm(h)
        hidden_states = [h]
        for layer in self.layers:
            h = layer(h)
            hidden_states.append(h)
        return hidden_states


class CLIPTextModel(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype)
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size, **kw)
        self.token_embedding.init_std = 0.02
        self.position_embedding = L.table((cfg.max_position_embeddings, cfg.hidden_size), 0.02, **kw)
        self.layers = nn.ModuleList(CLIPEncoderLayer(cfg, causal=True, **kw) for _ in range(cfg.num_hidden_layers))
        self.final_layer_norm = L.LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, **kw)

    def forward(self, input_ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """``input_ids`` [B, S] -> (last hidden state [B, S, hidden], pooled
        [B, hidden]): the pooled row is the first position that holds
        ``eos_token_id`` (position 0 where there is none)."""
        s = input_ids.shape[1]
        h = self.token_embedding(input_ids) + self.position_embedding[:s][None]
        for layer in self.layers:
            h = layer(h)
        h = self.final_layer_norm(h)
        eos_pos = torch.argmax((input_ids == self.cfg.eos_token_id).to(torch.int32), dim=1)
        return h, h[torch.arange(h.shape[0], device=h.device), eos_pos]


def clip_preprocess(image, size: int = 224) -> np.ndarray:
    """Image -> CLIP ``pixel_values`` fp32 [1, 3, size, size]: resize the
    shortest edge (bicubic), centre crop, rescale, normalise
    (CLIPImageProcessor defaults).

    Takes a PIL image or an array ([H, W, C], [C, H, W] or [B, C, H, W], in
    [0, 1], [-1, 1] or uint8 range); arrays go through PIL for the resize,
    and an RGB array already ``size`` x ``size`` (whose resize and crop are
    the identity) needs no PIL."""
    if not type(image).__module__.startswith("PIL."):
        arr = np.asarray(image, np.float32)
        if arr.ndim == 4:
            arr = arr[0]
        if arr.ndim == 3 and arr.shape[0] in (1, 3):
            arr = arr.transpose(1, 2, 0)
        if arr.min() < -0.01:  # [-1, 1] convention
            arr = arr / 2.0 + 0.5
        if arr.max() <= 1.5:
            arr = arr * 255.0
        arr = np.clip(arr, 0, 255).astype(np.uint8)
        if arr.shape == (size, size, 3):
            return _clip_normalize(arr)
        from PIL import Image

        image = Image.fromarray(arr)
    from PIL import Image

    w, h = image.size
    scale = size / min(w, h)
    image = image.resize((round(w * scale), round(h * scale)), resample=Image.BICUBIC)
    w, h = image.size
    left, top = (w - size) // 2, (h - size) // 2
    image = image.crop((left, top, left + size, top + size))
    return _clip_normalize(np.asarray(image.convert("RGB")))


def _clip_normalize(rgb: np.ndarray) -> np.ndarray:
    """uint8 ``[size, size, 3]`` -> normalised fp32 ``[1, 3, size, size]``."""
    arr = rgb.astype(np.float32) / 255.0
    arr = (arr - np.array(CLIP_IMAGE_MEAN)) / np.array(CLIP_IMAGE_STD)
    return arr.transpose(2, 0, 1)[None].astype(np.float32)
