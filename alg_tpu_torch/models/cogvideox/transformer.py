"""CogVideoX DiT (counterpart of ``alg_tpu/models/cogvideox/transformer.py``).

diffusers ``CogVideoXTransformer3DModel`` as CogVideoX-5b-I2V uses it
(defaults below): 2D patchify per frame plus a T5-text projection into one
joint [text; video] token stream, ``num_layers`` blocks of AdaLN-zero
modulation, joint self-attention with per-head LayerNorm on q/k and 3D RoPE
on the video tokens, and a shared gelu-tanh FFN; then the final norm, the
AdaLN head, a linear projection and unpatchify.

Per block the DiT launches the two CUDA kernels of the port: the fused
qk LayerNorm + RoPE (``ops/qk_prep``) on q and on k, and flash attention
(``ops/flash_attention``) with ``stable=False``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
from torch import nn

from alg_tpu_torch.models import layers as L
from alg_tpu_torch.models import rope as R
from alg_tpu_torch.ops.attention import attention
from alg_tpu_torch.ops.qk_prep import qk_norm_rope


@dataclasses.dataclass(frozen=True)
class CogVideoXTransformerConfig:
    """Defaults = CogVideoX-5b-I2V (1.0 layout: no temporal patch, no ofs)."""

    num_attention_heads: int = 48
    attention_head_dim: int = 64
    in_channels: int = 32  # 16 noisy latent + 16 image-condition channels
    out_channels: int = 16
    time_embed_dim: int = 512
    text_embed_dim: int = 4096
    num_layers: int = 42
    sample_width: int = 90
    sample_height: int = 60
    patch_size: int = 2
    max_text_seq_length: int = 226
    norm_eps: float = 1e-5
    qk_norm_eps: float = 1e-6
    rope_theta: float = 10000.0

    @property
    def inner_dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim


def _resize_crop_region_for_grid(grid_h: int, grid_w: int, base_h: int, base_w: int):
    """Centred crop of the base grid with the sample's aspect ratio
    (diffusers ``get_resize_crop_region_for_grid``)."""
    th, tw = base_h, base_w
    if grid_h / grid_w > th / tw:
        resize_h, resize_w = th, int(round(th / grid_h * grid_w))
    else:
        resize_w, resize_h = tw, int(round(tw / grid_w * grid_h))
    top, left = int(round((th - resize_h) / 2.0)), int(round((tw - resize_w) / 2.0))
    return (top, left), (top + resize_h, left + resize_w)


def cogvideox_rope(cfg: CogVideoXTransformerConfig, height: int, width: int,
                   num_latent_frames: int) -> Tuple[np.ndarray, np.ndarray]:
    """(cos, sin) ``[S_video, head_dim]`` fp32 tables for the video tokens:
    dim_t = d/4 over frames, dim_h = dim_w = 3d/8 over the centred crop of
    the (sample_height/p, sample_width/p) base grid ("crop" grid type)."""
    d, p = cfg.attention_head_dim, cfg.patch_size
    grid_h, grid_w = height // (8 * p), width // (8 * p)
    (top, left), (bottom, right) = _resize_crop_region_for_grid(
        grid_h, grid_w, cfg.sample_height // p, cfg.sample_width // p)
    t_pos = np.arange(num_latent_frames, dtype=np.float64)
    h_pos = np.linspace(top, bottom, grid_h, endpoint=False, dtype=np.float64)
    w_pos = np.linspace(left, right, grid_w, endpoint=False, dtype=np.float64)
    ang_t = R.rope_frequencies(d // 4, t_pos, cfg.rope_theta)
    ang_h = R.rope_frequencies(d // 8 * 3, h_pos, cfg.rope_theta)
    ang_w = R.rope_frequencies(d // 8 * 3, w_pos, cfg.rope_theta)
    f = num_latent_frames
    shape = (f, grid_h, grid_w)
    angles = np.concatenate([
        np.broadcast_to(ang_t[:, None, None, :], shape + ang_t.shape[-1:]),
        np.broadcast_to(ang_h[None, :, None, :], shape + ang_h.shape[-1:]),
        np.broadcast_to(ang_w[None, None, :, :], shape + ang_w.shape[-1:]),
    ], axis=-1).reshape(f * grid_h * grid_w, d // 2)
    return R.cos_sin_interleaved(angles)


class AdaNormZero(nn.Module):
    """CogVideoXLayerNormZero: ``linear(silu(temb))`` -> 6 modulation vectors
    (shift, scale, gate for the video stream and for the text stream)."""

    def __init__(self, time_dim: int, dim: int, eps: float, device=None, dtype=None):
        super().__init__()
        self.linear = nn.Linear(time_dim, 6 * dim, device=device, dtype=dtype)
        self.norm = L.LayerNorm(dim, eps, device=device, dtype=dtype)

    def forward(self, hidden, encoder, temb):
        shift, scale, gate, e_shift, e_scale, e_gate = self.linear(L.silu(temb)).chunk(6, dim=-1)
        hn = self.norm(hidden) * (1 + scale[:, None]) + shift[:, None]
        en = self.norm(encoder) * (1 + e_scale[:, None]) + e_shift[:, None]
        return hn, en, gate[:, None], e_gate[:, None]


class JointAttention(nn.Module):
    def __init__(self, cfg: CogVideoXTransformerConfig, device=None, dtype=None):
        super().__init__()
        dim, hd = cfg.inner_dim, cfg.attention_head_dim
        kw = dict(device=device, dtype=dtype)
        self.to_q = nn.Linear(dim, dim, **kw)
        self.to_k = nn.Linear(dim, dim, **kw)
        self.to_v = nn.Linear(dim, dim, **kw)
        self.to_out = nn.Linear(dim, dim, **kw)
        self.norm_q = L.LayerNorm(hd, cfg.qk_norm_eps, **kw)
        self.norm_k = L.LayerNorm(hd, cfg.qk_norm_eps, **kw)
        self.nh, self.hd = cfg.num_attention_heads, hd

    def forward(self, joint: torch.Tensor, rope_cos: torch.Tensor, rope_sin: torch.Tensor):
        b, s, dim = joint.shape

        def heads(x):
            return x.view(b, s, self.nh, self.hd).transpose(1, 2).contiguous()

        def prep(x, norm):
            return qk_norm_rope(heads(x), norm.weight.float(), norm.bias.float(), rope_cos, rope_sin, norm.eps)

        q = prep(self.to_q(joint), self.norm_q)
        k = prep(self.to_k(joint), self.norm_k)
        o = attention(q, k, heads(self.to_v(joint)), stable=False)
        return self.to_out(o.transpose(1, 2).reshape(b, s, dim))


class CogVideoXBlock(nn.Module):
    def __init__(self, cfg: CogVideoXTransformerConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.norm1 = AdaNormZero(cfg.time_embed_dim, cfg.inner_dim, cfg.norm_eps, **kw)
        self.attn = JointAttention(cfg, **kw)
        self.norm2 = AdaNormZero(cfg.time_embed_dim, cfg.inner_dim, cfg.norm_eps, **kw)
        self.ff = L.MLP(cfg.inner_dim, 4 * cfg.inner_dim, **kw)

    def forward(self, hidden, encoder, temb, rope_cos, rope_sin):
        text_len = encoder.shape[1]
        hn, en, gate, e_gate = self.norm1(hidden, encoder, temb)
        o = self.attn(torch.cat([en, hn], dim=1), rope_cos, rope_sin)
        encoder = encoder + e_gate * o[:, :text_len]
        hidden = hidden + gate * o[:, text_len:]
        hn, en, gate, e_gate = self.norm2(hidden, encoder, temb)
        ff = self.ff(torch.cat([en, hn], dim=1))
        return hidden + gate * ff[:, text_len:], encoder + e_gate * ff[:, :text_len]


class CogVideoXTransformer(nn.Module):
    def __init__(self, cfg: CogVideoXTransformerConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        dim, p = cfg.inner_dim, cfg.patch_size
        kw = dict(device=device, dtype=dtype)
        self.patch_embed = nn.ModuleDict({
            # conv2d with stride = kernel = p, as a linear over flattened patches
            "proj": nn.Linear(cfg.in_channels * p * p, dim, **kw),
            "text_proj": nn.Linear(cfg.text_embed_dim, dim, **kw),
        })
        self.time_embedding = L.TimestepEmbedding(dim, cfg.time_embed_dim, **kw)
        self.norm_final = L.LayerNorm(dim, cfg.norm_eps, **kw)
        self.norm_out = nn.ModuleDict({
            "linear": nn.Linear(cfg.time_embed_dim, 2 * dim, **kw),
            "norm": L.LayerNorm(dim, cfg.norm_eps, **kw),
        })
        self.proj_out = nn.Linear(dim, p * p * cfg.out_channels, **kw)
        self.blocks = nn.ModuleList(CogVideoXBlock(cfg, **kw) for _ in range(cfg.num_layers))

    def forward(self, hidden_states: torch.Tensor, encoder_hidden_states: torch.Tensor,
                timestep: torch.Tensor, rope_cos: torch.Tensor, rope_sin: torch.Tensor) -> torch.Tensor:
        """``hidden_states`` [B, F, C, H, W] (latents ⧺ image condition),
        ``encoder_hidden_states`` [B, S_text, text_dim], ``timestep`` [B],
        ``rope_cos``/``rope_sin`` [S_video, head_dim] fp32 -> [B, F, out_c, H, W]."""
        cfg = self.cfg
        b, f, c, h, w = hidden_states.shape
        p = cfg.patch_size

        t_emb = L.sinusoidal_timestep_embedding(timestep, cfg.inner_dim)
        temb = self.time_embedding(t_emb.to(hidden_states.dtype))

        # patchify: [B, F, C, H, W] -> [B, F·H/p·W/p, C·p·p] (conv2d weight order)
        x = hidden_states.reshape(b, f, c, h // p, p, w // p, p).permute(0, 1, 3, 5, 2, 4, 6)
        video = self.patch_embed["proj"](x.reshape(b, f * (h // p) * (w // p), c * p * p))
        text = self.patch_embed["text_proj"](encoder_hidden_states.to(video.dtype))

        # identity rope rows over the text prefix: RoPE then covers the whole
        # joint stream and leaves the text tokens as they are
        text_len, d = text.shape[1], cfg.attention_head_dim
        rc = torch.cat([rope_cos.new_ones(text_len, d), rope_cos.float()]).contiguous()
        rs = torch.cat([rope_sin.new_zeros(text_len, d), rope_sin.float()]).contiguous()

        for blk in self.blocks:
            video, text = blk(video, text, temb, rc, rs)

        video = self.norm_final(torch.cat([text, video], dim=1))[:, text_len:]
        shift, scale = self.norm_out["linear"](L.silu(temb)).chunk(2, dim=-1)
        video = self.norm_out["norm"](video) * (1 + scale[:, None]) + shift[:, None]
        out = self.proj_out(video)  # [B, S, out_c·p·p]

        oc = cfg.out_channels
        out = out.reshape(b, f, h // p, w // p, oc, p, p).permute(0, 1, 4, 2, 5, 3, 6)
        return out.reshape(b, f, oc, h, w)
