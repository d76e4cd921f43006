"""HunyuanVideo DiT (counterpart of ``alg_tpu/models/hunyuan/transformer.py``).

diffusers ``HunyuanVideoTransformer3DModel`` in its token_replace I2V form:

  * dual-stream ("double") blocks: separate video and text streams with
    AdaLN-zero modulation and one joint attention over [video; text] (video
    tokens first; the padded text tail masked with ``kv_len``), q and k
    RMS-normed per head, 3-D RoPE on the video tokens only; then
    single-stream blocks over the concatenated sequence with attention and
    MLP in parallel and one fused output projection;
  * the Llama text embeddings pass through a 2-block token refiner
    conditioned on (timestep, masked-mean pooled text);
  * conditioning embedding = timestep + projected CLIP pooled text +
    distilled-guidance embedding (``guidance_scale·1000``);
  * token_replace: the first latent frame holds the clean image latent, so
    its tokens take the modulation of the t = 0 embedding and the rest the
    current timestep's.

Defaults = HunyuanVideo-I2V 13B: dim 3072 (24 heads × 128), 20 double + 40
single blocks, rope axes (16, 56, 56) at theta 256.

A forward launches the port's flash kernel (``ops/flash_attention``) once
per refiner block (``stable=True``, the prompt's ``kv_len``) and once per
double and single block (``stable=False``, ``kv_len`` = video tokens + valid
text tokens), and the rope kernel (``ops/rope``) on q and on k of every
double and single block, with identity rows for the text suffix.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from alg_tpu_torch.models import layers as L
from alg_tpu_torch.models import rope as R
from alg_tpu_torch.ops.attention import attention
from alg_tpu_torch.ops.rope import rope_interleaved
from alg_tpu_torch.sharding.pipeline import run_blocks


@dataclasses.dataclass(frozen=True)
class HunyuanVideoTransformerConfig:
    in_channels: int = 16
    out_channels: int = 16
    num_attention_heads: int = 24
    attention_head_dim: int = 128
    num_layers: int = 20  # double-stream blocks
    num_single_layers: int = 40
    num_refiner_layers: int = 2
    mlp_ratio: float = 4.0
    patch_size: int = 2
    patch_size_t: int = 1
    text_embed_dim: int = 4096
    pooled_projection_dim: int = 768
    guidance_embeds: bool = True
    rope_theta: float = 256.0
    rope_axes_dim: Tuple[int, int, int] = (16, 56, 56)
    image_condition_type: Optional[str] = "token_replace"  # or None (T2V)

    @property
    def inner_dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim


def hunyuan_rope(cfg: HunyuanVideoTransformerConfig, num_latent_frames: int, latent_height: int,
                 latent_width: int) -> Tuple[np.ndarray, np.ndarray]:
    """(cos, sin) ``[S_video, head_dim]`` fp32: axes (t, h, w) of dims
    ``rope_axes_dim``, interleaved-pair convention."""
    dt, dh, dw = cfg.rope_axes_dim
    f = num_latent_frames // cfg.patch_size_t
    hh, ww = latent_height // cfg.patch_size, latent_width // cfg.patch_size
    ang_t = R.rope_frequencies(dt, np.arange(f), cfg.rope_theta)
    ang_h = R.rope_frequencies(dh, np.arange(hh), cfg.rope_theta)
    ang_w = R.rope_frequencies(dw, np.arange(ww), cfg.rope_theta)
    shape = (f, hh, ww)
    angles = np.concatenate([
        np.broadcast_to(ang_t[:, None, None, :], shape + ang_t.shape[-1:]),
        np.broadcast_to(ang_h[None, :, None, :], shape + ang_h.shape[-1:]),
        np.broadcast_to(ang_w[None, None, :, :], shape + ang_w.shape[-1:]),
    ], axis=-1).reshape(f * hh * ww, -1)
    return R.cos_sin_interleaved(angles)


def _modulate(xn: torch.Tensor, shift, scale, shift_tr, scale_tr, first_len: int) -> torch.Tensor:
    """``xn·(1 + scale) + shift``; under token_replace the first
    ``first_len`` tokens take the t = 0 modulation instead. Each modulation
    is ``[B, 1, dim]``."""
    if shift_tr is None:
        return xn * (1 + scale) + shift
    n = first_len
    return torch.cat([xn[:, :n] * (1 + scale_tr) + shift_tr, xn[:, n:] * (1 + scale) + shift], dim=1)


def _gated_add(x: torch.Tensor, delta: torch.Tensor, gate, gate_tr, first_len: int) -> torch.Tensor:
    """``x + delta·gate``, the first ``first_len`` tokens gated by ``gate_tr``."""
    if gate_tr is None:
        return x + delta * gate
    n = first_len
    return x + torch.cat([delta[:, :n] * gate_tr, delta[:, n:] * gate], dim=1)


def _chunks(mod: Optional[torch.Tensor], n: int):
    """``[B, n·dim]`` -> n modulations ``[B, 1, dim]`` (all None for None)."""
    if mod is None:
        return (None,) * n
    return tuple(c[:, None] for c in mod.chunk(n, dim=-1))


class _Heads(nn.Module):
    """Head split and merge shared by the attention modules."""

    nh: int
    hd: int

    def heads(self, t: torch.Tensor) -> torch.Tensor:  # [B, S, dim] -> a [B, H, S, D] view
        return t.view(t.shape[0], -1, self.nh, self.hd).transpose(1, 2)

    def unheads(self, t: torch.Tensor) -> torch.Tensor:
        return t.transpose(1, 2).reshape(t.shape[0], -1, self.nh * self.hd)


class _RefinerAttention(nn.Module):
    def __init__(self, dim: int, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.to_q = L.Linear(dim, dim, **kw)
        self.to_k = L.Linear(dim, dim, **kw)
        self.to_v = L.Linear(dim, dim, **kw)
        self.to_out = L.Linear(dim, dim, **kw)


class RefinerBlock(_Heads):
    """Self-attention and a SiLU MLP over the text, each gated by AdaLN
    gates (no shift or scale)."""

    def __init__(self, cfg: HunyuanVideoTransformerConfig, device=None, dtype=None):
        super().__init__()
        dim = cfg.inner_dim
        kw = dict(device=device, dtype=dtype)
        self.nh, self.hd = cfg.num_attention_heads, cfg.attention_head_dim
        self.norm1 = L.LayerNorm(dim, 1e-6, **kw)
        self.attn = _RefinerAttention(dim, **kw)
        self.norm2 = L.LayerNorm(dim, 1e-6, **kw)
        self.ff = L.MLP(dim, int(dim * cfg.mlp_ratio), act=L.silu, **kw)
        self.ada = L.Linear(dim, 2 * dim, **kw)

    def forward(self, x, temb, kv_len):
        gate_msa, gate_mlp = _chunks(self.ada(L.silu(temb)), 2)
        xn = self.norm1(x)
        a = self.attn
        o = attention(self.heads(a.to_q(xn)), self.heads(a.to_k(xn)), self.heads(a.to_v(xn)), kv_len=kv_len)
        x = x + a.to_out(self.unheads(o)) * gate_msa
        return x + self.ff(self.norm2(x)) * gate_mlp


class TokenRefiner(nn.Module):
    """HunyuanVideoTokenRefiner: the text embeddings projected to the DiT's
    width and refined by blocks conditioned on (timestep, pooled text)."""

    def __init__(self, cfg: HunyuanVideoTransformerConfig, device=None, dtype=None):
        super().__init__()
        dim = cfg.inner_dim
        kw = dict(device=device, dtype=dtype)
        self.input_embedder = L.Linear(cfg.text_embed_dim, dim, **kw)
        self.t_embedder = L.TimestepEmbedding(256, dim, **kw)
        self.c_embedder = L.TimestepEmbedding(cfg.text_embed_dim, dim, **kw)
        self.blocks = nn.ModuleList(RefinerBlock(cfg, **kw) for _ in range(cfg.num_refiner_layers))

    def forward(self, text_embeds, text_mask, timestep):
        t_freq = L.sinusoidal_timestep_embedding(timestep, 256)
        temb = self.t_embedder(t_freq.to(text_embeds.dtype))
        if text_mask is None:
            pooled, kv_len = text_embeds.mean(dim=1), None
        else:
            m = text_mask.to(text_embeds.dtype)[..., None]
            pooled = (text_embeds * m).sum(dim=1) / m.sum(dim=1).clamp(min=1.0)
            kv_len = text_mask.sum(dim=1).to(torch.int32)
        temb = temb + self.c_embedder(pooled)
        x = self.input_embedder(text_embeds)
        for blk in self.blocks:
            x = blk(x, temb, kv_len)
        return x


class _JointAttention(nn.Module):
    """Projections and per-head q/k norms of a block's attention; the
    double blocks also hold the text stream's (``add_*``)."""

    def __init__(self, dim: int, head_dim: int, text_stream: bool, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.to_q = L.Linear(dim, dim, **kw)
        self.to_k = L.Linear(dim, dim, **kw)
        self.to_v = L.Linear(dim, dim, **kw)
        self.norm_q = L.RMSNorm(head_dim, 1e-6, **kw)
        self.norm_k = L.RMSNorm(head_dim, 1e-6, **kw)
        if text_stream:
            self.to_out = L.Linear(dim, dim, **kw)
            self.add_q_proj = L.Linear(dim, dim, **kw)
            self.add_k_proj = L.Linear(dim, dim, **kw)
            self.add_v_proj = L.Linear(dim, dim, **kw)
            self.to_add_out = L.Linear(dim, dim, **kw)
            self.norm_added_q = L.RMSNorm(head_dim, 1e-6, **kw)
            self.norm_added_k = L.RMSNorm(head_dim, 1e-6, **kw)


class DoubleBlock(_Heads):
    def __init__(self, cfg: HunyuanVideoTransformerConfig, device=None, dtype=None):
        super().__init__()
        dim, mlp = cfg.inner_dim, int(cfg.inner_dim * cfg.mlp_ratio)
        kw = dict(device=device, dtype=dtype)
        self.nh, self.hd = cfg.num_attention_heads, cfg.attention_head_dim
        self.norm1_linear = L.Linear(dim, 6 * dim, **kw)
        self.norm1_context_linear = L.Linear(dim, 6 * dim, **kw)
        self.attn = _JointAttention(dim, self.hd, True, **kw)
        self.ff = L.MLP(dim, mlp, **kw)
        self.ff_context = L.MLP(dim, mlp, **kw)

    def forward(self, x, text, temb, temb_tr, kv_len, rope_cos, rope_sin, first_len):
        seq_v = x.shape[1]
        s, sc, g, s2, sc2, g2 = _chunks(self.norm1_linear(L.silu(temb)), 6)
        ts, tsc, tg, ts2, tsc2, tg2 = _chunks(None if temb_tr is None else self.norm1_linear(L.silu(temb_tr)), 6)
        cs, csc, cg, cs2, csc2, cg2 = _chunks(self.norm1_context_linear(L.silu(temb)), 6)
        xn = _modulate(L.layer_norm(x, None, None, 1e-6), s, sc, ts, tsc, first_len)
        tn = L.layer_norm(text, None, None, 1e-6) * (1 + csc) + cs

        a = self.attn
        q = torch.cat([a.norm_q(self.heads(a.to_q(xn))), a.norm_added_q(self.heads(a.add_q_proj(tn)))], dim=2)
        k = torch.cat([a.norm_k(self.heads(a.to_k(xn))), a.norm_added_k(self.heads(a.add_k_proj(tn)))], dim=2)
        v = torch.cat([self.heads(a.to_v(xn)), self.heads(a.add_v_proj(tn))], dim=2)
        if rope_cos is not None:
            q = rope_interleaved(q, rope_cos, rope_sin)
            k = rope_interleaved(k, rope_cos, rope_sin)
        o = self.unheads(attention(q, k, v, kv_len=kv_len, stable=False))
        x = _gated_add(x, a.to_out(o[:, :seq_v]), g, tg, first_len)
        text = text + a.to_add_out(o[:, seq_v:]) * cg

        xn = _modulate(L.layer_norm(x, None, None, 1e-6), s2, sc2, ts2, tsc2, first_len)
        x = _gated_add(x, self.ff(xn), g2, tg2, first_len)
        tn = L.layer_norm(text, None, None, 1e-6) * (1 + csc2) + cs2
        return x, text + self.ff_context(tn) * cg2


class SingleBlock(_Heads):
    """Attention and MLP in parallel over [video; text], one fused output
    projection over ``[attention, silu(proj_mlp(xn))]``."""

    def __init__(self, cfg: HunyuanVideoTransformerConfig, device=None, dtype=None):
        super().__init__()
        dim, mlp = cfg.inner_dim, int(cfg.inner_dim * cfg.mlp_ratio)
        kw = dict(device=device, dtype=dtype)
        self.nh, self.hd = cfg.num_attention_heads, cfg.attention_head_dim
        self.norm_linear = L.Linear(dim, 3 * dim, **kw)
        self.attn = _JointAttention(dim, self.hd, False, **kw)
        self.proj_mlp = L.Linear(dim, mlp, **kw)
        self.proj_out = L.Linear(dim + mlp, dim, **kw)

    def forward(self, x, temb, temb_tr, kv_len, rope_cos, rope_sin, first_len):
        s, sc, g = _chunks(self.norm_linear(L.silu(temb)), 3)
        ts, tsc, tg = _chunks(None if temb_tr is None else self.norm_linear(L.silu(temb_tr)), 3)
        xn = _modulate(L.layer_norm(x, None, None, 1e-6), s, sc, ts, tsc, first_len)
        a = self.attn
        q, k, v = a.norm_q(self.heads(a.to_q(xn))), a.norm_k(self.heads(a.to_k(xn))), self.heads(a.to_v(xn))
        if rope_cos is not None:
            q = rope_interleaved(q, rope_cos, rope_sin)
            k = rope_interleaved(k, rope_cos, rope_sin)
        o = self.unheads(attention(q, k, v, kv_len=kv_len, stable=False))
        out = self.proj_out(torch.cat([o, L.silu(self.proj_mlp(xn))], dim=-1))
        return _gated_add(x, out, g, tg, first_len)


class _TimeTextEmbed(nn.Module):
    def __init__(self, cfg: HunyuanVideoTransformerConfig, device=None, dtype=None):
        super().__init__()
        dim = cfg.inner_dim
        kw = dict(device=device, dtype=dtype)
        self.timestep_embedder = L.TimestepEmbedding(256, dim, **kw)
        self.text_embedder = L.TimestepEmbedding(cfg.pooled_projection_dim, dim, **kw)
        if cfg.guidance_embeds:
            self.guidance_embedder = L.TimestepEmbedding(256, dim, **kw)

    def forward(self, timestep, pooled, guidance, dtype):
        temb = self.timestep_embedder(L.sinusoidal_timestep_embedding(timestep, 256).to(dtype))
        temb = temb + self.text_embedder(pooled.to(dtype))
        if guidance is not None and hasattr(self, "guidance_embedder"):
            temb = temb + self.guidance_embedder(L.sinusoidal_timestep_embedding(guidance, 256).to(dtype))
        return temb


class _NormOut(nn.Module):
    def __init__(self, dim: int, device=None, dtype=None):
        super().__init__()
        self.linear = L.Linear(dim, 2 * dim, device=device, dtype=dtype)


class HunyuanVideoTransformer(nn.Module):
    def __init__(self, cfg: HunyuanVideoTransformerConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        dim = cfg.inner_dim
        p, pt = cfg.patch_size, cfg.patch_size_t
        kw = dict(device=device, dtype=dtype)
        self.x_embedder = L.Linear(cfg.in_channels * pt * p * p, dim, **kw)
        self.context_embedder = TokenRefiner(cfg, **kw)
        self.time_text_embed = _TimeTextEmbed(cfg, **kw)
        self.norm_out = _NormOut(dim, **kw)  # AdaLayerNormContinuous (no affine norm)
        self.proj_out = L.Linear(dim, pt * p * p * cfg.out_channels, **kw)
        self.transformer_blocks = nn.ModuleList(DoubleBlock(cfg, **kw) for _ in range(cfg.num_layers))
        self.single_transformer_blocks = nn.ModuleList(SingleBlock(cfg, **kw) for _ in range(cfg.num_single_layers))

    def forward(self, hidden_states: torch.Tensor, timestep: torch.Tensor, encoder_hidden_states: torch.Tensor,
                encoder_attention_mask: Optional[torch.Tensor], pooled_projections: torch.Tensor,
                guidance: Optional[torch.Tensor] = None, rope_cos: Optional[np.ndarray] = None,
                rope_sin: Optional[np.ndarray] = None) -> torch.Tensor:
        """``hidden_states`` [B, C, F, h, w], ``timestep`` [B],
        ``encoder_hidden_states`` [B, S_text, text_embed_dim] (Llama),
        ``encoder_attention_mask`` [B, S_text] or None, ``pooled_projections``
        [B, pooled_projection_dim] (CLIP), ``guidance`` [B] =
        guidance_scale·1000 or None, ``rope_cos``/``rope_sin`` [S_video,
        head_dim] (numpy or tensor) -> the prediction [B, out_channels, F,
        h, w]."""
        cfg = self.cfg
        b, c, f, h, w = hidden_states.shape
        p, pt, hd = cfg.patch_size, cfg.patch_size_t, cfg.attention_head_dim
        dev = hidden_states.device

        # patchify: patches flattened in (C, pt, p, p) order
        x = hidden_states.reshape(b, c, f // pt, pt, h // p, p, w // p, p).permute(0, 2, 4, 6, 1, 3, 5, 7)
        seq_v = (f // pt) * (h // p) * (w // p)
        x = self.x_embedder(x.reshape(b, seq_v, c * pt * p * p))
        first_len = (h // p) * (w // p)

        temb = self.time_text_embed(timestep, pooled_projections, guidance, x.dtype)
        temb_tr = None
        if cfg.image_condition_type == "token_replace":
            temb_tr = self.time_text_embed(torch.zeros_like(timestep), pooled_projections, guidance, x.dtype)

        text = self.context_embedder(encoder_hidden_states.to(x.dtype), encoder_attention_mask, timestep)
        seq_t = text.shape[1]

        # joint [video; text] keys: the video whole, the text up to each prompt's length
        kv_len = None
        if encoder_attention_mask is not None:
            kv_len = (seq_v + encoder_attention_mask.sum(dim=1)).to(torch.int32)

        # rope tables padded with identity rows for the text suffix, once a forward
        rc = rs = None
        if rope_cos is not None:
            rc = torch.cat([torch.as_tensor(rope_cos, dtype=torch.float32, device=dev),
                            torch.ones((seq_t, hd), dtype=torch.float32, device=dev)]).contiguous()
            rs = torch.cat([torch.as_tensor(rope_sin, dtype=torch.float32, device=dev),
                            torch.zeros((seq_t, hd), dtype=torch.float32, device=dev)]).contiguous()

        ctx = (temb, temb_tr, kv_len)
        x, text = run_blocks(self.transformer_blocks, (x, text), ctx, (rc, rs, first_len))
        (joint,) = run_blocks(self.single_transformer_blocks, (torch.cat([x, text], dim=1),), ctx, (rc, rs, first_len))
        x = joint[:, :seq_v]

        # output head: the modulation's first half is the scale
        scale, shift = _chunks(self.norm_out.linear(L.silu(temb)), 2)
        x = self.proj_out(L.layer_norm(x, None, None, 1e-6) * (1 + scale) + shift)

        oc = cfg.out_channels
        x = x.reshape(b, f // pt, h // p, w // p, pt, p, p, oc).permute(0, 7, 1, 4, 2, 5, 3, 6)
        return x.reshape(b, oc, f, h, w)
