"""CogVideoX DiT (counterpart of ``alg_tpu/models/cogvideox/transformer.py``).

diffusers ``CogVideoXTransformer3DModel`` as CogVideoX-5b-I2V (defaults
below) and CogVideoX-1.5-5B-I2V use it: patchify plus a T5-text projection
into one joint [text; video] token stream, ``num_layers`` blocks of AdaLN-zero
modulation, joint self-attention with per-head LayerNorm on q/k and 3D RoPE
on the video tokens, and a shared gelu-tanh FFN; then the final norm, the
AdaLN head, a linear projection and unpatchify. 1.0 patchifies each frame
(a conv2d over ``(C, p, p)``); 1.5 (``patch_size_t`` set) takes temporal
patches of ``patch_size_t`` frames through a linear over ``(pt, p, p, C)``,
adds an ``ofs`` timestep embedding to the time embedding and positions its
RoPE on the "slice" grid.

Per block the DiT launches three CUDA kernels of the port: the AdaLN chain
(``ops/ada_norm``) three times (norm1 into the joint stream; the attention's
gated residual with norm2 into the MLP's joint input; the MLP's gated
residual), the fused qk LayerNorm + RoPE (``ops/qk_prep``) on q and on k,
and flash attention (``ops/flash_attention``) with ``stable=False``. A DiT
without RoPE normalises q and k with a plain LayerNorm and launches flash
attention alone, as ``alg_tpu`` does.

Under a recording profiler (``utils/profiling.py``) the forward is spans
``dit.embed``, one ``dit.block`` a block (``block`` its index) and
``dit.final``; a block's stages are ``block.norm`` (each AdaLN-zero
modulation with its norms; the second with the attention's gated
residuals), ``block.attention`` (``attention.qkv``, ``attention.kernel`` and
``attention.out``), ``block.ff`` (the MLP) and ``block.gate`` (the MLP's
gated residuals).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from alg_tpu_torch.models import layers as L
from alg_tpu_torch.models import rope as R
from alg_tpu_torch.ops.ada_norm import ada_norm
from alg_tpu_torch.ops.attention import attention
from alg_tpu_torch.ops.qk_prep import qk_norm_rope
from alg_tpu_torch.sharding.pipeline import run_blocks
from alg_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class CogVideoXTransformerConfig:
    """Defaults = CogVideoX-5b-I2V (1.0 layout: no temporal patch, no ofs)."""

    num_attention_heads: int = 48
    attention_head_dim: int = 64
    in_channels: int = 32  # 16 noisy latent + 16 image-condition channels
    out_channels: int = 16
    time_embed_dim: int = 512
    ofs_embed_dim: Optional[int] = None  # 512 for CogVideoX-1.5-I2V
    text_embed_dim: int = 4096
    num_layers: int = 42
    attention_bias: bool = True
    sample_width: int = 90
    sample_height: int = 60
    patch_size: int = 2
    patch_size_t: Optional[int] = None  # 2 for CogVideoX-1.5
    max_text_seq_length: int = 226
    norm_eps: float = 1e-5
    qk_norm_eps: float = 1e-6
    use_rotary_positional_embeddings: bool = True
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
    dim_t = d/4 over the ``ceil(F / patch_size_t)`` temporal patches, dim_h =
    dim_w = 3d/8 over the spatial grid. 1.0 positions the grid on the centred
    crop of the (sample_height/p, sample_width/p) base grid ("crop" grid
    type), 1.5 (``patch_size_t`` set) on its leading rows and columns
    ("slice")."""
    d, p = cfg.attention_head_dim, cfg.patch_size
    grid_h, grid_w = height // (8 * p), width // (8 * p)
    pt = cfg.patch_size_t or 1
    f = (num_latent_frames + pt - 1) // pt
    t_pos = np.arange(f, dtype=np.float64)
    if cfg.patch_size_t is None:
        (top, left), (bottom, right) = _resize_crop_region_for_grid(
            grid_h, grid_w, cfg.sample_height // p, cfg.sample_width // p)
        h_pos = np.linspace(top, bottom, grid_h, endpoint=False, dtype=np.float64)
        w_pos = np.linspace(left, right, grid_w, endpoint=False, dtype=np.float64)
    else:
        h_pos, w_pos = np.arange(grid_h, dtype=np.float64), np.arange(grid_w, dtype=np.float64)
    ang_t = R.rope_frequencies(d // 4, t_pos, cfg.rope_theta)
    ang_h = R.rope_frequencies(d // 8 * 3, h_pos, cfg.rope_theta)
    ang_w = R.rope_frequencies(d // 8 * 3, w_pos, cfg.rope_theta)
    shape = (f, grid_h, grid_w)
    angles = np.concatenate([
        np.broadcast_to(ang_t[:, None, None, :], shape + ang_t.shape[-1:]),
        np.broadcast_to(ang_h[None, :, None, :], shape + ang_h.shape[-1:]),
        np.broadcast_to(ang_w[None, None, :, :], shape + ang_w.shape[-1:]),
    ], axis=-1).reshape(f * grid_h * grid_w, d // 2)
    return R.cos_sin_interleaved(angles)


class AdaNormZero(nn.Module):
    """CogVideoXLayerNormZero: ``linear(silu(temb))`` -> 6 modulation vectors
    (shift, scale, gate for the video stream and for the text stream), then
    both streams' LayerNorm, modulated, as one joint [text; video] stream."""

    def __init__(self, time_dim: int, dim: int, eps: float, device=None, dtype=None):
        super().__init__()
        self.linear = L.Linear(time_dim, 6 * dim, device=device, dtype=dtype)
        self.norm = L.LayerNorm(dim, eps, device=device, dtype=dtype)

    def forward(self, encoder, hidden, temb, o=None, gates=None):
        """``(encoder, hidden, joint, (e_gate, gate))``: the text and video
        residuals, after ``o``'s rows times ``gates`` are added when given (the
        previous stage's gated residual, in the same launch); their modulated
        norms as one ``[B, T + S, d]`` stream; this modulation's two gates
        ``[B, 1, d]``."""
        shift, scale, gate, e_shift, e_scale, e_gate = (
            m[:, None] for m in self.linear(L.silu(temb)).chunk(6, dim=-1))
        (encoder, hidden), joint = ada_norm(
            (encoder, hidden), o, gates=gates, scales=(e_scale, scale), shifts=(e_shift, shift),
            weight=self.norm.weight, bias=self.norm.bias, eps=self.norm.eps)
        return encoder, hidden, joint, (e_gate, gate)


class JointAttention(nn.Module):
    def __init__(self, cfg: CogVideoXTransformerConfig, device=None, dtype=None):
        super().__init__()
        dim, hd = cfg.inner_dim, cfg.attention_head_dim
        kw = dict(device=device, dtype=dtype)
        self.to_q = L.Linear(dim, dim, bias=cfg.attention_bias, **kw)
        self.to_k = L.Linear(dim, dim, bias=cfg.attention_bias, **kw)
        self.to_v = L.Linear(dim, dim, bias=cfg.attention_bias, **kw)
        self.to_out = L.Linear(dim, dim, **kw)
        self.norm_q = L.LayerNorm(hd, cfg.qk_norm_eps, **kw)
        self.norm_k = L.LayerNorm(hd, cfg.qk_norm_eps, **kw)
        self.nh, self.hd = cfg.num_attention_heads, hd

    def forward(self, joint: torch.Tensor, rope_cos: Optional[torch.Tensor], rope_sin: Optional[torch.Tensor]):
        b, s, _ = joint.shape

        def heads(x):  # [B, H, S, D] as a view of the [B, S, H·D] projection
            return x.view(b, s, self.nh, self.hd).transpose(1, 2)

        def prep(x, norm):  # the kernel reads the view through its strides and writes a contiguous result
            if rope_cos is None:  # no RoPE: the LayerNorm alone, in PyTorch ops as alg_tpu runs it
                return norm(heads(x)).contiguous()
            return qk_norm_rope(heads(x), norm.weight.float(), norm.bias.float(), rope_cos, rope_sin, norm.eps)

        with span("attention.qkv"):
            q = prep(self.to_q(joint), self.norm_q)
            k = prep(self.to_k(joint), self.norm_k)
            v = heads(self.to_v(joint)).contiguous()
        with span("attention.kernel"):
            o = attention(q, k, v, stable=False)
        with span("attention.out"):
            return self.to_out(o.transpose(1, 2).reshape(b, s, -1))  # -1: H/tp heads under tensor parallelism


class CogVideoXBlock(nn.Module):
    def __init__(self, cfg: CogVideoXTransformerConfig, index: int = 0, device=None, dtype=None):
        super().__init__()
        self.index = index  # the block's place in the DiT, for its span
        kw = dict(device=device, dtype=dtype)
        self.norm1 = AdaNormZero(cfg.time_embed_dim, cfg.inner_dim, cfg.norm_eps, **kw)
        self.attn = JointAttention(cfg, **kw)
        self.norm2 = AdaNormZero(cfg.time_embed_dim, cfg.inner_dim, cfg.norm_eps, **kw)
        self.ff = L.MLP(cfg.inner_dim, 4 * cfg.inner_dim, **kw)

    def forward(self, hidden, encoder, temb, rope_cos, rope_sin):
        with span("dit.block", block=self.index):
            with span("block.norm"):
                encoder, hidden, joint, gates = self.norm1(encoder, hidden, temb)
            with span("block.attention"):
                o = self.attn(joint, rope_cos, rope_sin)
            with span("block.norm"):  # the attention's gated residual and norm2, one launch
                encoder, hidden, joint, gates = self.norm2(encoder, hidden, temb, o, gates)
            with span("block.ff"):
                ff = self.ff(joint)
            with span("block.gate"):
                (encoder, hidden), _ = ada_norm((encoder, hidden), ff, gates=gates, norm=False)
                return hidden, encoder


class CogVideoXTransformer(nn.Module):
    def __init__(self, cfg: CogVideoXTransformerConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        dim, p, pt = cfg.inner_dim, cfg.patch_size, cfg.patch_size_t or 1
        kw = dict(device=device, dtype=dtype)
        self.patch_embed = nn.ModuleDict({
            # 1.0: a conv2d with stride = kernel = p, as a linear over flattened patches; 1.5: a linear
            "proj": L.Linear(cfg.in_channels * pt * p * p, dim, **kw),
            "text_proj": L.Linear(cfg.text_embed_dim, dim, **kw),
        })
        self.time_embedding = L.TimestepEmbedding(dim, cfg.time_embed_dim, **kw)
        if cfg.ofs_embed_dim is not None:
            self.ofs_embedding = L.TimestepEmbedding(cfg.ofs_embed_dim, cfg.ofs_embed_dim, **kw)
        self.norm_final = L.LayerNorm(dim, cfg.norm_eps, **kw)
        self.norm_out = nn.ModuleDict({
            "linear": L.Linear(cfg.time_embed_dim, 2 * dim, **kw),
            "norm": L.LayerNorm(dim, cfg.norm_eps, **kw),
        })
        self.proj_out = L.Linear(dim, pt * p * p * cfg.out_channels, **kw)
        self.blocks = nn.ModuleList(CogVideoXBlock(cfg, i, **kw) for i in range(cfg.num_layers))

    def forward(self, hidden_states: torch.Tensor, encoder_hidden_states: torch.Tensor,
                timestep: torch.Tensor, rope_cos: Optional[torch.Tensor] = None,
                rope_sin: Optional[torch.Tensor] = None, ofs: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``hidden_states`` [B, F, C, H, W] (latents ⧺ image condition),
        ``encoder_hidden_states`` [B, S_text, text_dim], ``timestep`` [B],
        ``rope_cos``/``rope_sin`` [S_video, head_dim] fp32 (None without
        RoPE), ``ofs`` [1] or [B] (1.5; its embedding is added to the time
        embedding when given) -> [B, F, out_c, H, W]. With ``patch_size_t``
        set F must be a multiple of it (the pipeline pads to one)."""
        cfg = self.cfg
        b, f, c, h, w = hidden_states.shape
        p, pt = cfg.patch_size, cfg.patch_size_t
        if pt is not None and f % pt:
            raise ValueError(f"{f} latent frames are not a multiple of the DiT's patch_size_t {pt}")

        with span("dit.embed"):
            t_emb = L.sinusoidal_timestep_embedding(timestep, cfg.inner_dim)
            temb = self.time_embedding(t_emb.to(hidden_states.dtype))
            if cfg.ofs_embed_dim is not None and ofs is not None:
                ofs_emb = L.sinusoidal_timestep_embedding(ofs, cfg.ofs_embed_dim)
                temb = temb + self.ofs_embedding(ofs_emb.to(hidden_states.dtype))

            # patchify, in the minor order of the checkpoint's patch embed: 1.0 [B, F·H/p·W/p, C·p·p] (conv2d
            # weight order), 1.5 [B, F/pt·H/p·W/p, pt·p·p·C] (CogVideoXPatchEmbed's linear)
            if pt is None:
                x = hidden_states.reshape(b, f, c, h // p, p, w // p, p).permute(0, 1, 3, 5, 2, 4, 6)
                x = x.reshape(b, f * (h // p) * (w // p), c * p * p)
            else:
                x = hidden_states.permute(0, 1, 3, 4, 2).reshape(b, f // pt, pt, h // p, p, w // p, p, c)
                x = x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(b, (f // pt) * (h // p) * (w // p), pt * p * p * c)
            video = self.patch_embed["proj"](x)
            text = self.patch_embed["text_proj"](encoder_hidden_states.to(video.dtype))

            # identity rope rows over the text prefix: RoPE then covers the whole
            # joint stream and leaves the text tokens as they are
            text_len, d = text.shape[1], cfg.attention_head_dim
            rc = rs = None
            if rope_cos is not None:
                rc = torch.cat([rope_cos.new_ones(text_len, d), rope_cos.float()]).contiguous()
                rs = torch.cat([rope_sin.new_zeros(text_len, d), rope_sin.float()]).contiguous()

        video, text = run_blocks(self.blocks, (video, text), (temb,), (rc, rs))

        with span("dit.final"):
            video = self.norm_final(torch.cat([text, video], dim=1))[:, text_len:]
            shift, scale = self.norm_out["linear"](L.silu(temb)).chunk(2, dim=-1)
            video = self.norm_out["norm"](video) * (1 + scale[:, None]) + shift[:, None]
            out = self.proj_out(video)  # [B, S, (pt·)out_c·p·p]

            # unpatchify: proj_out's minor order is (C, p, p) in 1.0, (C, pt, p, p) in 1.5
            oc = cfg.out_channels
            if pt is None:
                out = out.reshape(b, f, h // p, w // p, oc, p, p).permute(0, 1, 4, 2, 5, 3, 6)
            else:
                out = out.reshape(b, f // pt, h // p, w // p, oc, pt, p, p).permute(0, 1, 5, 4, 2, 6, 3, 7)
            return out.reshape(b, f, oc, h, w)
