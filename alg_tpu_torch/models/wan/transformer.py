"""Wan 2.1 DiT (counterpart of ``alg_tpu/models/wan/transformer.py``).

diffusers ``WanTransformer3DModel`` as the I2V pipeline drives it: a
36-channel input (16 noisy latent + 4 mask + 16 conditioning latent
channels), cross-attention to the UMT5 text embeddings and to the
CLIP-vision image embeddings, and per-block ``scale_shift_table`` AdaLN
driven by one global 6-way time modulation.

Defaults = Wan2.1-I2V-14B-480P: dim 5120 (40 heads × 128), 40 layers, ffn
13,824, patch (1, 2, 2), freq_dim 256, image_dim 1280.

Block (diffusers ``WanTransformerBlock``):
  mod = scale_shift_table + time_proj(silu(temb))            # [B, 6, dim]
  x += gate · selfattn(LN₀(x)·(1+scale)+shift), RMS-normed q/k, 3-D RoPE
  x += crossattn(LN(x) → text kv) + crossattn(same q → image kv)
  x += c_gate · ffn(LN₀(x)·(1+c_scale)+c_shift)
LayerNorms compute in fp32. Per block the DiT launches the port's AdaLN
chain (``ops/ada_norm``) four times (the modulated norm; the gated residual
with ``norm2``; the cross-attention's residual with the modulated norm; the
MLP's gated residual), its rope kernel (``ops/rope``) on q and on k of the
self-attention and flash attention (``ops/flash_attention``,
``stable=False``) three times: self, text cross, image cross.

Under a recording profiler (``utils/profiling.py``) a forward is the spans
``dit.embed``, one ``dit.block`` a block (``block``: its place) and
``dit.final``, and a block's stages are spans named as the CogVideoX DiT
names the same work: ``block.norm`` (the modulation added in fp32, the
LayerNorms, scale and shift, and ``norm2``, with the residual adds before
``norm2`` and before the MLP's norm), ``block.attention`` (the
self-attention: ``attention.qkv`` with the q/k RMSNorm and the RoPE
launches, ``attention.kernel`` with its ``route``, ``attention.out``),
``block.ff`` and ``block.gate`` (the MLP's gated residual);
``attention.cross`` holds the whole text-plus-image cross-attention (its q,
both k/v projections and norms, both kernel launches, the sum and
``to_out``).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from alg_tpu_torch.models import layers as L
from alg_tpu_torch.models import rope as R
from alg_tpu_torch.ops.ada_norm import ada_norm
from alg_tpu_torch.ops.attention import attention
from alg_tpu_torch.ops.rope import rope_interleaved
from alg_tpu_torch.sharding.pipeline import run_blocks
from alg_tpu_torch.utils.profiling import span

_NO_SPAN = contextlib.nullcontext()


def _unrecorded(name: str):
    """What a stage of the cross-attention opens: nothing (its block records it as ``attention.cross``)."""
    return _NO_SPAN


@dataclasses.dataclass(frozen=True)
class WanTransformerConfig:
    num_attention_heads: int = 40
    attention_head_dim: int = 128
    in_channels: int = 36
    out_channels: int = 16
    num_layers: int = 40
    ffn_dim: int = 13824
    freq_dim: int = 256
    text_dim: int = 4096
    image_dim: Optional[int] = 1280  # None: T2V (no image cross-attention)
    patch_size: Tuple[int, int, int] = (1, 2, 2)
    eps: float = 1e-6
    rope_theta: float = 10000.0
    rope_max_seq_len: int = 1024

    @property
    def inner_dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim


def wan_rope(cfg: WanTransformerConfig, num_latent_frames: int, latent_height: int,
             latent_width: int) -> Tuple[np.ndarray, np.ndarray]:
    """(cos, sin) ``[S_video, head_dim]`` fp32: the head dim split over t/h/w
    as (d − 4⌊d/6⌋, 2⌊d/6⌋, 2⌊d/6⌋), adjacent features paired (the complex
    view of diffusers ``WanRotaryPosEmbed``)."""
    d = cfg.attention_head_dim
    pt, ph, pw = cfg.patch_size
    f, hh, ww = num_latent_frames // pt, latent_height // ph, latent_width // pw
    h_dim = w_dim = 2 * (d // 6)
    t_dim = d - h_dim - w_dim
    ang_t = R.rope_frequencies(t_dim, np.arange(f), cfg.rope_theta)
    ang_h = R.rope_frequencies(h_dim, np.arange(hh), cfg.rope_theta)
    ang_w = R.rope_frequencies(w_dim, np.arange(ww), cfg.rope_theta)
    shape = (f, hh, ww)
    angles = np.concatenate([
        np.broadcast_to(ang_t[:, None, None, :], shape + ang_t.shape[-1:]),
        np.broadcast_to(ang_h[None, :, None, :], shape + ang_h.shape[-1:]),
        np.broadcast_to(ang_w[None, None, :, :], shape + ang_w.shape[-1:]),
    ], axis=-1).reshape(f * hh * ww, d // 2)
    return R.cos_sin_interleaved(angles)


class WanAttention(nn.Module):
    """q/k RMS-normed over the full inner dim before the head split, RoPE
    after it (self-attention only); with ``image_stream`` a second key/value
    projection of the image tokens whose attention output is summed in."""

    def __init__(self, cfg: WanTransformerConfig, image_stream: bool = False, device=None, dtype=None):
        super().__init__()
        dim = cfg.inner_dim
        kw = dict(device=device, dtype=dtype)
        self.nh, self.hd = cfg.num_attention_heads, cfg.attention_head_dim
        self.to_q = L.Linear(dim, dim, **kw)
        self.to_k = L.Linear(dim, dim, **kw)
        self.to_v = L.Linear(dim, dim, **kw)
        self.to_out = L.Linear(dim, dim, **kw)
        self.norm_q = L.RMSNorm(dim, cfg.eps, **kw)
        self.norm_k = L.RMSNorm(dim, cfg.eps, **kw)
        if image_stream:
            self.add_k_proj = L.Linear(dim, dim, **kw)
            self.add_v_proj = L.Linear(dim, dim, **kw)
            self.norm_added_k = L.RMSNorm(dim, cfg.eps, **kw)

    def forward(self, q_in, kv_in, rope_cos=None, rope_sin=None, extra_kv=None):
        b, sq, _ = q_in.shape
        stage = span if rope_cos is not None else _unrecorded  # the self-attention's stages are spans

        def heads(x):  # [B, S, dim] -> a [B, H, S, D] view
            return x.view(b, -1, self.nh, self.hd).transpose(1, 2)

        with stage("attention.qkv"):
            qh = heads(self.norm_q(self.to_q(q_in)))
            kh = heads(self.norm_k(self.to_k(kv_in)))
            vh = heads(self.to_v(kv_in))
            if rope_cos is not None:
                qh = rope_interleaved(qh, rope_cos, rope_sin)
                kh = rope_interleaved(kh, rope_cos, rope_sin)
            else:
                qh = qh.contiguous()  # shared by the two cross-attentions
        with stage("attention.kernel"):
            out = attention(qh, kh, vh, stable=False)
        if extra_kv is not None:
            k_img = heads(self.norm_added_k(self.add_k_proj(extra_kv)))
            out = out + attention(qh, k_img, heads(self.add_v_proj(extra_kv)), stable=False)
        with stage("attention.out"):
            return self.to_out(out.transpose(1, 2).reshape(b, sq, -1))  # -1: H/tp heads under tensor parallelism


class WanBlock(nn.Module):
    def __init__(self, cfg: WanTransformerConfig, index: int = 0, device=None, dtype=None):
        super().__init__()
        self.index = index  # the block's place in the DiT, for its span
        dim = cfg.inner_dim
        kw = dict(device=device, dtype=dtype)
        self.eps = cfg.eps
        self.scale_shift_table = L.table((6, dim), dim ** -0.5, **kw)
        self.attn1 = WanAttention(cfg, **kw)
        self.attn2 = WanAttention(cfg, image_stream=cfg.image_dim is not None, **kw)
        self.norm2 = L.LayerNorm(dim, cfg.eps, **kw)  # cross_attn_norm: affine
        self.ffn = L.MLP(dim, cfg.ffn_dim, **kw)

    def forward(self, x, temb6, text, img, rope_cos, rope_sin):
        with span("dit.block", block=self.index):
            with span("block.norm"):
                # modulation added in fp32, then cast
                mod = self.scale_shift_table.float()[None] + temb6.float()
                shift, scale, gate, c_shift, c_scale, c_gate = (m.to(x.dtype) for m in mod.chunk(6, dim=1))
                _, xn = ada_norm((x,), scales=(scale,), shifts=(shift,), eps=self.eps)
            with span("block.attention"):
                o = self.attn1(xn, xn, rope_cos, rope_sin)
            with span("block.norm"):  # the gated residual and norm2, one launch
                (x,), xn = ada_norm((x,), o, gates=(gate,), weight=self.norm2.weight, bias=self.norm2.bias,
                                    eps=self.norm2.eps)
            with span("attention.cross"):
                o = self.attn2(xn, text, extra_kv=img)
            with span("block.norm"):  # the cross-attention's residual and the modulated norm, one launch
                (x,), xn = ada_norm((x,), o, scales=(c_scale,), shifts=(c_shift,), eps=self.eps)
            with span("block.ff"):
                o = self.ffn(xn)
            with span("block.gate"):
                (x,), _ = ada_norm((x,), o, gates=(c_gate,), norm=False)
                return x


class _TextEmbedder(nn.Module):
    def __init__(self, text_dim: int, dim: int, device=None, dtype=None):
        super().__init__()
        self.linear_1 = L.Linear(text_dim, dim, device=device, dtype=dtype)
        self.linear_2 = L.Linear(dim, dim, device=device, dtype=dtype)

    def forward(self, x):
        return self.linear_2(L.gelu_tanh(self.linear_1(x)))


class _ImageEmbedder(nn.Module):
    def __init__(self, image_dim: int, dim: int, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.norm1 = L.LayerNorm(image_dim, 1e-5, **kw)
        self.ff_in = L.Linear(image_dim, image_dim, **kw)
        self.ff_out = L.Linear(image_dim, dim, **kw)
        self.norm2 = L.LayerNorm(dim, 1e-5, **kw)

    def forward(self, x):
        return self.norm2(self.ff_out(L.gelu(self.ff_in(self.norm1(x)))))


class _ConditionEmbedder(nn.Module):
    def __init__(self, cfg: WanTransformerConfig, device=None, dtype=None):
        super().__init__()
        dim = cfg.inner_dim
        kw = dict(device=device, dtype=dtype)
        self.time_embedder = L.TimestepEmbedding(cfg.freq_dim, dim, **kw)
        self.time_proj = L.Linear(dim, 6 * dim, **kw)
        self.text_embedder = _TextEmbedder(cfg.text_dim, dim, **kw)
        if cfg.image_dim is not None:
            self.image_embedder = _ImageEmbedder(cfg.image_dim, dim, **kw)


class WanTransformer(nn.Module):
    def __init__(self, cfg: WanTransformerConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        dim = cfg.inner_dim
        pt, ph, pw = cfg.patch_size
        kw = dict(device=device, dtype=dtype)
        # conv3d with stride = kernel = patch, as a linear over flattened patches
        self.patch_embedding = L.Linear(cfg.in_channels * pt * ph * pw, dim, **kw)
        self.condition_embedder = _ConditionEmbedder(cfg, **kw)
        self.scale_shift_table = L.table((2, dim), dim ** -0.5, **kw)
        self.proj_out = L.Linear(dim, pt * ph * pw * cfg.out_channels, **kw)
        self.blocks = nn.ModuleList(WanBlock(cfg, i, **kw) for i in range(cfg.num_layers))

    def forward(self, hidden_states: torch.Tensor, timestep: torch.Tensor, encoder_hidden_states: torch.Tensor,
                encoder_hidden_states_image: Optional[torch.Tensor] = None,
                rope_cos: Optional[torch.Tensor] = None, rope_sin: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``hidden_states`` [B, C, F, h, w], ``timestep`` [B],
        ``encoder_hidden_states`` [B, S_text, text_dim],
        ``encoder_hidden_states_image`` [B, S_img, image_dim] or None,
        ``rope_cos``/``rope_sin`` [S_video, head_dim] -> the velocity
        prediction [B, out_channels, F, h, w]."""
        cfg = self.cfg
        b, c, f, h, w = hidden_states.shape
        pt, ph, pw = cfg.patch_size
        dim = cfg.inner_dim
        ce = self.condition_embedder

        with span("dit.embed"):
            # patchify: patches flattened in (C, pt, ph, pw) order
            x = hidden_states.reshape(b, c, f // pt, pt, h // ph, ph, w // pw, pw).permute(0, 2, 4, 6, 1, 3, 5, 7)
            x = self.patch_embedding(x.reshape(b, (f // pt) * (h // ph) * (w // pw), c * pt * ph * pw))

            t_freq = L.sinusoidal_timestep_embedding(timestep, cfg.freq_dim)
            temb = ce.time_embedder(t_freq.to(x.dtype))
            temb6 = ce.time_proj(L.silu(temb)).reshape(b, 6, dim)
            text = ce.text_embedder(encoder_hidden_states.to(x.dtype))
            img = None
            if encoder_hidden_states_image is not None and cfg.image_dim is not None:
                img = ce.image_embedder(encoder_hidden_states_image.to(x.dtype))

            rc = None if rope_cos is None else rope_cos.float().contiguous()
            rs = None if rope_sin is None else rope_sin.float().contiguous()
        (x,) = run_blocks(self.blocks, (x,), (temb6, text, img), (rc, rs))

        with span("dit.final"):
            # output head: shift/scale from temb (not silu'd) plus the table, added in fp32
            head = self.scale_shift_table.float()[None] + temb.float()[:, None]
            shift, scale = (m.to(x.dtype) for m in head.chunk(2, dim=1))
            x = L.layer_norm(x, None, None, cfg.eps) * (1 + scale) + shift
            x = self.proj_out(x)  # [B, S, pt·ph·pw·out]

            oc = cfg.out_channels
            x = x.reshape(b, f // pt, h // ph, w // pw, pt, ph, pw, oc).permute(0, 7, 1, 4, 2, 5, 3, 6)
            return x.reshape(b, oc, f, h, w)
