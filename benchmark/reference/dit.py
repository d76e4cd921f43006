"""The CogVideoX DiT in plain float32 PyTorch (diffusers ``CogVideoXTransformer3DModel``).

1.0 (CogVideoX-5b-I2V): a conv2d patch embed, 3D RoPE on the "crop" grid. 1.5
(``patch_size_t`` set): a linear patch embed over ``(pt, p, p, C)`` patches,
the ``ofs`` embedding added to the time embedding, RoPE on the "slice" grid.
One departure: no learned positional embedding (see the configuration files).

``lowp``: the control, the same computation with the inputs of every product
(the linears' activations and weights, the 1.0 patch convolution left
exact; q, k, v and the attention probabilities) rounded to float8 e4m3 with one scale per tensor (per query row
for the probabilities), accumulation in float32: the step below bf16 that a
later change would take on this card.

Weights are read from ``w`` (published names, any float type) and cast to
float32 one block at a time. Each CFG pass runs as its own batch row.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

ATTN_BLOCK_BYTES = 1 << 31  # the largest [heads, rows, keys] float32 score block


def _w(w, name, device):
    return w[name].to(device=device, dtype=torch.float32)


FP8_MAX = 448.0  # the largest float8 e4m3 value


def fp8(x: torch.Tensor, dim=None) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with an absmax scale (per tensor, or along ``dim``), back in float32."""
    amax = x.abs().amax() if dim is None else x.abs().amax(dim=dim, keepdim=True)
    scale = torch.where(amax > 0, amax / FP8_MAX, torch.ones_like(amax))
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def _q(x, lowp, dim=None):
    return fp8(x, dim) if lowp else x


def _linear(w, name, x, lowp=False):
    return F.linear(_q(x, lowp), _q(_w(w, f"{name}.weight", x.device), lowp),
                    _w(w, f"{name}.bias", x.device) if f"{name}.bias" in w else None)


def _layer_norm(w, name, x, eps):
    return F.layer_norm(x, x.shape[-1:], _w(w, f"{name}.weight", x.device), _w(w, f"{name}.bias", x.device), eps)


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """diffusers ``get_timestep_embedding`` with flip_sin_to_cos=True, downscale_freq_shift=0."""
    half = dim // 2
    exponent = -math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=t.device) / half
    emb = t.float()[:, None] * torch.exp(exponent)[None, :]
    return torch.cat([torch.cos(emb), torch.sin(emb)], dim=-1)


def _rope_1d(dim: int, pos: np.ndarray, theta: float):
    freqs = 1.0 / theta ** (np.arange(0, dim, 2)[: dim // 2].astype(np.float64) / dim)
    ang = np.outer(pos.astype(np.float64), freqs)
    return np.repeat(np.cos(ang), 2, axis=1), np.repeat(np.sin(ang), 2, axis=1)


def rope_tables(cfg: dict, grid_h: int, grid_w: int, frames: int, theta: float = 10000.0):
    """diffusers ``get_3d_rotary_pos_embed`` as the I2V pipeline calls it: (cos, sin) ``[F·gh·gw, head_dim]``."""
    d, p = cfg["attention_head_dim"], cfg["patch_size"]
    if cfg.get("patch_size_t") is None:
        th, tw = cfg["sample_height"] // p, cfg["sample_width"] // p  # get_resize_crop_region_for_grid
        if grid_h / grid_w > th / tw:
            rh, rw = th, int(round(th / grid_h * grid_w))
        else:
            rw, rh = tw, int(round(tw / grid_w * grid_h))
        top, left = int(round((th - rh) / 2.0)), int(round((tw - rw) / 2.0))
        pos_h = np.linspace(top, top + rh, grid_h, endpoint=False)
        pos_w = np.linspace(left, left + rw, grid_w, endpoint=False)
    else:
        pos_h, pos_w = np.arange(grid_h), np.arange(grid_w)
    pos_t = np.arange(frames)
    tc, ts = _rope_1d(d // 4, pos_t, theta)
    hc, hs = _rope_1d(d // 8 * 3, pos_h, theta)
    wc, ws = _rope_1d(d // 8 * 3, pos_w, theta)

    def combine(t, h, w_):
        shape = (frames, grid_h, grid_w)
        full = np.concatenate([np.broadcast_to(t[:, None, None], shape + t.shape[-1:]),
                               np.broadcast_to(h[None, :, None], shape + h.shape[-1:]),
                               np.broadcast_to(w_[None, None, :], shape + w_.shape[-1:])], axis=-1)
        return torch.from_numpy(full.reshape(-1, d).astype(np.float32))

    return combine(tc, hc, wc), combine(ts, hs, ws)


def _rotate(x, cos, sin):
    pairs = x.unflatten(-1, (-1, 2))
    rot = torch.stack((-pairs[..., 1], pairs[..., 0]), dim=-1).flatten(-2)
    return x * cos + rot * sin


def attention(q, k, v, lowp=False):
    """softmax(q kᵀ / √D) v over ``[H, S, D]``, in blocks of query rows."""
    h, s, d = q.shape
    rows = max(16, min(s, ATTN_BLOCK_BYTES // (4 * h * k.shape[1])))
    out = torch.empty_like(q)
    q, kt, v = _q(q, lowp), _q(k, lowp).transpose(1, 2), _q(v, lowp)
    for r in range(0, s, rows):
        scores = torch.matmul(q[:, r:r + rows], kt).mul_(d ** -0.5)
        out[:, r:r + rows] = torch.matmul(_q(torch.softmax(scores, dim=-1), lowp, dim=-1), v)
        del scores
    return out


def _block(w, b, cfg, hidden, encoder, temb, cos, sin, lowp):
    """One ``CogVideoXBlock`` on a batch of one."""
    heads, hd = cfg["num_attention_heads"], cfg["attention_head_dim"]
    text_len = encoder.shape[1]
    eps = cfg.get("norm_eps", 1e-5)

    def norm_zero(nm, hidden, encoder):
        mod = _linear(w, f"{b}.{nm}.linear", F.silu(temb), lowp)
        shift, scale, gate, e_shift, e_scale, e_gate = mod.chunk(6, dim=1)
        hn = _layer_norm(w, f"{b}.{nm}.norm", hidden, eps) * (1 + scale[:, None]) + shift[:, None]
        en = _layer_norm(w, f"{b}.{nm}.norm", encoder, eps) * (1 + e_scale[:, None]) + e_shift[:, None]
        return hn, en, gate[:, None], e_gate[:, None]

    hn, en, gate, e_gate = norm_zero("norm1", hidden, encoder)
    joint = torch.cat([en, hn], dim=1)
    s = joint.shape[1]

    def proj(nm):
        return _linear(w, f"{b}.attn1.{nm}", joint, lowp)[0].view(s, heads, hd).transpose(0, 1)

    q = _layer_norm(w, f"{b}.attn1.norm_q", proj("to_q"), 1e-6)
    k = _layer_norm(w, f"{b}.attn1.norm_k", proj("to_k"), 1e-6)
    v = proj("to_v")
    if cos is not None:
        q = torch.cat([q[:, :text_len], _rotate(q[:, text_len:], cos, sin)], dim=1)
        k = torch.cat([k[:, :text_len], _rotate(k[:, text_len:], cos, sin)], dim=1)
    o = attention(q, k, v, lowp).transpose(0, 1).reshape(1, s, heads * hd)
    del q, k, v
    o = _linear(w, f"{b}.attn1.to_out.0", o, lowp)
    hidden = hidden + gate * o[:, text_len:]
    encoder = encoder + e_gate * o[:, :text_len]
    hn, en, gate, e_gate = norm_zero("norm2", hidden, encoder)
    ff = _linear(w, f"{b}.ff.net.0.proj", torch.cat([en, hn], dim=1), lowp)
    ff = _linear(w, f"{b}.ff.net.2", F.gelu(ff, approximate="tanh"), lowp)
    return hidden + gate * ff[:, text_len:], encoder + e_gate * ff[:, :text_len]


@torch.no_grad()
def forward(w, cfg: dict, x: torch.Tensor, text: torch.Tensor, timestep: float, ofs=None,
            lowp: bool = False) -> torch.Tensor:
    """``x`` ``[1, F, C, H, W]`` (noisy latents ⧺ image condition), ``text`` ``[1, S_text, text_dim]``
    -> the model output ``[1, F, out_channels, H, W]``, all float32 on ``x``'s device. ``lowp``: the
    control's float8 products."""
    dev = x.device
    _, f, c, h, wd = x.shape
    p, pt = cfg["patch_size"], cfg.get("patch_size_t")
    dim = cfg["num_attention_heads"] * cfg["attention_head_dim"]
    eps = cfg.get("norm_eps", 1e-5)

    t = torch.full((1,), float(timestep), device=dev)
    temb = _linear(w, "time_embedding.linear_2",
                   F.silu(_linear(w, "time_embedding.linear_1", timestep_embedding(t, dim), lowp)), lowp)
    if cfg.get("ofs_embed_dim") is not None:
        o = timestep_embedding(torch.full((1,), float(ofs), device=dev), cfg["ofs_embed_dim"])
        o = F.silu(_linear(w, "ofs_embedding.linear_1", o, lowp))
        temb = temb + _linear(w, "ofs_embedding.linear_2", o, lowp)

    encoder = _linear(w, "patch_embed.text_proj", text, lowp)
    if pt is None:  # CogVideoXPatchEmbed: conv2d per frame, tokens in (frame, row, column) order
        y = F.conv2d(x.reshape(f, c, h, wd), _w(w, "patch_embed.proj.weight", dev), _w(w, "patch_embed.proj.bias", dev),
                     stride=p)
        hidden = y.flatten(2).transpose(1, 2).reshape(1, -1, dim)
        frames = f
    else:
        y = x.permute(0, 1, 3, 4, 2).reshape(1, f // pt, pt, h // p, p, wd // p, p, c)
        y = y.permute(0, 1, 3, 5, 2, 4, 6, 7).flatten(4, 7).flatten(1, 3)  # (pt, p, p, C) patches
        hidden = _linear(w, "patch_embed.proj", y, lowp)
        frames = (f + pt - 1) // pt

    cos = sin = None
    if cfg.get("use_rotary_positional_embeddings", True):
        cos, sin = (a.to(dev) for a in rope_tables(cfg, h // p, wd // p, frames))
    for i in range(cfg["num_layers"]):
        hidden, encoder = _block(w, f"transformer_blocks.{i}", cfg, hidden, encoder, temb, cos, sin, lowp)

    text_len = encoder.shape[1]
    hidden = _layer_norm(w, "norm_final", torch.cat([encoder, hidden], dim=1), eps)[:, text_len:]
    shift, scale = _linear(w, "norm_out.linear", F.silu(temb), lowp).chunk(2, dim=1)
    hidden = _layer_norm(w, "norm_out.norm", hidden, eps) * (1 + scale[:, None]) + shift[:, None]
    out = _linear(w, "proj_out", hidden, lowp)
    if pt is None:
        out = out.reshape(1, f, h // p, wd // p, -1, p, p).permute(0, 1, 4, 2, 5, 3, 6).flatten(5, 6).flatten(3, 4)
    else:
        out = out.reshape(1, frames, h // p, wd // p, -1, pt, p, p)
        out = out.permute(0, 1, 5, 4, 2, 6, 3, 7).flatten(6, 7).flatten(4, 5).flatten(1, 2)
    return out
