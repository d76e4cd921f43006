"""The Wan 2.1 I2V DiT in plain float32 PyTorch (diffusers ``WanTransformer3DModel``).

- Patch embedding: a conv3d with stride = kernel = ``patch_size``; tokens in
  (frame, row, column) order.
- Condition embedder: the sinusoidal time embedding (``flip_sin_to_cos``, no
  shift) through ``time_embedder`` (linear, SiLU, linear), its 6-way
  projection ``time_proj(silu(temb))``; the text embedder (linear, tanh GELU,
  linear); the image embedder (LayerNorm, linear, exact GELU, linear,
  LayerNorm, both norms eps 1e-5).
- Block (``WanTransformerBlock``): ``scale_shift_table + temb6`` gives shift,
  scale, gate, c_shift, c_scale, c_gate; ``x += gate·attn1(LN(x)·(1 + scale)
  + shift)`` with q and k RMS-normed over the whole inner dim, then rotated
  by the 3D RoPE; ``x += attn2(norm2(x))``, where the text and the image
  tokens each get their own keys and values (the image's normed by
  ``norm_added_k``) against one q, and the two attention outputs are summed
  before ``to_out``; ``x += c_gate·ffn(LN(x)·(1 + c_scale) + c_shift)`` with
  a tanh GELU. The affine-free LayerNorms take the model's ``eps``.
- RoPE (``WanRotaryPosEmbed``): the head dim split into ``d - 4⌊d/6⌋`` features
  over frames and ``2⌊d/6⌋`` each over rows and columns, adjacent features
  rotated as a pair (the complex view).
- Output: ``LN(x)·(1 + scale) + shift`` from ``scale_shift_table + temb``
  (``temb`` before the SiLU), ``proj_out``, unpatchified in
  (pt, ph, pw, C) order.

Departures: the image tokens come as their own tensor rather than as the
first 257 rows of one context (diffusers splits them off again, so the two
are the same computation); every CFG pass runs as its own batch of one;
attention is computed in blocks of query rows (``dit.attention``) so that
it fits on the card. ``lowp``: the control, as in ``dit.py``, with the
inputs of every product (the linears' activations and weights; q, k, v and
the probabilities) rounded to float8 e4m3, the patch convolution left exact.

Weights are read from ``w`` (published names, any float type) and cast to
float32 one tensor at a time.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.dit import _linear, _rope_1d, _rotate, _w, attention, timestep_embedding


def rope_tables(cfg: dict, frames: int, grid_h: int, grid_w: int, theta: float = 10000.0):
    """(cos, sin) ``[frames·grid_h·grid_w, head_dim]``, each angle repeated over its pair of features."""
    d = cfg["attention_head_dim"]
    h_dim = w_dim = 2 * (d // 6)
    t_dim = d - h_dim - w_dim
    parts = [(_rope_1d(t_dim, np.arange(frames), theta), (frames, 1, 1)),
             (_rope_1d(h_dim, np.arange(grid_h), theta), (1, grid_h, 1)),
             (_rope_1d(w_dim, np.arange(grid_w), theta), (1, 1, grid_w))]
    shape = (frames, grid_h, grid_w)

    def combine(k):
        full = np.concatenate([np.broadcast_to(tab[k].reshape(view + (-1,)), shape + (tab[k].shape[-1],))
                               for tab, view in parts], axis=-1)
        return torch.from_numpy(full.reshape(-1, d).astype(np.float32))

    return combine(0), combine(1)


def _rms(w, name, x, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * _w(w, f"{name}.weight", x.device)


def _ln(x, eps):
    return F.layer_norm(x, x.shape[-1:], eps=eps)


def _heads(x, heads):  # [1, S, H·D] -> [H, S, D]
    return x[0].unflatten(-1, (heads, -1)).transpose(0, 1)


def _attention(w, a, cfg, x, context, cos=None, sin=None, image=None, lowp=False):
    """``WanAttention`` of ``x`` ``[1, S, d]`` over ``context`` (and the image tokens, when given)."""
    heads, eps = cfg["num_attention_heads"], cfg["eps"]
    q = _heads(_rms(w, f"{a}.norm_q", _linear(w, f"{a}.to_q", x, lowp), eps), heads)
    k = _heads(_rms(w, f"{a}.norm_k", _linear(w, f"{a}.to_k", context, lowp), eps), heads)
    v = _heads(_linear(w, f"{a}.to_v", context, lowp), heads)
    if cos is not None:
        q, k = _rotate(q, cos, sin), _rotate(k, cos, sin)
    o = attention(q, k, v, lowp)
    if image is not None:
        k = _heads(_rms(w, f"{a}.norm_added_k", _linear(w, f"{a}.add_k_proj", image, lowp), eps), heads)
        v = _heads(_linear(w, f"{a}.add_v_proj", image, lowp), heads)
        o = o + attention(q, k, v, lowp)
    del q, k, v
    return _linear(w, f"{a}.to_out.0", o.transpose(0, 1).flatten(1)[None], lowp)


def _block(w, b, cfg, x, temb6, text, image, cos, sin, lowp):
    eps = cfg["eps"]
    mod = _w(w, f"{b}.scale_shift_table", x.device) + temb6
    shift, scale, gate, c_shift, c_scale, c_gate = mod.chunk(6, dim=1)
    xn = _ln(x, eps) * (1 + scale) + shift
    x = x + gate * _attention(w, f"{b}.attn1", cfg, xn, xn, cos, sin, lowp=lowp)
    xn = F.layer_norm(x, x.shape[-1:], _w(w, f"{b}.norm2.weight", x.device), _w(w, f"{b}.norm2.bias", x.device), eps)
    x = x + _attention(w, f"{b}.attn2", cfg, xn, text, image=image, lowp=lowp)
    ff = _linear(w, f"{b}.ffn.net.0.proj", _ln(x, eps) * (1 + c_scale) + c_shift, lowp)
    return x + c_gate * _linear(w, f"{b}.ffn.net.2", F.gelu(ff, approximate="tanh"), lowp)


@torch.no_grad()
def forward(w, cfg: dict, x: torch.Tensor, timestep: float, text: torch.Tensor, image, lowp: bool = False):
    """``x`` ``[1, C, F, H, W]`` (noisy latents ⧺ the 20-channel condition), ``text`` ``[1, S_text, text_dim]``,
    ``image`` ``[1, S_image, image_dim]`` or None -> the velocity ``[1, out_channels, F, H, W]``, all float32
    on ``x``'s device. ``lowp``: the control's float8 products."""
    dev = x.device
    _, _, f, h, wd = x.shape
    pt, ph, pw = cfg["patch_size"]
    dim = cfg["num_attention_heads"] * cfg["attention_head_dim"]
    gf, gh, gw = f // pt, h // ph, wd // pw
    y = F.conv3d(x.float(), _w(w, "patch_embedding.weight", dev), _w(w, "patch_embedding.bias", dev),
                 stride=(pt, ph, pw))
    hidden = y.flatten(2).transpose(1, 2)

    ce = "condition_embedder"
    t = torch.full((1,), float(timestep), device=dev)
    temb = _linear(w, f"{ce}.time_embedder.linear_2",
                   F.silu(_linear(w, f"{ce}.time_embedder.linear_1", timestep_embedding(t, cfg["freq_dim"]), lowp)),
                   lowp)
    temb6 = _linear(w, f"{ce}.time_proj", F.silu(temb), lowp).unflatten(1, (6, dim))
    text = _linear(w, f"{ce}.text_embedder.linear_2",
                   F.gelu(_linear(w, f"{ce}.text_embedder.linear_1", text.float(), lowp), approximate="tanh"), lowp)
    if image is not None:
        ie = f"{ce}.image_embedder"
        image = F.layer_norm(image.float(), image.shape[-1:], _w(w, f"{ie}.norm1.weight", dev),
                             _w(w, f"{ie}.norm1.bias", dev), 1e-5)
        image = _linear(w, f"{ie}.ff.net.2", F.gelu(_linear(w, f"{ie}.ff.net.0.proj", image, lowp)), lowp)
        image = F.layer_norm(image, image.shape[-1:], _w(w, f"{ie}.norm2.weight", dev), _w(w, f"{ie}.norm2.bias", dev),
                             1e-5)

    cos, sin = (a.to(dev) for a in rope_tables(cfg, gf, gh, gw, cfg.get("rope_theta", 10000.0)))
    for i in range(cfg["num_layers"]):
        hidden = _block(w, f"blocks.{i}", cfg, hidden, temb6, text, image, cos, sin, lowp)

    shift, scale = (_w(w, "scale_shift_table", dev) + temb[:, None]).chunk(2, dim=1)
    hidden = _ln(hidden, cfg["eps"]) * (1 + scale) + shift
    out = _linear(w, "proj_out", hidden, lowp)
    out = out.reshape(1, gf, gh, gw, pt, ph, pw, -1).permute(0, 7, 1, 4, 2, 5, 3, 6)
    return out.reshape(1, -1, f, h, wd)
