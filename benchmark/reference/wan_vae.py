"""The Wan 2.1 VAE's condition encode in plain float32 PyTorch (diffusers ``AutoencoderKLWan`` encoder,
as ``WanImageToVideoPipeline.prepare_latents`` uses it).

- Encoder: causal 3D convolutions (``k_t - 1`` zero frames in front,
  symmetric zero spatial padding); ResNet blocks of channel RMS norm
  (``F.normalize`` over the channels ``·√C·γ``), SiLU and convolution; after
  each stage but the last a zero pad of one column right and one row below
  and a stride-2 3×3 convolution per frame, in the stages that
  ``temperal_downsample`` names preceded by a stride-2 ``(3, 1, 1)`` temporal
  convolution; a mid block of two ResNets around a one-head self-attention
  over each frame's positions; RMS norm, SiLU, the output convolution and
  ``quant_conv``. The condition takes the posterior's mode (its mean).
- The condition (``prepare_latents``): the first frame followed by
  ``num_frames - 1`` zero frames, encoded, normalised by the per-channel
  ``latents_mean`` and ``latents_std``; in front of it 4 mask channels, one
  on every channel of the first latent frame (the conditioned pixel frame,
  repeated 4 times and folded into channels by 4) and zero elsewhere.

Departures, both the program's:

- diffusers encodes the clip as its first frame and then chunks of 4 frames,
  each causal convolution carrying its last frames over in a cache, which
  gives the same numbers as one pass over the whole clip except in the
  temporal downsample: there (as read from diffusers' ``WanResample``) the
  first frame is passed on without the temporal convolution, and the
  spatial convolution runs before the temporal one. This reference, like
  the program, runs the whole clip at once: the temporal convolution with
  two zero frames in front of the first, then the spatial one.
- diffusers' I2V pipeline encodes the condition video whole. The program
  encodes a clip of more than 8·480·720 frame pixels through overlapping
  256-pixel tiles at a stride of 192, one after another, and blends the
  latent seams (``tiled``, the same arithmetic as diffusers'
  ``tiled_encode``); this reference does the same for such a clip.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

TILE_PX, STRIDE_PX = 256, 192  # the program's encode tiles and their stride, in pixels


def _p(w, name, device):
    return w[name].to(device=device, dtype=torch.float32)


def _causal_conv(w, name, x, stride=(1, 1, 1)):
    weight, bias = _p(w, f"{name}.weight", x.device), _p(w, f"{name}.bias", x.device)
    kt, kh, kw = weight.shape[2:]
    return F.conv3d(F.pad(x, (kw // 2, kw // 2, kh // 2, kh // 2, kt - 1, 0)), weight, bias, stride=stride)


def _rms(w, name, x):
    gamma = _p(w, f"{name}.gamma", x.device).reshape(1, -1, *([1] * (x.dim() - 2)))
    return F.normalize(x, dim=1) * x.shape[1] ** 0.5 * gamma


def _resnet(w, name, x):
    h = _causal_conv(w, f"{name}.conv1", F.silu(_rms(w, f"{name}.norm1", x)))
    h = _causal_conv(w, f"{name}.conv2", F.silu(_rms(w, f"{name}.norm2", h)))
    if f"{name}.conv_shortcut.weight" in w:
        x = _causal_conv(w, f"{name}.conv_shortcut", x)
    return x + h


def _per_frame(x, fn):
    """``fn`` over each frame of ``[B, C, F, H, W]`` as a ``[B·F, C, H, W]`` batch."""
    b, c, f = x.shape[:3]
    y = fn(x.transpose(1, 2).reshape(b * f, c, *x.shape[3:]))
    return y.reshape(b, f, *y.shape[1:]).transpose(1, 2)


def _downsample(w, name, x):
    if f"{name}.time_conv.weight" in w:
        x = _causal_conv(w, f"{name}.time_conv", x, stride=(2, 1, 1))
    weight, bias = _p(w, f"{name}.resample.1.weight", x.device), _p(w, f"{name}.resample.1.bias", x.device)
    return _per_frame(x, lambda y: F.conv2d(F.pad(y, (0, 1, 0, 1)), weight, bias, stride=2))


def _attention(w, name, x):
    """One head over each frame's ``H·W`` positions, from 1×1 convolutions; residual added."""
    b, c, f, h, wd = x.shape

    def frame(y):
        y = _rms(w, f"{name}.norm", y)
        qkv = F.conv2d(y, _p(w, f"{name}.to_qkv.weight", y.device), _p(w, f"{name}.to_qkv.bias", y.device))
        q, k, v = qkv.flatten(2).transpose(1, 2).chunk(3, dim=-1)  # [B·F, H·W, C] each
        o = torch.softmax(q @ k.transpose(1, 2) * c ** -0.5, dim=-1) @ v
        o = o.transpose(1, 2).reshape(-1, c, h, wd)
        return F.conv2d(o, _p(w, f"{name}.proj.weight", y.device), _p(w, f"{name}.proj.bias", y.device))

    return x + _per_frame(x, frame)


@torch.no_grad()
def encode_mean(w, cfg: dict, video: torch.Tensor) -> torch.Tensor:
    """``video`` ``[1, 3, F, H, W]`` in [-1, 1] -> the posterior's mean ``[1, z_dim, F', H/8, W/8]``."""
    h = _causal_conv(w, "encoder.conv_in", video.float())
    idx = 0
    n_stages = len(cfg["dim_mult"])
    for i in range(n_stages):
        for _ in range(cfg["num_res_blocks"]):
            h = _resnet(w, f"encoder.down_blocks.{idx}", h)
            idx += 1
        if i < n_stages - 1:
            h = _downsample(w, f"encoder.down_blocks.{idx}", h)
            idx += 1
    h = _resnet(w, "encoder.mid_block.resnets.0", h)
    h = _attention(w, "encoder.mid_block.attentions.0", h)
    h = _resnet(w, "encoder.mid_block.resnets.1", h)
    h = _causal_conv(w, "encoder.conv_out", F.silu(_rms(w, "encoder.norm_out", h)))
    return _causal_conv(w, "quant_conv", h)[:, :cfg["z_dim"]]


def _blend(prev: torch.Tensor, cur: torch.Tensor, extent: int, dim: int) -> torch.Tensor:
    """``cur`` with its first ``extent`` rows along ``dim`` ramped from ``prev``'s last ones:
    ``prev[S + i]·(1 - i/E) + cur[i]·(i/E)``."""
    extent = min(prev.shape[dim], cur.shape[dim], extent)
    ramp = (torch.arange(extent, dtype=torch.float32, device=cur.device) / extent).reshape(
        [-1 if d == dim else 1 for d in range(cur.dim())])
    head = prev.narrow(dim, prev.shape[dim] - extent, extent) * (1 - ramp) + cur.narrow(dim, 0, extent) * ramp
    return torch.cat([head, cur.narrow(dim, extent, cur.shape[dim] - extent)], dim=dim)


@torch.no_grad()
def encode_mean_tiled(w, cfg: dict, video: torch.Tensor, tile: int = TILE_PX, stride: int = STRIDE_PX):
    """:func:`encode_mean` through overlapping ``tile``² windows at ``stride``, their latents blended
    over the overlap and cropped to the stride, then to the whole clip's latent size."""
    scale = 2 ** (len(cfg["dim_mult"]) - 1)
    _, _, _, h, wd = video.shape
    if h <= tile and wd <= tile:
        return encode_mean(w, cfg, video)
    rows = [[encode_mean(w, cfg, video[..., i:i + tile, j:j + tile]) for j in range(0, wd, stride)]
            for i in range(0, h, stride)]
    overlap, step = (tile - stride) // scale, stride // scale
    out_rows = []
    for i, row in enumerate(rows):
        cropped = []
        for j, t in enumerate(row):
            if i > 0:
                t = _blend(rows[i - 1][j], t, overlap, 3)
            if j > 0:
                t = _blend(row[j - 1], t, overlap, 4)
            cropped.append(t[..., :step, :step])
        out_rows.append(torch.cat(cropped, dim=4))
    return torch.cat(out_rows, dim=3)[..., :-(-h // scale), :-(-wd // scale)]


def tiles_the_condition(num_frames: int, height: int, width: int) -> bool:
    """Whether the program encodes this condition video through tiles: a clip of more than one
    frame and more than 8·480·720 frame pixels."""
    return num_frames > 1 and num_frames * height * width > 8 * 480 * 720


@torch.no_grad()
def condition(w, cfg: dict, image: torch.Tensor, num_frames: int, tiled=None) -> torch.Tensor:
    """``image`` ``[1, 3, H, W]`` in [-1, 1] -> the 20-channel condition ``[1, 4 + z_dim, F', H/8, W/8]``:
    the mask, then the normalised mean of the condition video's encode. ``tiled``: True or False
    encodes through tiles or whole; None as the program decides (:func:`tiles_the_condition`)."""
    video = torch.cat([image[:, :, None].float(),
                       image.new_zeros((1, 3, num_frames - 1) + tuple(image.shape[2:]), dtype=torch.float32)], dim=2)
    if tiled is None:
        tiled = tiles_the_condition(num_frames, image.shape[2], image.shape[3])
    z = encode_mean_tiled(w, cfg, video) if tiled else encode_mean(w, cfg, video)
    mean = torch.tensor(cfg["latents_mean"], dtype=torch.float32, device=z.device).view(1, -1, 1, 1, 1)
    std = torch.tensor(cfg["latents_std"], dtype=torch.float32, device=z.device).view(1, -1, 1, 1, 1)
    z = (z - mean) / std
    mask = torch.zeros((1, 4) + tuple(z.shape[2:]), dtype=torch.float32, device=z.device)
    mask[:, :, 0] = 1.0
    return torch.cat([mask, z], dim=1)
