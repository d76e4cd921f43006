"""Spatially tiled VAE encode/decode with overlap blending (counterpart of
``alg_tpu/models/vae_tiling.py``; tiles run one after another).

diffusers' ``tiled_decode`` assembly: tiles at stride S with size T; each
tile blends its top rows with the tile above and its left columns with the
tile to its left, ``out[i] = prev[S+i]·(1 - i/O) + cur[i]·(i/O)``; tiles are
cropped to the stride, concatenated, and the result cropped to the exact
output size. Layout is channels-last ``[B, F, H, W, C]``.
"""

from __future__ import annotations

from typing import Callable

import torch


def blend_v(a: torch.Tensor, b: torch.Tensor, extent: int) -> torch.Tensor:
    """Blend ``a``'s bottom rows into ``b``'s top rows (H = dim 2)."""
    extent = min(a.shape[2], b.shape[2], extent)
    t = (torch.arange(extent, dtype=torch.float32, device=b.device) / extent)[None, None, :, None, None]
    top = a[:, :, -extent:].float() * (1 - t) + b[:, :, :extent].float() * t
    return torch.cat([top.to(b.dtype), b[:, :, extent:]], dim=2)


def blend_h(a: torch.Tensor, b: torch.Tensor, extent: int) -> torch.Tensor:
    """Blend ``a``'s right columns into ``b``'s left columns (W = dim 3)."""
    extent = min(a.shape[3], b.shape[3], extent)
    t = (torch.arange(extent, dtype=torch.float32, device=b.device) / extent)[None, None, None, :, None]
    left = a[:, :, :, -extent:].float() * (1 - t) + b[:, :, :, :extent].float() * t
    return torch.cat([left.to(b.dtype), b[:, :, :, extent:]], dim=3)


def _assemble(rows, overlap: int, stride: int) -> torch.Tensor:
    out_rows = []
    for i, row in enumerate(rows):
        cropped = []
        for j, tile in enumerate(row):
            if i > 0:
                tile = blend_v(rows[i - 1][j], tile, overlap)
            if j > 0:
                tile = blend_h(row[j - 1], tile, overlap)
            cropped.append(tile[:, :, :stride, :stride])
        out_rows.append(torch.cat(cropped, dim=3))
    return torch.cat(out_rows, dim=2)


def tiled_decode(decode_fn: Callable[[torch.Tensor], torch.Tensor], z: torch.Tensor,
                 spatial_scale: int, tile_latent: int = 32, stride_latent: int = 24) -> torch.Tensor:
    """Decode ``z`` [B, F', h, w, C] in overlapping ``tile_latent``² windows;
    returns the assembled [B, F, h·scale, w·scale, 3] video."""
    _, _, h, w, _ = z.shape
    if h <= tile_latent and w <= tile_latent:
        return decode_fn(z)
    rows = [[decode_fn(z[:, :, i:i + tile_latent, j:j + tile_latent]) for j in range(0, w, stride_latent)]
            for i in range(0, h, stride_latent)]
    out = _assemble(rows, (tile_latent - stride_latent) * spatial_scale, stride_latent * spatial_scale)
    return out[:, :, : h * spatial_scale, : w * spatial_scale]


def auto_tile_encode(num_frames: int, h_px: int, w_px: int) -> bool:
    """Encode-side tiling policy: tile only multi-frame clips past ~8 frames
    of 480p (single-frame conditioning encodes stay untiled, because tiled
    encode is not equal to untiled and the conditioning latents must match
    the reference)."""
    return num_frames > 1 and num_frames * h_px * w_px > 8 * 480 * 720


def tiled_encode(encode_fn: Callable, x: torch.Tensor, spatial_scale: int, tile_px: int = 256,
                 stride_px: int = 192):
    """Encode ``x`` [B, F, H, W, C] in overlapping ``tile_px``² windows and
    blend the latent seams. ``encode_fn`` returns a tuple of latents
    ``[B, F', h, w, K]`` (e.g. ``(mean, logvar)``); each is assembled alike."""
    _, _, h, w, _ = x.shape
    if h <= tile_px and w <= tile_px:
        return encode_fn(x)
    rows = [[encode_fn(x[:, :, i:i + tile_px, j:j + tile_px]) for j in range(0, w, stride_px)]
            for i in range(0, h, stride_px)]
    h_lat, w_lat = -(-h // spatial_scale), -(-w // spatial_scale)
    overlap, stride = (tile_px - stride_px) // spatial_scale, stride_px // spatial_scale
    return tuple(
        _assemble([[tile[n] for tile in row] for row in rows], overlap, stride)[:, :, :h_lat, :w_lat]
        for n in range(len(rows[0][0]))
    )
