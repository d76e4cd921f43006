"""Spatially tiled VAE encode/decode with overlap blending (counterpart of
``alg_tpu/models/vae_tiling.py``; tiles run one after another).

diffusers' ``tiled_decode`` assembly: tiles at stride S with size T; each
tile blends its top rows with the tile above and its left columns with the
tile to its left, ``out[i] = prev[S+i]·(1 - i/O) + cur[i]·(i/O)``; tiles are
cropped to the stride, concatenated, and the result cropped to the exact
output size. Layout is channels-last ``[B, F, H, W, C]``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from alg_tpu_torch.utils.profiling import span


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


def _decode_spread(decode_fn, tiles, mesh):
    """Decode ``tiles`` with the tile list spread over the ranks of the
    mesh that hold the same latents (its ``("pp", "sp", "tp")`` group):
    rank ``j`` decodes tiles ``j, j + n, ...``, and the decoded tiles are
    exchanged so that every rank holds all of them. Each tile goes through
    ``decode_fn`` as it would one after another."""
    from alg_tpu_torch.sharding.collectives import gather_objects

    axes = ("pp", "sp", "tp")
    n, j = mesh.size(axes), mesh.local_rank(axes)
    mine = {i: decode_fn(t).cpu() for i, t in enumerate(tiles) if i % n == j}
    out = {}
    for part in gather_objects(mine, mesh.group(axes)):
        out.update(part)
    return [out[i].to(tiles[0].device) for i in range(len(tiles))]


def tiled_decode(decode_fn: Callable[[torch.Tensor], torch.Tensor], z: torch.Tensor,
                 spatial_scale: int, tile_latent: int = 32, stride_latent: int = 24, mesh=None) -> torch.Tensor:
    """Decode ``z`` [B, F', h, w, C] in overlapping ``tile_latent``² windows;
    returns the assembled [B, F, h·scale, w·scale, 3] video. With a
    ``mesh`` the tiles spread over the ranks that hold these latents
    (``alg_tpu/models/vae_tiling.py:_decode_tiles_sharded``); the result is
    the sequential one."""
    _, _, h, w, _ = z.shape
    if h <= tile_latent and w <= tile_latent:
        return decode_fn(z)
    coords = [[(i, j) for j in range(0, w, stride_latent)] for i in range(0, h, stride_latent)]
    tiles = [z[:, :, i:i + tile_latent, j:j + tile_latent] for row in coords for i, j in row]
    if mesh is not None and len(tiles) > 1 and mesh.size(("pp", "sp", "tp")) > 1:
        decoded = iter(_decode_spread(decode_fn, tiles, mesh))
    else:
        decoded = map(decode_fn, tiles)
    rows = [[next(decoded) for _ in row] for row in coords]
    out = _assemble(rows, (tile_latent - stride_latent) * spatial_scale, stride_latent * spatial_scale)
    return out[:, :, : h * spatial_scale, : w * spatial_scale]


def vae_decode(vae, z: torch.Tensor, tiling: Optional[bool] = None, mesh=None) -> torch.Tensor:
    """``vae.decode`` of ``z`` [B, F', h, w, C], the ``vae.decode`` span: in
    overlapping tiles spread over ``mesh``'s ranks (:func:`tiled_decode`)
    or whole, as ``tiling`` says; with None, tiled once the latent exceeds
    48 x 48."""
    if tiling is None:
        tiling = z.shape[2] * z.shape[3] > 48 * 48
    with span("vae.decode"):
        return tiled_decode(vae.decode, z, vae.cfg.spatial_scale, mesh=mesh) if tiling else vae.decode(z)


def auto_tile_encode(num_frames: int, h_px: int, w_px: int, override: Optional[bool] = None) -> bool:
    """Encode-side tiling policy. ``override`` is the pipeline's explicit
    toggle: True or False wins outright. With None, tile only multi-frame
    clips past ~8 frames of 480p (single-frame conditioning encodes stay
    untiled, because tiled encode is not equal to untiled and the
    conditioning latents must match the reference)."""
    if override is not None:
        return bool(override)
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
