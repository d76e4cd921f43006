"""CogVideoX 3D causal VAE (counterpart of ``alg_tpu/models/cogvideox/vae.py``).

diffusers ``AutoencoderKLCogVideoX``: causal 3D convs (the first frame
replicated k_t - 1 times in front, zero spatial padding); 4 down blocks with
spatial stride-2 downsampling (asymmetric (0, 1) padding) on the first 3 and
causal temporal 2x pooling on the first 2, for 8x spatial and 4x temporal
compression; a decoder whose norms are spatial norms conditioned on the
latent z. The encoder returns (mean, logvar); the pipeline draws the sample.

The public functions take and return channels-last ``[B, F, H, W, C]``, as
the JAX package does; inside, the modules run channels-first
``[B, C, F, H, W]`` for ``conv3d``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from alg_tpu_torch.models import layers as L


@dataclasses.dataclass(frozen=True)
class CogVideoXVAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    block_out_channels: Tuple[int, ...] = (128, 256, 256, 512)
    latent_channels: int = 16
    layers_per_block: int = 3
    norm_num_groups: int = 32
    norm_eps: float = 1e-6
    temporal_compression_ratio: int = 4
    scaling_factor: float = 0.7

    @property
    def temporal_compress_level(self) -> int:
        return self.temporal_compression_ratio.bit_length() - 1

    @property
    def spatial_scale(self) -> int:
        return 2 ** (len(self.block_out_channels) - 1)


class CausalConv3d(nn.Conv3d):
    """Conv3d with replicate-first-frame temporal padding and zero spatial
    padding of k//2; weight ``[out, in, kt, kh, kw]``."""

    def __init__(self, cin: int, cout: int, k: int, device=None, dtype=None):
        super().__init__(cin, cout, k, padding=(0, k // 2, k // 2), device=device, dtype=dtype)

    def forward(self, x):
        kt = self.kernel_size[0]
        if kt > 1:
            x = torch.cat([x[:, :, :1].expand(-1, -1, kt - 1, -1, -1), x], dim=2)
        return super().forward(x)


def _conv2d_per_frame(conv: nn.Conv2d, x: torch.Tensor, pad=None) -> torch.Tensor:
    """Apply a 2D conv to every frame of ``[B, C, F, H, W]``; ``pad`` is an
    explicit ``F.pad`` spec (else the conv's own padding)."""
    b, c, f, h, w = x.shape
    xf = x.permute(0, 2, 1, 3, 4).reshape(b * f, c, h, w)
    if pad is not None:
        xf = F.pad(xf, pad)
    y = conv(xf)
    return y.reshape(b, f, *y.shape[1:]).permute(0, 2, 1, 3, 4)


def _temporal_pool2(x: torch.Tensor) -> torch.Tensor:
    """Causal 2x temporal pooling: frame 0 kept for odd F, pairs averaged."""
    f = x.shape[2]
    if f == 1:
        return x
    if f % 2 == 1:
        rest = x[:, :, 1:]
        return torch.cat([x[:, :, :1], 0.5 * (rest[:, :, 0::2] + rest[:, :, 1::2])], dim=2)
    return 0.5 * (x[:, :, 0::2] + x[:, :, 1::2])


def _temporal_upsample2(x: torch.Tensor) -> torch.Tensor:
    """Frame 0 kept, the rest repeated 2x (F -> 2F - 1)."""
    if x.shape[2] == 1:
        return x
    return torch.cat([x[:, :, :1], x[:, :, 1:].repeat_interleave(2, dim=2)], dim=2)


def _nearest_resize(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Nearest spatial resize with torch's floor index convention."""
    ih, iw = x.shape[-2:]
    hi = torch.arange(h, device=x.device) * ih // h
    wi = torch.arange(w, device=x.device) * iw // w
    return x[..., hi, :][..., wi]


class SpatialNorm(nn.Module):
    """CogVideoXSpatialNorm3D: GN(f)·conv_y(zq) + conv_b(zq), with zq
    nearest-resized to f (its first frame conditioning f's first frame)."""

    def __init__(self, f_ch: int, zq_ch: int, groups: int, eps: float, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.norm = L.GroupNorm(f_ch, groups, eps, **kw)
        self.conv_y = CausalConv3d(zq_ch, f_ch, 1, **kw)
        self.conv_b = CausalConv3d(zq_ch, f_ch, 1, **kw)

    def forward(self, f, zq):
        ff, fz = f.shape[2], zq.shape[2]
        if ff != fz:
            reps = -(-(ff - 1) // max(fz - 1, 1))
            z_rest = zq[:, :, 1:].repeat_interleave(reps, dim=2)[:, :, : ff - 1]
            zq = torch.cat([zq[:, :, :1], z_rest], dim=2)
        zq = _nearest_resize(zq, f.shape[3], f.shape[4])
        return self.norm(f) * self.conv_y(zq) + self.conv_b(zq)


class ResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int, groups: int, eps: float, zq_ch: Optional[int] = None,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        if zq_ch is None:
            self.norm1 = L.GroupNorm(cin, groups, eps, **kw)
            self.norm2 = L.GroupNorm(cout, groups, eps, **kw)
        else:
            self.norm1 = SpatialNorm(cin, zq_ch, groups, eps, **kw)
            self.norm2 = SpatialNorm(cout, zq_ch, groups, eps, **kw)
        self.conv1 = CausalConv3d(cin, cout, 3, **kw)
        self.conv2 = CausalConv3d(cout, cout, 3, **kw)
        if cin != cout:
            self.conv_shortcut = CausalConv3d(cin, cout, 1, **kw)
        self.spatial = zq_ch is not None

    def forward(self, x, zq=None):
        def norm(m, h):
            return m(h, zq) if self.spatial else m(h)

        h = self.conv1(L.silu(norm(self.norm1, x)))
        h = self.conv2(L.silu(norm(self.norm2, h)))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class _Resample(nn.Module):
    """Holder of the 3x3 2D conv of a down- or upsampling stage."""

    def __init__(self, ch: int, stride: int, padding: int, device=None, dtype=None):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, stride=stride, padding=padding, device=device, dtype=dtype)


class _Stage(nn.Module):
    def __init__(self, resnets, resample: Optional[_Resample], name: str):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if resample is not None:
            setattr(self, name, resample)


class Encoder(nn.Module):
    def __init__(self, cfg: CogVideoXVAEConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        g, eps, boc = cfg.norm_num_groups, cfg.norm_eps, cfg.block_out_channels
        self.cfg = cfg
        self.conv_in = CausalConv3d(cfg.in_channels, boc[0], 3, **kw)
        stages, ch = [], boc[0]
        for i, out in enumerate(boc):
            resnets = [ResnetBlock(ch if j == 0 else out, out, g, eps, **kw) for j in range(cfg.layers_per_block)]
            down = _Resample(out, 2, 0, **kw) if i < len(boc) - 1 else None
            stages.append(_Stage(resnets, down, "downsample"))
            ch = out
        self.down = nn.ModuleList(stages)
        self.mid = nn.ModuleList(ResnetBlock(ch, ch, g, eps, **kw) for _ in range(2))
        self.norm_out = L.GroupNorm(ch, g, eps, **kw)
        self.conv_out = CausalConv3d(ch, 2 * cfg.latent_channels, 3, **kw)

    def forward(self, x):
        h = self.conv_in(x)
        for i, stage in enumerate(self.down):
            for r in stage.resnets:
                h = r(h)
            if hasattr(stage, "downsample"):
                if i < self.cfg.temporal_compress_level:
                    h = _temporal_pool2(h)
                h = _conv2d_per_frame(stage.downsample.conv, h, pad=(0, 1, 0, 1))
        for r in self.mid:
            h = r(h)
        return self.conv_out(L.silu(self.norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, cfg: CogVideoXVAEConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        g, eps, zc = cfg.norm_num_groups, cfg.norm_eps, cfg.latent_channels
        rev = list(reversed(cfg.block_out_channels))
        self.cfg = cfg
        self.conv_in = CausalConv3d(zc, rev[0], 3, **kw)
        self.mid = nn.ModuleList(ResnetBlock(rev[0], rev[0], g, eps, zc, **kw) for _ in range(2))
        stages, ch = [], rev[0]
        for i, out in enumerate(rev):
            resnets = [ResnetBlock(ch if j == 0 else out, out, g, eps, zc, **kw)
                       for j in range(cfg.layers_per_block + 1)]
            up = _Resample(out, 1, 1, **kw) if i < len(rev) - 1 else None
            stages.append(_Stage(resnets, up, "upsample"))
            ch = out
        self.up = nn.ModuleList(stages)
        self.norm_out = SpatialNorm(ch, zc, g, eps, **kw)
        self.conv_out = CausalConv3d(ch, cfg.out_channels, 3, **kw)

    def forward(self, z):
        h = self.conv_in(z)
        for r in self.mid:
            h = r(h, z)
        for i, stage in enumerate(self.up):
            for r in stage.resnets:
                h = r(h, z)
            if hasattr(stage, "upsample"):
                if i < self.cfg.temporal_compress_level:
                    h = _temporal_upsample2(h)
                h = h.repeat_interleave(2, dim=3).repeat_interleave(2, dim=4)
                h = _conv2d_per_frame(stage.upsample.conv, h)
        return self.conv_out(L.silu(self.norm_out(h, z)))


class CogVideoXVAE(nn.Module):
    def __init__(self, cfg: CogVideoXVAEConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg, device=device, dtype=dtype)
        self.decoder = Decoder(cfg, device=device, dtype=dtype)

    def encode(self, x: torch.Tensor):
        """``[B, F, H, W, 3]`` -> (mean, logvar), each ``[B, F', H/8, W/8, latent_channels]``."""
        h = self.encoder(x.permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)
        return h.chunk(2, dim=-1)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """``[B, F', h, w, latent_channels]`` (already divided by the scaling
        factor) -> ``[B, F, H, W, 3]``."""
        return self.decoder(z.permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)
