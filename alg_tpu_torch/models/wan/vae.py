"""Wan 2.1 3D causal VAE (counterpart of ``alg_tpu/models/wan/vae.py``).

diffusers ``AutoencoderKLWan``: causal 3D convs (temporal front *zero*
padding, unlike CogVideoX's first-frame replicate), channel-wise RMS norm
(L2-normalise over channels · √C · γ), base_dim 96 with multipliers
(1, 2, 4, 4), 2 res blocks per stage, temporal downsampling on stages 2-3
(4× in all), spatial 8×, a single-head spatial self-attention in the mid
block, and quant / post-quant 1×1×1 convs. The per-channel
``latents_mean``/``latents_std`` normalisation is applied by the pipeline.
The encoder returns (mean, logvar): Wan encodes its conditions with the mode.

The public functions take and return channels-last ``[B, F, H, W, C]``, as
the JAX package does; inside, the modules run channels-first
``[B, C, F, H, W]`` for ``conv3d``. The mid-block attention (one head of
width C over the h·w positions of a frame) is computed with plain matrix
products and an fp32 softmax, as in the JAX package, which runs it outside
any kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from alg_tpu_torch.models import layers as L
from alg_tpu_torch.models.cogvideox.vae import _conv2d_per_frame

# Wan2.1's shipped normalisation statistics (vae/config.json)
WAN21_LATENTS_MEAN = (
    -0.7571, -0.7089, -0.9113, 0.1075, -0.1745, 0.9653, -0.1517, 1.5508,
    0.4134, -0.0715, 0.5517, -0.3632, -0.1922, -0.9497, 0.2503, -0.2921,
)
WAN21_LATENTS_STD = (
    2.8184, 1.4541, 2.3275, 2.6558, 1.2196, 1.7708, 2.6052, 2.0743,
    3.2687, 2.1526, 2.8652, 1.5579, 1.6382, 1.1253, 2.8251, 1.9160,
)


@dataclasses.dataclass(frozen=True)
class WanVAEConfig:
    base_dim: int = 96
    z_dim: int = 16
    dim_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    temperal_downsample: Tuple[bool, ...] = (False, True, True)  # [sic], as in diffusers
    latents_mean: Tuple[float, ...] = WAN21_LATENTS_MEAN
    latents_std: Tuple[float, ...] = WAN21_LATENTS_STD

    @property
    def temporal_scale(self) -> int:
        return 2 ** sum(self.temperal_downsample)

    @property
    def spatial_scale(self) -> int:
        return 2 ** (len(self.dim_mult) - 1)


class CausalConv3d(nn.Conv3d):
    """Conv3d with k_t − 1 zero frames padded in front and symmetric zero
    spatial padding; weight ``[out, in, kt, kh, kw]``."""

    def __init__(self, cin: int, cout: int, kernel: Tuple[int, int, int], stride=(1, 1, 1), device=None,
                 dtype=None):
        super().__init__(cin, cout, kernel, stride=stride, padding=(0, kernel[1] // 2, kernel[2] // 2),
                         device=device, dtype=dtype)

    def forward(self, x):
        kt = self.kernel_size[0]
        if kt > 1:
            x = F.pad(x, (0, 0, 0, 0, kt - 1, 0))
        return super().forward(x)


class ChannelRMSNorm(nn.Module):
    """WanRMS_norm over the channel dim (dim 1) of ``[B, C, ...]``, in fp32."""

    def __init__(self, channels: int, device=None, dtype=None):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(channels, device=device, dtype=dtype))

    def forward(self, x):
        xf = x.float()
        norm = torch.sqrt(xf.square().sum(dim=1, keepdim=True) + 1e-12)
        gamma = self.gamma.float().view(-1, *([1] * (x.dim() - 2)))
        return (xf / norm * x.shape[1] ** 0.5 * gamma).to(x.dtype)


class ResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.norm1 = ChannelRMSNorm(cin, **kw)
        self.conv1 = CausalConv3d(cin, cout, (3, 3, 3), **kw)
        self.norm2 = ChannelRMSNorm(cout, **kw)
        self.conv2 = CausalConv3d(cout, cout, (3, 3, 3), **kw)
        if cin != cout:
            self.conv_shortcut = CausalConv3d(cin, cout, (1, 1, 1), **kw)

    def forward(self, x):
        h = self.conv1(L.silu(self.norm1(x)))
        h = self.conv2(L.silu(self.norm2(h)))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class AttentionBlock(nn.Module):
    """Single-head spatial self-attention per frame (WanAttentionBlock)."""

    def __init__(self, dim: int, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.norm = ChannelRMSNorm(dim, **kw)
        self.to_qkv = CausalConv3d(dim, 3 * dim, (1, 1, 1), **kw)
        self.proj = CausalConv3d(dim, dim, (1, 1, 1), **kw)

    def forward(self, x):
        b, c, f, h, w = x.shape
        qkv = self.to_qkv(self.norm(x)).permute(0, 2, 3, 4, 1).reshape(b * f, h * w, 3 * c)
        q, k, v = qkv.chunk(3, dim=-1)
        logits = torch.matmul(q.float(), k.float().transpose(1, 2)) * c ** -0.5
        o = torch.matmul(torch.softmax(logits, dim=-1).to(v.dtype), v)
        return x + self.proj(o.reshape(b, f, h, w, c).permute(0, 4, 1, 2, 3))


class _Mid(nn.Module):
    def __init__(self, ch: int, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.resnet1 = ResnetBlock(ch, ch, **kw)
        self.attn = AttentionBlock(ch, **kw)
        self.resnet2 = ResnetBlock(ch, ch, **kw)

    def forward(self, x):
        return self.resnet2(self.attn(self.resnet1(x)))


class Downsample(nn.Module):
    """Optional causal stride-2 temporal conv (F -> ⌈F/2⌉), then a zero pad
    of one column right and one row below and a stride-2 3×3 conv per frame."""

    def __init__(self, ch: int, temporal: bool, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.conv = nn.Conv2d(ch, ch, 3, stride=2, **kw)
        if temporal:
            self.time_conv = CausalConv3d(ch, ch, (3, 1, 1), stride=(2, 1, 1), **kw)

    def forward(self, x):
        if hasattr(self, "time_conv"):
            x = self.time_conv(x)
        return _conv2d_per_frame(self.conv, x, pad=(0, 1, 0, 1))


class Upsample(nn.Module):
    """Optional temporal 2× (a conv to 2C channels whose halves become
    consecutive frames, the doubled first frame dropped: F -> 2F − 1), then
    nearest 2× and a channel-halving 3×3 conv per frame."""

    def __init__(self, ch: int, temporal: bool, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.conv = nn.Conv2d(ch, ch // 2, 3, padding=1, **kw)
        if temporal:
            self.time_conv = CausalConv3d(ch, 2 * ch, (3, 1, 1), **kw)

    def forward(self, x):
        if hasattr(self, "time_conv"):
            y = self.time_conv(x)  # [B, 2C, F, H, W]
            b, c2, f, h, w = y.shape
            x = y.view(b, 2, c2 // 2, f, h, w).permute(0, 2, 3, 1, 4, 5).reshape(b, c2 // 2, 2 * f, h, w)[:, :, 1:]
        x = x.repeat_interleave(2, dim=3).repeat_interleave(2, dim=4)
        return _conv2d_per_frame(self.conv, x)


class _Stage(nn.Module):
    def __init__(self, resnets, name=None, resample=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if resample is not None:
            setattr(self, name, resample)

    def forward(self, x):
        for r in self.resnets:
            x = r(x)
        for name in ("downsample", "upsample"):
            if hasattr(self, name):
                x = getattr(self, name)(x)
        return x


class Encoder(nn.Module):
    def __init__(self, cfg: WanVAEConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        dims = [cfg.base_dim * m for m in cfg.dim_mult]
        self.conv_in = CausalConv3d(3, dims[0], (3, 3, 3), **kw)
        stages, ch = [], dims[0]
        for i, out in enumerate(dims):
            resnets = [ResnetBlock(ch if j == 0 else out, out, **kw) for j in range(cfg.num_res_blocks)]
            down = Downsample(out, cfg.temperal_downsample[i], **kw) if i < len(dims) - 1 else None
            stages.append(_Stage(resnets, "downsample", down))
            ch = out
        self.down = nn.ModuleList(stages)
        self.mid = _Mid(ch, **kw)
        self.norm_out = ChannelRMSNorm(ch, **kw)
        self.conv_out = CausalConv3d(ch, 2 * cfg.z_dim, (3, 3, 3), **kw)

    def forward(self, x):
        h = self.conv_in(x)
        for stage in self.down:
            h = stage(h)
        return self.conv_out(L.silu(self.norm_out(self.mid(h))))


class Decoder(nn.Module):
    def __init__(self, cfg: WanVAEConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        rdims = [cfg.base_dim * m for m in reversed(cfg.dim_mult)]
        temporal_up = list(reversed(cfg.temperal_downsample))
        self.conv_in = CausalConv3d(cfg.z_dim, rdims[0], (3, 3, 3), **kw)
        self.mid = _Mid(rdims[0], **kw)
        stages, ch = [], rdims[0]
        for i, out in enumerate(rdims):
            # a stage's resnets run at `out`; its upsampler halves the width
            resnets = [ResnetBlock(ch if j == 0 else out, out, **kw) for j in range(cfg.num_res_blocks + 1)]
            ch, up = out, None
            if i < len(rdims) - 1:
                up, ch = Upsample(out, temporal_up[i], **kw), out // 2
            stages.append(_Stage(resnets, "upsample", up))
        self.up = nn.ModuleList(stages)
        self.norm_out = ChannelRMSNorm(ch, **kw)
        self.conv_out = CausalConv3d(ch, 3, (3, 3, 3), **kw)

    def forward(self, z):
        h = self.mid(self.conv_in(z))
        for stage in self.up:
            h = stage(h)
        return self.conv_out(L.silu(self.norm_out(h)))


class WanVAE(nn.Module):
    def __init__(self, cfg: WanVAEConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype)
        self.encoder = Encoder(cfg, **kw)
        self.decoder = Decoder(cfg, **kw)
        self.quant_conv = CausalConv3d(2 * cfg.z_dim, 2 * cfg.z_dim, (1, 1, 1), **kw)
        self.post_quant_conv = CausalConv3d(cfg.z_dim, cfg.z_dim, (1, 1, 1), **kw)

    def encode(self, x: torch.Tensor):
        """``[B, F, H, W, 3]`` -> (mean, logvar), each ``[B, F', H/8, W/8, z_dim]``."""
        h = self.quant_conv(self.encoder(x.permute(0, 4, 1, 2, 3))).permute(0, 2, 3, 4, 1)
        return h.chunk(2, dim=-1)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """``[B, F', h, w, z_dim]`` (de-normalised) -> ``[B, F, H, W, 3]``."""
        return self.decoder(self.post_quant_conv(z.permute(0, 4, 1, 2, 3))).permute(0, 2, 3, 4, 1)
