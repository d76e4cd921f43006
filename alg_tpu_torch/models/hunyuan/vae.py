"""HunyuanVideo 3D causal VAE (counterpart of ``alg_tpu/models/hunyuan/vae.py``).

diffusers ``AutoencoderKLHunyuanVideo``: causal 3D convs with *replicate*
temporal front padding (CogVideoX's rule, not Wan's zero frames) and zero
spatial padding, GroupNorm resnets, block widths (128, 256, 512, 512) with 2
resnets each, stride-2 causal-conv downsampling ((2, 2, 2) on the stages
that compress time, (1, 2, 2) after), a single-head spatial self-attention
per frame in the mid block, a nearest-upsampling decoder, quant and
post-quant 1×1×1 convs, scaling factor 0.476986, 4× temporal and 8× spatial
compression (F -> (F − 1)/4 + 1).

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
from torch import nn

from alg_tpu_torch.models import layers as L


@dataclasses.dataclass(frozen=True)
class HunyuanVAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 16
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    norm_eps: float = 1e-6
    temporal_compression_ratio: int = 4
    scaling_factor: float = 0.476986

    @property
    def spatial_scale(self) -> int:
        return 2 ** (len(self.block_out_channels) - 1)

    @property
    def temporal_compress_level(self) -> int:
        return self.temporal_compression_ratio.bit_length() - 1


class CausalConv3d(nn.Conv3d):
    """Conv3d with the first frame replicated k_t − 1 times in front and
    zero spatial padding of k // 2; weight ``[out, in, kt, kh, kw]``."""

    def __init__(self, cin: int, cout: int, k: int, stride=(1, 1, 1), device=None, dtype=None):
        super().__init__(cin, cout, k, stride=stride, padding=(0, k // 2, k // 2), device=device, dtype=dtype)

    def forward(self, x):
        kt = self.kernel_size[0]
        if kt > 1:
            x = torch.cat([x[:, :, :1].expand(-1, -1, kt - 1, -1, -1), x], dim=2)
        return super().forward(x)


class ResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int, groups: int, eps: float, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.norm1 = L.GroupNorm(cin, groups, eps, **kw)
        self.conv1 = CausalConv3d(cin, cout, 3, **kw)
        self.norm2 = L.GroupNorm(cout, groups, eps, **kw)
        self.conv2 = CausalConv3d(cout, cout, 3, **kw)
        if cin != cout:
            self.conv_shortcut = CausalConv3d(cin, cout, 1, **kw)

    def forward(self, x):
        h = self.conv1(L.silu(self.norm1(x)))
        h = self.conv2(L.silu(self.norm2(h)))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class MidAttention(nn.Module):
    """Single-head spatial self-attention per frame with a GroupNorm pre-norm."""

    def __init__(self, dim: int, groups: int, eps: float, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.group_norm = L.GroupNorm(dim, groups, eps, **kw)
        self.to_q = nn.Linear(dim, dim, **kw)
        self.to_k = nn.Linear(dim, dim, **kw)
        self.to_v = nn.Linear(dim, dim, **kw)
        self.to_out = nn.Linear(dim, dim, **kw)

    def forward(self, x):
        b, c, f, h, w = x.shape
        y = self.group_norm(x).permute(0, 2, 3, 4, 1).reshape(b * f, h * w, c)
        q, k, v = self.to_q(y), self.to_k(y), self.to_v(y)
        logits = torch.matmul(q.float(), k.float().transpose(1, 2)) * c ** -0.5
        o = self.to_out(torch.matmul(torch.softmax(logits, dim=-1).to(v.dtype), v))
        return x + o.reshape(b, f, h, w, c).permute(0, 4, 1, 2, 3)


class _Mid(nn.Module):
    def __init__(self, ch: int, groups: int, eps: float, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.resnet1 = ResnetBlock(ch, ch, groups, eps, **kw)
        self.attn = MidAttention(ch, groups, eps, **kw)
        self.resnet2 = ResnetBlock(ch, ch, groups, eps, **kw)

    def forward(self, x):
        return self.resnet2(self.attn(self.resnet1(x)))


class _Resample(nn.Module):
    """Holds a stage's ``conv`` (a stride-2 causal conv going down, a causal
    conv after the nearest upsampling going up)."""

    def __init__(self, ch: int, stride, device=None, dtype=None):
        super().__init__()
        self.conv = CausalConv3d(ch, ch, 3, stride=stride, device=device, dtype=dtype)


def _causal_temporal_upsample(x: torch.Tensor) -> torch.Tensor:
    """Frame 0 kept, the rest doubled (F -> 2F − 1)."""
    if x.shape[2] == 1:
        return x
    return torch.cat([x[:, :, :1], x[:, :, 1:].repeat_interleave(2, dim=2)], dim=2)


class _DownStage(nn.Module):
    def __init__(self, resnets, downsample=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if downsample is not None:
            self.downsample = downsample

    def forward(self, x):
        for r in self.resnets:
            x = r(x)
        return self.downsample.conv(x) if hasattr(self, "downsample") else x


class _UpStage(nn.Module):
    def __init__(self, resnets, upsample=None, temporal: bool = False):
        super().__init__()
        self.temporal = temporal
        self.resnets = nn.ModuleList(resnets)
        if upsample is not None:
            self.upsample = upsample

    def forward(self, x):
        for r in self.resnets:
            x = r(x)
        if hasattr(self, "upsample"):
            if self.temporal:
                x = _causal_temporal_upsample(x)
            x = x.repeat_interleave(2, dim=3).repeat_interleave(2, dim=4)
            x = self.upsample.conv(x)
        return x


class Encoder(nn.Module):
    def __init__(self, cfg: HunyuanVAEConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        g, eps, boc = cfg.norm_num_groups, cfg.norm_eps, cfg.block_out_channels
        self.conv_in = CausalConv3d(cfg.in_channels, boc[0], 3, **kw)
        stages, ch = [], boc[0]
        for i, out in enumerate(boc):
            resnets = [ResnetBlock(ch if j == 0 else out, out, g, eps, **kw) for j in range(cfg.layers_per_block)]
            down = None
            if i < len(boc) - 1:
                # (2, 2, 2) on the stages that compress time, (1, 2, 2) after
                down = _Resample(out, (2, 2, 2) if i < cfg.temporal_compress_level else (1, 2, 2), **kw)
            stages.append(_DownStage(resnets, down))
            ch = out
        self.down = nn.ModuleList(stages)
        self.mid = _Mid(ch, g, eps, **kw)
        self.norm_out = L.GroupNorm(ch, g, eps, **kw)
        self.conv_out = CausalConv3d(ch, 2 * cfg.latent_channels, 3, **kw)

    def forward(self, x):
        h = self.conv_in(x)
        for stage in self.down:
            h = stage(h)
        return self.conv_out(L.silu(self.norm_out(self.mid(h))))


class Decoder(nn.Module):
    def __init__(self, cfg: HunyuanVAEConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        g, eps = cfg.norm_num_groups, cfg.norm_eps
        rev = list(reversed(cfg.block_out_channels))
        self.conv_in = CausalConv3d(cfg.latent_channels, rev[0], 3, **kw)
        self.mid = _Mid(rev[0], g, eps, **kw)
        stages, ch = [], rev[0]
        for i, out in enumerate(rev):
            resnets = [ResnetBlock(ch if j == 0 else out, out, g, eps, **kw)
                       for j in range(cfg.layers_per_block + 1)]
            up = _Resample(out, (1, 1, 1), **kw) if i < len(rev) - 1 else None
            stages.append(_UpStage(resnets, up, temporal=i < cfg.temporal_compress_level))
            ch = out
        self.up = nn.ModuleList(stages)
        self.norm_out = L.GroupNorm(ch, g, eps, **kw)
        self.conv_out = CausalConv3d(ch, cfg.out_channels, 3, **kw)

    def forward(self, z):
        h = self.mid(self.conv_in(z))
        for stage in self.up:
            h = stage(h)
        return self.conv_out(L.silu(self.norm_out(h)))


class HunyuanVAE(nn.Module):
    def __init__(self, cfg: HunyuanVAEConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype)
        self.encoder = Encoder(cfg, **kw)
        self.decoder = Decoder(cfg, **kw)
        self.quant_conv = CausalConv3d(2 * cfg.latent_channels, 2 * cfg.latent_channels, 1, **kw)
        self.post_quant_conv = CausalConv3d(cfg.latent_channels, cfg.latent_channels, 1, **kw)

    def encode(self, x: torch.Tensor):
        """``[B, F, H, W, 3]`` -> (mean, logvar), each ``[B, (F − 1)/4 + 1, H/8, W/8, z]``."""
        h = self.quant_conv(self.encoder(x.permute(0, 4, 1, 2, 3))).permute(0, 2, 3, 4, 1)
        return h.chunk(2, dim=-1)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """``[B, F', h, w, z]`` (already divided by the scaling factor) ->
        ``[B, 1 + 4(F' − 1), H, W, 3]``."""
        return self.decoder(self.post_quant_conv(z.permute(0, 4, 1, 2, 3))).permute(0, 2, 3, 4, 1)
