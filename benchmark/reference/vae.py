"""The CogVideoX VAE encoder in plain float32 PyTorch (diffusers ``AutoencoderKLCogVideoX``).

Causal 3D convolutions (the first frame repeated ``k_t - 1`` times in front,
zero spatial padding), ResNet blocks with GroupNorm and SiLU, down blocks
with a spatial stride-2 convolution after a (0, 1, 0, 1) pad and, in the first
``log2(temporal_compression_ratio)`` of them, causal 2x pooling in time; the
mid block's two ResNets; GroupNorm, SiLU and the output convolution to the
posterior's (mean, logvar).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _causal_conv(w, name, x):
    weight = w[f"{name}.weight"].to(device=x.device, dtype=torch.float32)
    bias = w[f"{name}.bias"].to(device=x.device, dtype=torch.float32)
    kt, kh = weight.shape[2], weight.shape[3]
    if kt > 1:
        x = torch.cat([x[:, :, :1]] * (kt - 1) + [x], dim=2)
    return F.conv3d(x, weight, bias, padding=(0, kh // 2, kh // 2))


def _group_norm(w, name, x, groups, eps):
    return F.group_norm(x, groups, w[f"{name}.weight"].to(x.device, torch.float32),
                        w[f"{name}.bias"].to(x.device, torch.float32), eps)


def _resnet(w, name, x, groups, eps):
    h = _causal_conv(w, f"{name}.conv1.conv", F.silu(_group_norm(w, f"{name}.norm1", x, groups, eps)))
    h = _causal_conv(w, f"{name}.conv2.conv", F.silu(_group_norm(w, f"{name}.norm2", h, groups, eps)))
    if f"{name}.conv_shortcut.conv.weight" in w:
        x = _causal_conv(w, f"{name}.conv_shortcut.conv", x)
    return x + h


def _downsample(w, name, x, compress_time):
    b, c, f, h, wd = x.shape
    if compress_time and f > 1:  # keep frame 0 of an odd count, average the rest in pairs
        first, rest = (x[:, :, :1], x[:, :, 1:]) if f % 2 == 1 else (None, x)
        rest = 0.5 * (rest[:, :, 0::2] + rest[:, :, 1::2])
        x = rest if first is None else torch.cat([first, rest], dim=2)
        f = x.shape[2]
    y = F.pad(x.permute(0, 2, 1, 3, 4).reshape(b * f, c, h, wd), (0, 1, 0, 1))
    y = F.conv2d(y, w[f"{name}.weight"].to(x.device, torch.float32), w[f"{name}.bias"].to(x.device, torch.float32),
                 stride=2)
    return y.reshape(b, f, c, y.shape[-2], y.shape[-1]).permute(0, 2, 1, 3, 4)


@torch.no_grad()
def encode(w, cfg: dict, pixels: torch.Tensor):
    """``pixels`` ``[B, 3, F, H, W]`` in [-1, 1] -> (mean, logvar), each ``[B, latent_channels, F', H/8, W/8]``."""
    groups, eps = cfg.get("norm_num_groups", 32), cfg.get("norm_eps", 1e-6)
    levels = cfg.get("temporal_compression_ratio", 4).bit_length() - 1
    boc = cfg["block_out_channels"]
    h = _causal_conv(w, "encoder.conv_in.conv", pixels.float())
    for i in range(len(boc)):
        for j in range(cfg["layers_per_block"]):
            h = _resnet(w, f"encoder.down_blocks.{i}.resnets.{j}", h, groups, eps)
        if i < len(boc) - 1:
            h = _downsample(w, f"encoder.down_blocks.{i}.downsamplers.0.conv", h, compress_time=i < levels)
    for j in range(2):
        h = _resnet(w, f"encoder.mid_block.resnets.{j}", h, groups, eps)
    h = _causal_conv(w, "encoder.conv_out.conv", F.silu(_group_norm(w, "encoder.norm_out", h, groups, eps)))
    return h.chunk(2, dim=1)
