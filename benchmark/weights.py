"""Seeded random weights in the published checkpoints' layout (diffusers names).

The benchmark makes the weights itself, on the device, from the run's seed, and
hands the same tensors to the program (through the program's checkpoint name
map) and, after the window, to the plain reference. Tensors of one shape and
kind are drawn in one call, so a 42-layer DiT takes a few dozen draws:

- a weight of two or more dims: N(0, 1/fan_in), fan_in the product of the dims
  after the first (linear ``[out, in]``, conv ``[out, in, *kernel]``);
- a bias: N(0, 0.02^2);
- a norm's weight: 1 + N(0, 0.1^2), a norm's bias: N(0, 0.02^2).

The same seed gives the same tensors on the same device.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, List, Tuple

import torch

Spec = List[Tuple[str, Tuple[int, ...], str]]  # (name, shape, kind): kind "w", "b", "n1" (norm weight), "n0"


def derive_seed(seed: int, purpose: str) -> int:
    """A 63-bit seed for one purpose ("weights", "noise", "inputs", ...) of a run's ``seed``."""
    digest = hashlib.sha256(f"{int(seed)}:{purpose}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


class _Spec:
    def __init__(self):
        self.items: Spec = []

    def add(self, name, shape, kind="w"):
        self.items.append((name, tuple(int(d) for d in shape), kind))

    def linear(self, name, n_out, n_in, bias=True):
        self.add(f"{name}.weight", (n_out, n_in))
        if bias:
            self.add(f"{name}.bias", (n_out,), "b")

    def conv(self, name, cin, cout, *kernel):
        self.add(f"{name}.weight", (cout, cin, *kernel))
        self.add(f"{name}.bias", (cout,), "b")

    def norm(self, name, ch):
        self.add(f"{name}.weight", (ch,), "n1")
        self.add(f"{name}.bias", (ch,), "n0")


def cogvideox_transformer_spec(cfg: dict) -> Spec:
    """diffusers ``CogVideoXTransformer3DModel``'s tensors (no learned positional embedding)."""
    s = _Spec()
    heads, hd = cfg["num_attention_heads"], cfg["attention_head_dim"]
    dim, te, p = heads * hd, cfg["time_embed_dim"], cfg["patch_size"]
    pt, ofs = cfg.get("patch_size_t"), cfg.get("ofs_embed_dim")
    if pt is None:
        s.conv("patch_embed.proj", cfg["in_channels"], dim, p, p)
    else:
        s.linear("patch_embed.proj", dim, cfg["in_channels"] * pt * p * p)
    s.linear("patch_embed.text_proj", dim, cfg["text_embed_dim"])
    s.linear("time_embedding.linear_1", te, dim)
    s.linear("time_embedding.linear_2", te, te)
    if ofs is not None:
        s.linear("ofs_embedding.linear_1", ofs, ofs)
        s.linear("ofs_embedding.linear_2", ofs, ofs)
    s.norm("norm_final", dim)
    s.linear("norm_out.linear", 2 * dim, te)
    s.norm("norm_out.norm", dim)
    s.linear("proj_out", (pt or 1) * p * p * cfg["out_channels"], dim)
    bias = cfg.get("attention_bias", True)
    for i in range(cfg["num_layers"]):
        b = f"transformer_blocks.{i}"
        for nm in ("norm1", "norm2"):
            s.linear(f"{b}.{nm}.linear", 6 * dim, te)
            s.norm(f"{b}.{nm}.norm", dim)
        for nm in ("to_q", "to_k", "to_v"):
            s.linear(f"{b}.attn1.{nm}", dim, dim, bias=bias)
        s.linear(f"{b}.attn1.to_out.0", dim, dim)
        s.norm(f"{b}.attn1.norm_q", hd)
        s.norm(f"{b}.attn1.norm_k", hd)
        s.linear(f"{b}.ff.net.0.proj", 4 * dim, dim)
        s.linear(f"{b}.ff.net.2", dim, 4 * dim)
    return s.items


def cogvideox_vae_spec(cfg: dict) -> Spec:
    """diffusers ``AutoencoderKLCogVideoX``'s tensors, encoder and decoder."""
    s = _Spec()
    boc, z = cfg["block_out_channels"], cfg["latent_channels"]

    def conv3d(name, cin, cout, k=3):
        s.conv(f"{name}.conv", cin, cout, k, k, k)

    def resnet(name, cin, cout, spatial=False):
        conv3d(f"{name}.conv1", cin, cout)
        conv3d(f"{name}.conv2", cout, cout)
        if spatial:
            for nm, ch in (("norm1", cin), ("norm2", cout)):
                s.norm(f"{name}.{nm}.norm_layer", ch)
                conv3d(f"{name}.{nm}.conv_y", z, ch, k=1)
                conv3d(f"{name}.{nm}.conv_b", z, ch, k=1)
        else:
            s.norm(f"{name}.norm1", cin)
            s.norm(f"{name}.norm2", cout)
        if cin != cout:
            conv3d(f"{name}.conv_shortcut", cin, cout, k=1)

    conv3d("encoder.conv_in", 3, boc[0])
    ch = boc[0]
    for i, out in enumerate(boc):
        for j in range(cfg["layers_per_block"]):
            resnet(f"encoder.down_blocks.{i}.resnets.{j}", ch, out)
            ch = out
        if i < len(boc) - 1:
            s.conv(f"encoder.down_blocks.{i}.downsamplers.0.conv", out, out, 3, 3)
    for j in range(2):
        resnet(f"encoder.mid_block.resnets.{j}", ch, ch)
    s.norm("encoder.norm_out", ch)
    conv3d("encoder.conv_out", ch, 2 * z)

    rev = list(reversed(boc))
    conv3d("decoder.conv_in", z, rev[0])
    for j in range(2):
        resnet(f"decoder.mid_block.resnets.{j}", rev[0], rev[0], spatial=True)
    ch = rev[0]
    for i, out in enumerate(rev):
        for j in range(cfg["layers_per_block"] + 1):
            resnet(f"decoder.up_blocks.{i}.resnets.{j}", ch if j == 0 else out, out, spatial=True)
        ch = out
        if i < len(rev) - 1:
            s.conv(f"decoder.up_blocks.{i}.upsamplers.0.conv", out, out, 3, 3)
    s.norm("decoder.norm_out.norm_layer", ch)
    conv3d("decoder.norm_out.conv_y", z, ch, k=1)
    conv3d("decoder.norm_out.conv_b", z, ch, k=1)
    conv3d("decoder.conv_out", ch, 3)
    return s.items


@torch.no_grad()
def make_weights(spec: Spec, seed: int, device, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """``{name: tensor}`` on ``device`` in ``dtype``: each (shape, kind) group drawn in one call
    from one generator seeded with ``seed``, in the order the groups first appear in ``spec``."""
    groups: Dict[Tuple[Tuple[int, ...], str], List[str]] = {}
    for name, shape, kind in spec:
        groups.setdefault((shape, kind), []).append(name)
    gen = torch.Generator(device).manual_seed(int(seed))
    out: Dict[str, torch.Tensor] = {}
    for (shape, kind), names in groups.items():
        draw = torch.randn((len(names),) + shape, generator=gen, device=device, dtype=dtype)
        if kind == "w":
            draw.mul_(math.prod(shape[1:]) ** -0.5)
        elif kind == "n1":
            draw.mul_(0.1).add_(1.0)
        else:
            draw.mul_(0.02)
        for name, tensor in zip(names, draw.unbind(0)):
            out[name] = tensor
    return out
