"""A run's inputs, made on the device from its seed and handed alike to the program and the reference."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.weights import derive_seed


class SeededNoise:
    """The ``noise_source`` the pipeline draws every noise tensor from (``randn(shape)``), in the
    order it asks: the VAE posterior's noise, then the initial latents. Keeps each draw."""

    def __init__(self, seed: int, purpose: str, device):
        self.device = device
        self.gen = torch.Generator(device).manual_seed(derive_seed(seed, purpose))
        self.draws = []

    def randn(self, shape):
        x = torch.randn(tuple(int(d) for d in shape), generator=self.gen, device=self.device, dtype=torch.float32)
        self.draws.append(x)
        return x


@torch.no_grad()
def request(seed: int, traffic: dict, text_dim: int, device, embed_dtype: torch.dtype):
    """(image ``[1, 3, H, W]`` float32 in [-1, 1], prompt embeddings, negative prompt embeddings
    ``[1, S_text, text_dim]``). The image is smooth random colour (a bilinear upsample of a 1/16-size
    draw) with fine noise on top; the embeddings stand in for T5-XXL's, drawn N(0, 1) in ``embed_dtype``."""
    gen = torch.Generator(device).manual_seed(derive_seed(seed, "inputs"))
    h, w, s_text = traffic["height"], traffic["width"], traffic["text_tokens"]
    coarse = torch.rand((1, 3, max(1, h // 16), max(1, w // 16)), generator=gen, device=device) * 2 - 1
    image = F.interpolate(coarse, size=(h, w), mode="bilinear", align_corners=False)
    image = (image + 0.05 * torch.randn((1, 3, h, w), generator=gen, device=device)).clamp_(-1, 1)
    prompt = torch.randn((1, s_text, text_dim), generator=gen, device=device).to(embed_dtype)
    negative = torch.randn((1, s_text, text_dim), generator=gen, device=device).to(embed_dtype)
    return image, prompt, negative
