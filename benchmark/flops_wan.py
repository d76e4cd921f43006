"""Operations and bytes of the Wan 2.1 DiT's work, as fixed functions of the shapes (peaks and the
counting rules: ``benchmark/flops.py``).

One CFG pass of the DiT over ``s_video`` video tokens of width ``d``, with
``s_text`` text and ``s_image`` image tokens to attend to, per block:

- linears: self-attention q, k, v and out ``4·2·S·d²``; the cross-attention's
  q and out ``2·2·S·d²``, its text k and v ``2·2·s_text·d²`` and image k and v
  ``2·2·s_image·d²``; the FFN ``2·2·S·d·ffn``;
- attention (``Q·Kᵀ`` and ``P·V``): self ``4·S²·d``, cross ``4·S·(s_text + s_image)·d``.

Outside the blocks: the patch embedding ``2·S·(C·pt·ph·pw)·d``, the time
embedder ``2·(freq·d + d²)`` and its 6-way projection ``2·d·6d``, the text
embedder ``2·s_text·(text_dim·d + d²)``, the image embedder
``2·s_image·(image_dim² + image_dim·d)`` and the output projection
``2·S·d·(pt·ph·pw·out_channels)``. Norms, RoPE and elementwise work are not
counted.
"""

from __future__ import annotations

from benchmark.flops import attention_flops


def video_tokens(cfg: dict, latent_frames: int, latent_h: int, latent_w: int) -> int:
    """Video tokens of one pass: ``F/pt · h/ph · w/pw``."""
    pt, ph, pw = cfg["patch_size"]
    return (latent_frames // pt) * (latent_h // ph) * (latent_w // pw)


def _dim(cfg: dict) -> int:
    return cfg["num_attention_heads"] * cfg["attention_head_dim"]


def linear_flops(cfg: dict, s_video: int, s_text: int, s_image: int) -> float:
    """Every linear of one pass (the patch embedding counted as the linear it is)."""
    d, ffn = _dim(cfg), cfg["ffn_dim"]
    pt, ph, pw = cfg["patch_size"]
    per_block = 2.0 * d * d * (6 * s_video + 2 * s_text + 2 * s_image) + 4.0 * s_video * d * ffn
    outside = (2.0 * s_video * cfg["in_channels"] * pt * ph * pw * d
               + 2.0 * (cfg["freq_dim"] * d + d * d) + 2.0 * d * 6 * d
               + 2.0 * s_text * (cfg["text_dim"] * d + d * d)
               + 2.0 * s_video * d * pt * ph * pw * cfg["out_channels"])
    if s_image and cfg.get("image_dim") is not None:
        outside += 2.0 * s_image * (cfg["image_dim"] ** 2 + cfg["image_dim"] * d)
    return cfg["num_layers"] * per_block + outside


def self_attention_flops(cfg: dict, s_video: int) -> float:
    """The self-attention of every block of one pass."""
    return cfg["num_layers"] * attention_flops(1, cfg["num_attention_heads"], s_video, s_video,
                                               cfg["attention_head_dim"])


def cross_attention_flops(cfg: dict, s_video: int, s_text: int, s_image: int) -> float:
    """The two cross-attentions (to the text and to the image tokens) of every block of one pass."""
    return cfg["num_layers"] * attention_flops(1, cfg["num_attention_heads"], s_video, s_text + s_image,
                                               cfg["attention_head_dim"])


def attention_flops_all(cfg: dict, s_video: int, s_text: int, s_image: int) -> float:
    """All three attentions of every block of one pass."""
    return self_attention_flops(cfg, s_video) + cross_attention_flops(cfg, s_video, s_text, s_image)


def forward_flops(cfg: dict, s_video: int, s_text: int, s_image: int) -> float:
    """Model FLOPs of one pass: the linears and the three attentions."""
    return linear_flops(cfg, s_video, s_text, s_image) + attention_flops_all(cfg, s_video, s_text, s_image)


def rope_bytes(batch: int, heads: int, seq: int, head_dim: int, elem: int = 2) -> float:
    """One RoPE launch (q or k of the self-attention): the tensor read once and written once in its
    type, and the fp32 cos and sin tables ``[S, D]``."""
    return 2.0 * batch * heads * seq * head_dim * elem + 2.0 * seq * head_dim * 4
