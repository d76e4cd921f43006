"""Operations and bytes the timed work needs, as fixed functions of the shapes, and the card's peaks.

A roofline share is the least time the card could take for that work, over
the time it took: ``(flops / PEAK_FLOPS) / seconds`` for a product-bound
kernel, ``(bytes / PEAK_BYTES) / seconds`` for a memory-bound one. The counts
are of what the algorithm needs, whatever implements it: a multiply-add is
two operations, each input byte is read once and each output byte written
once.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the 700 W power
limit): 989 TFLOP/s in bf16 on the tensor cores, 3.35 TB/s of HBM3. A card set
to a lower power limit runs below them; every result line prints the limit.
"""

from __future__ import annotations

PEAK_FLOPS_BF16 = 989e12
PEAK_BYTES = 3.35e12


def dit_tokens(cfg: dict, latent_frames: int, latent_h: int, latent_w: int) -> int:
    """Video tokens of one CFG pass: ``F/pt · (h/p) · (w/p)``."""
    pt, p = cfg.get("patch_size_t") or 1, cfg["patch_size"]
    return (latent_frames // pt) * (latent_h // p) * (latent_w // p)


def dit_linear_flops(cfg: dict, s_text: int, s_video: int) -> float:
    """Every linear (and the 1.0 patch convolution) of one pass of the CogVideoX DiT.

    Per block, over the joint ``S = s_text + s_video`` tokens of width ``d``:
    q, k, v and out ``4·2·S·d²``, the FFN ``2·2·S·d·4d``, so ``24·S·d²``; the two
    AdaLN linears ``2·2·te·6d`` on the one time embedding. Outside the blocks:
    the patch embed ``2·s_video·(C·pt·p²)·d``, the text projection
    ``2·s_text·text_dim·d``, the time (and ofs) embedding, the output AdaLN
    ``2·te·2d`` and the output projection ``2·s_video·d·(pt·p²·out_channels)``."""
    d = cfg["num_attention_heads"] * cfg["attention_head_dim"]
    te, p, pt = cfg["time_embed_dim"], cfg["patch_size"], cfg.get("patch_size_t") or 1
    s = s_text + s_video
    per_block = 24.0 * s * d * d + 2 * (2.0 * te * 6 * d)
    outside = (2.0 * s_video * cfg["in_channels"] * pt * p * p * d + 2.0 * s_text * cfg["text_embed_dim"] * d
               + 2.0 * (d * te + te * te) + 2.0 * te * 2 * d + 2.0 * s_video * d * pt * p * p * cfg["out_channels"])
    ofs = cfg.get("ofs_embed_dim")
    if ofs is not None:
        outside += 2.0 * 2 * ofs * ofs
    return cfg["num_layers"] * per_block + outside


def attention_flops(batch: int, heads: int, s_q: int, s_k: int, head_dim: int) -> float:
    """One attention forward: the two products ``Q·Kᵀ`` and ``P·V``, ``2·2·Sq·Sk·D`` a head
    (``s_k`` counts only the keys a query reaches)."""
    return 4.0 * batch * heads * s_q * s_k * head_dim


def dit_attention_flops(cfg: dict, s_text: int, s_video: int) -> float:
    """The self-attention of every block of one pass, over the joint sequence."""
    s = s_text + s_video
    return cfg["num_layers"] * attention_flops(1, cfg["num_attention_heads"], s, s, cfg["attention_head_dim"])


def dit_forward_flops(cfg: dict, s_text: int, s_video: int) -> float:
    """Model FLOPs of one pass: the linears and the attention (norms, RoPE and elementwise work not counted)."""
    return dit_linear_flops(cfg, s_text, s_video) + dit_attention_flops(cfg, s_text, s_video)


def qk_prep_bytes(batch: int, heads: int, seq: int, head_dim: int, elem: int = 2) -> float:
    """One qk_prep launch (LayerNorm + RoPE of q or of k): the tensor read once and written once in
    its type, the fp32 cos and sin tables ``[S, D]`` and the fp32 norm weight and bias ``[D]``."""
    return 2.0 * batch * heads * seq * head_dim * elem + 2.0 * seq * head_dim * 4 + 2.0 * head_dim * 4
