"""T5 v1.1 and UMT5 encoder (counterpart of ``alg_tpu/models/t5.py``;
CogVideoX's T5-XXL and Wan's UMT5-XXL).

RMS pre-norms without bias, unscaled attention (``scale=1.0``) with a
bucketed relative-position bias, and a gated-GELU MLP; all projections are
bias-free. T5 shares block 0's bias table among all blocks; UMT5
(``per_layer_relative_bias``) has one table per block. CogVideoX calls the
encoder without an attention mask, so padded tokens attend (faithful to the
reference); Wan passes the tokenizer's prefix mask, which becomes the
attention's ``kv_len``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from alg_tpu_torch.models import layers as L
from alg_tpu_torch.ops.attention import attention


@dataclasses.dataclass(frozen=True)
class T5Config:
    """Defaults = google/t5-v1_1-xxl."""

    vocab_size: int = 32128
    d_model: int = 4096
    d_kv: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    num_heads: int = 64
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    per_layer_relative_bias: bool = False  # True: UMT5

    @property
    def inner_dim(self) -> int:
        return self.num_heads * self.d_kv


UMT5_XXL = T5Config(vocab_size=256384, per_layer_relative_bias=True)  # google/umt5-xxl


def relative_position_buckets(q_len: int, k_len: int, num_buckets: int = 32,
                              max_distance: int = 128) -> np.ndarray:
    """Bidirectional T5 relative-position buckets, ``[q_len, k_len]`` int32."""
    ctx = np.arange(q_len, dtype=np.int64)[:, None]
    mem = np.arange(k_len, dtype=np.int64)[None, :]
    rel = mem - ctx
    nb = num_buckets // 2
    buckets = (rel > 0).astype(np.int64) * nb
    rel = np.abs(rel)
    max_exact = nb // 2
    large = max_exact + (
        np.log(np.maximum(rel, 1) / max_exact) / np.log(max_distance / max_exact) * (nb - max_exact)
    ).astype(np.int64)
    buckets += np.where(rel < max_exact, rel, np.minimum(large, nb - 1))
    return buckets.astype(np.int32)


class T5Attention(nn.Module):
    def __init__(self, cfg: T5Config, with_bias_table: bool, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(bias=False, device=device, dtype=dtype)
        self.q = nn.Linear(cfg.d_model, cfg.inner_dim, **kw)
        self.k = nn.Linear(cfg.d_model, cfg.inner_dim, **kw)
        self.v = nn.Linear(cfg.d_model, cfg.inner_dim, **kw)
        self.o = nn.Linear(cfg.inner_dim, cfg.d_model, **kw)
        if with_bias_table:
            self.relative_attention_bias = nn.Embedding(
                cfg.relative_attention_num_buckets, cfg.num_heads, device=device, dtype=dtype)
            self.relative_attention_bias.init_std = 0.02

    def position_bias(self, buckets: torch.Tensor) -> torch.Tensor:
        """This block's table over ``buckets`` [S, S] -> fp32 [1, H, S, S]."""
        return self.relative_attention_bias.weight.float()[buckets].permute(2, 0, 1)[None].contiguous()

    def forward(self, x: torch.Tensor, bias: torch.Tensor, kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, s, _ = x.shape
        nh, dk = self.cfg.num_heads, self.cfg.d_kv

        def heads(t):
            return t.view(b, s, nh, dk).transpose(1, 2)

        o = attention(heads(self.q(x)), heads(self.k(x)), heads(self.v(x)), scale=1.0, bias=bias, kv_len=kv_len)
        return self.o(o.transpose(1, 2).reshape(b, s, self.cfg.inner_dim))


class T5Block(nn.Module):
    def __init__(self, cfg: T5Config, with_bias_table: bool, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.attn_norm = L.RMSNorm(cfg.d_model, cfg.layer_norm_epsilon, **kw)
        self.attn = T5Attention(cfg, with_bias_table, **kw)
        self.ff_norm = L.RMSNorm(cfg.d_model, cfg.layer_norm_epsilon, **kw)
        self.wi_0 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False, **kw)
        self.wi_1 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False, **kw)
        self.wo = nn.Linear(cfg.d_ff, cfg.d_model, bias=False, **kw)

    def forward(self, x: torch.Tensor, bias: torch.Tensor, kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.attn(self.attn_norm(x), bias, kv_len)
        h = self.ff_norm(x)
        return x + self.wo(L.gelu_tanh(self.wi_0(h)) * self.wi_1(h))


class T5Encoder(nn.Module):
    def __init__(self, cfg: T5Config, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype)
        self.embed = nn.Embedding(cfg.vocab_size, cfg.d_model, **kw)
        self.blocks = nn.ModuleList(T5Block(cfg, cfg.per_layer_relative_bias or i == 0, **kw)
                                    for i in range(cfg.num_layers))
        self.final_norm = L.RMSNorm(cfg.d_model, cfg.layer_norm_epsilon, **kw)

    def forward(self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``input_ids`` [B, S] (and a 0/1 prefix ``attention_mask`` [B, S])
        -> last hidden state [B, S, d_model]."""
        cfg = self.cfg
        s = input_ids.shape[1]
        x = self.embed(input_ids)
        kv_len = None if attention_mask is None else attention_mask.sum(dim=1).to(torch.int32)
        buckets = relative_position_buckets(s, s, cfg.relative_attention_num_buckets,
                                            cfg.relative_attention_max_distance)
        idx = torch.from_numpy(buckets).to(device=x.device, dtype=torch.long)
        bias = self.blocks[0].attn.position_bias(idx)  # [1, H, S, S] fp32
        for i, blk in enumerate(self.blocks):
            if cfg.per_layer_relative_bias and i > 0:
                bias = blk.attn.position_bias(idx)
            x = blk(x, bias, kv_len)
        return self.final_norm(x)
