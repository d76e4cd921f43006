"""``benchmark/flops.py`` against counts worked by hand at the two cells' shapes."""

import json
import os

import pytest

from benchmark import flops
from benchmark import manifest as mf


def _cfg(name):
    return json.load(open(os.path.join(mf.ROOT, "benchmark", "configs", f"{name}.json")))["transformer"]


# (config, latent frames, latent h, latent w, video tokens, joint S, patch features, proj_out features, ofs)
SHAPES = [("cogvideox-5b-i2v", 13, 60, 90, 13 * 30 * 45, 226 + 17550, 32 * 4, 16 * 4, 0),
          ("cogvideox1.5-5b-i2v", 22, 96, 170, 11 * 48 * 85, 226 + 44880, 32 * 8, 16 * 8, 512)]


@pytest.mark.parametrize("name,f,h,w,sv,s,patch,out,ofs", SHAPES, ids=[s[0] for s in SHAPES])
def test_tokens_and_flops_by_hand(name, f, h, w, sv, s, patch, out, ofs):
    cfg = _cfg(name)
    d, te = 3072, 512
    assert flops.dit_tokens(cfg, f, h, w) == sv
    block = 24 * s * d * d + 2 * (2 * te * 6 * d)  # q, k, v, out and the FFN; the two AdaLN linears
    outside = 2 * sv * patch * d + 2 * 226 * 4096 * d + 2 * (d * te + te * te) + 2 * te * 2 * d + 2 * sv * d * out
    outside += 2 * 2 * ofs * ofs
    assert flops.dit_linear_flops(cfg, 226, sv) == 42 * block + outside
    assert flops.dit_attention_flops(cfg, 226, sv) == 42 * 4 * 48 * s * s * 64
    assert flops.dit_forward_flops(cfg, 226, sv) == 42 * block + outside + 42 * 4 * 48 * s * s * 64


def test_five_b_pass_counts():
    cfg = _cfg("cogvideox-5b-i2v")
    assert flops.dit_linear_flops(cfg, 226, 17550) == 169_125_411_553_280
    assert flops.dit_attention_flops(cfg, 226, 17550) == 163_079_201_488_896
    # a 2-pass forward is about 6.64e14 FLOP: 1.98 s at 33% of 989 TFLOP/s
    assert 6.6e14 < 2 * flops.dit_forward_flops(cfg, 226, 17550) < 6.7e14


@pytest.mark.parametrize("b,s,expected", [(2, 17776, 2 * 2 * 48 * 17776 * 64 * 2 + 2 * 17776 * 64 * 4 + 2 * 64 * 4),
                                          (2, 45106, 1_131_619_840)])
def test_qk_prep_bytes(b, s, expected):
    assert flops.qk_prep_bytes(b, 48, s, 64) == expected


def test_attention_flops_counts_two_products():
    assert flops.attention_flops(1, 1, 3, 5, 7) == 2 * (2 * 3 * 5 * 7)


def test_peaks():
    assert flops.PEAK_FLOPS_BF16 == 989e12 and flops.PEAK_BYTES == 3.35e12
