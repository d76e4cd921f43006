"""The port's CUDA kernels on the card against their plain PyTorch versions,
at small ragged shapes that ``chip_smoke.py``'s main-path shapes do not
reach: Sq != Sk, fewer keys than one 16-key chunk, a per-batch bias, a
query tile that is mostly past Sq, a single row, head dims 80 and 128,
``kv_len`` of 0, 1 and Sk, causal masks (Sq = Sk, Sq < Sk, Sq > Sk with its
zero rows, with ``kv_len`` and a per-batch bias), rope from S = 1 to 17,000
and qk_prep from S = 1 to 4,276 across their row tiles and head chunks
(B·H = 1, a short last chunk) on a transposed view, bit-equal to the call on
a contiguous copy, rope's identity rows bit-equal, small DiTs, a Llama and a CLIP text model card against
CPU, and the training kernels: the forward's LSE output and the dq and dkv
backward kernels at ragged shapes (Sq = 1, Sk = 1, ``kv_len`` 0/1/Sk, causal
with Sq > Sk, three head dims), the autograd graph that the three kernel
wrappers keep on the card, and a small LoRA train step card against CPU;
the int8 attention kernel against its plain version (its bf16 and its fp32
entry point; S = 1, 15-17, 31-33, 63-65, 127-129 and 1,500, ``kv_len`` 0 / 1 /
S, at chunk, key-tile and key-block edges and with whole key blocks masked,
both modes, both head dims, ``block_k`` 64 and 1,024), the fp32 ``"full"``
output rounded to bf16 against the bf16 route's bit for bit, their
routes and launch counts, the route through ``set_attention_int8`` and what
it refuses, and the flash kernel's qk prolog
(five combinations of norm, RoPE, ``stable`` and ``prolog_k`` at three head
dims, alone and with ``kv_len`` and ``causal``, and through
``attention(prolog=...)`` with and without a gradient; the ``qk_prolog``
kernel alone at ragged S and head counts across its row tiles and head
chunks, each norm, each head dim, both types, bit-equal to its plain
version in bf16 but for norm-rounding ties; the bf16 prolog call on the
tensor cores); and the bf16
tensor-core kernels (S = 1, 63, 65, 127, 129 and 4,276, Sq != Sk both ways,
``kv_len`` at 0, 1, either side of a 64-key tile and S, causal with Sq > Sk
and Sq < Sk, a bias at both batch strides, ``stable`` with logits near ±100
whose maximum moves in every key tile, D = 80, the LSE, and the LSE held to
the denominator of the TPU kernel at each head dim; dq and dkv at
ragged Sq and Sk with ``kv_len`` and causal), a bf16 gradient through a small
DiT card against CPU, the routes and the CUDA-core entry points' refusal of
bf16 (and each int8 entry's of the other type); and the register-tiled fp32 forward, dq and dkv kernels at the edges
of their tiles (S = 63, 64, 65 and a key tile ± 1; Sq = 1; ``kv_len`` 0, 1,
a key tile and one more; causal with Sq < Sk and Sq > Sk; a bias at both
batch strides with ``stable`` both ways; D = 80; the LSE; each block height
of the forward and dq, reached by the head count; Wan's cross-attention to
512 and 257 keys; logits near ±100 in fp32), each counted once under
``cuda_core``; and CogVideoX-1.5's joint lengths (S = 8,386 and 45,106 and
one row either side: qk_prep on the head-split view and the bf16 forward's
rows near both ends, the whole shipped [2, 48, 45106, 64] call) and a small
1.5 DiT card against CPU; the W8A8 / W4A8 linear (``ops/quant.py``) at rows
either side of ``torch._int_mm``'s least 17, its accumulators bit-equal to
the exact product and its backward against the CPU's, and a QLoRA step card
against CPU; and the Hopper forward (``csrc/flash_attention_wgmma.cu``,
bf16 at D = 64 and 128 without a bias) against the tensor-core arithmetic
over its 128-key tiles at ragged S (1, 129, 193, 1,000, 4,276), Sq != Sk
both ways, ``kv_len`` at 0, 1 and either side of a key tile, causal with
Sq < Sk and Sq > Sk, ``stable`` both ways and the LSE, at D = 64 bit-equal
to the ``"tc"`` kernel without a running max, at the DiTs' full lengths
([3, 48, 18002, 64], [2, 48, 45106, 64]; Wan's [3, 40, 32760, 128] self-
and cross-attention to 512 and 257 keys, HunyuanVideo's joint
[1, 24, 28128, 128] with ``kv_len``), and its entry points' refusals; and the
DiT blocks' AdaLN chain (``csrc/ada_norm.cu``) in each combination of residual
add, gate, norm, affine and modulation, one and two streams (a text stream of
0 rows among them), d = 40, 3,072 and 5,120, the branch output a strided
slice, against the plain composition (residuals bit for bit, normed rows
within a rounding at the norm), at the three cells' shipped lengths, its
gradients and its refusals. Every test is marked
``gpu`` and skips without a CUDA card. On a machine with one::

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_port_gpu.py -q

(``--noconftest``: the suite's ``conftest.py`` imports jax, which the port
does not need.) Nothing here imports jax.

Tolerances, as in ``chip_smoke.py``: fp32 with TF32 off, atol 2e-5 + rtol
1e-5 (only the summation order differs); bf16, atol 2e-2 + rtol 1e-2 (the
kernels round once at the end where the plain versions round after each
op, or round the probabilities before P·V: about two bf16 ulps). Attention
outputs shrink with the number of keys, so in bf16 the absolute part of
their tolerance is 5% of the reference's mean magnitude (over the rows
that see a key), at most 2e-2."""

import copy

import pytest
import torch

from alg_tpu_torch.models import layers as L
from alg_tpu_torch.ops import flash_attention as FA
from alg_tpu_torch.ops import qk_prep as QK
from alg_tpu_torch.ops import rope as RO

from quant_feed import qlora_step_agreement

pytestmark = pytest.mark.gpu

TOL = {torch.float32: (2e-5, 1e-5), torch.bfloat16: (2e-2, 1e-2)}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(gen, *shape, scale=1.0):
    return torch.randn(shape, generator=gen) * scale


def _assert_close(out, ref, dtype):
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(out.float().cpu(), ref.float().cpu(), atol=atol, rtol=rtol)


def _assert_close_flash(out, ref, dtype):
    atol, rtol = TOL[dtype]
    if dtype == torch.bfloat16:
        size = ref.float().abs()
        seen = size.sum(-1) > 0  # rows that see no key are exact zeros and say nothing of the outputs' size
        atol = min(atol, 0.05 * (size[seen].mean().item() if bool(seen.any()) else 0.0))
    torch.testing.assert_close(out.float().cpu(), ref.float().cpu(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("case", [
    dict(b=2, h=3, sq=300, sk=300, stable=False, bias=None),
    dict(b=2, h=3, sq=300, sk=300, stable=True, bias=None),
    dict(b=2, h=4, sq=70, sk=200, stable=True, bias="per_batch"),
    dict(b=1, h=2, sq=200, sk=7, stable=False, bias="shared"),
    dict(b=3, h=1, sq=1, sk=1, stable=True, bias=None),
], ids=["unstable-300", "stable-300", "per-batch-bias-sq70-sk200", "shared-bias-sk7", "one-row"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
def test_flash_kernel_matches_plain(cuda, case, dtype):
    gen = torch.Generator().manual_seed(0)
    b, h, sq, sk = case["b"], case["h"], case["sq"], case["sk"]
    q = _randn(gen, b, h, sq, 64).to(cuda, dtype)
    k, v = (_randn(gen, b, h, sk, 64).to(cuda, dtype) for _ in range(2))
    bias = None
    if case["bias"] is not None:
        bias = _randn(gen, b if case["bias"] == "per_batch" else 1, h, sq, sk, scale=2.0).to(cuda)
    scale = 1.0 if bias is not None else 64 ** -0.5
    before = FA.flash_attention.launches
    out = FA.flash_attention(q, k, v, scale, bias=bias, stable=case["stable"])
    torch.cuda.synchronize()
    assert FA.flash_attention.launches == before + 1
    assert out.shape == q.shape and out.dtype == dtype
    _assert_close_flash(out, FA.attention_plain(q, k, v, scale, bias), dtype)


@pytest.mark.parametrize("case", [
    dict(b=2, h=3, sq=300, sk=77, d=128, stable=False, bias=None, kv_len=None),
    dict(b=2, h=3, sq=130, sk=257, d=128, stable=True, bias=None, kv_len=None),
    dict(b=1, h=2, sq=200, sk=7, d=128, stable=False, bias=None, kv_len=None),
    dict(b=1, h=4, sq=257, sk=257, d=80, stable=True, bias=None, kv_len=None),
    dict(b=2, h=2, sq=70, sk=7, d=80, stable=False, bias=None, kv_len=None),
    dict(b=3, h=2, sq=90, sk=100, d=64, stable=True, bias=None, kv_len=[0, 1, 100]),
    dict(b=3, h=2, sq=90, sk=100, d=128, stable=False, bias=None, kv_len=[0, 1, 100]),
    dict(b=3, h=2, sq=65, sk=70, d=80, stable=True, bias=None, kv_len=[70, 0, 33]),
    dict(b=3, h=4, sq=70, sk=70, d=64, stable=True, bias="per_batch", kv_len=[70, 17, 1]),
    dict(b=2, h=4, sq=70, sk=70, d=64, stable=True, bias="shared", kv_len=[64, 65]),
    dict(b=2, h=2, sq=40, sk=150, d=128, stable=True, bias="per_batch", kv_len=[150, 31]),
], ids=["d128-unstable-sk77", "d128-stable-sk257", "d128-sk7", "d80-stable-257", "d80-unstable-sk7",
        "d64-kvlen-0-1-sk", "d128-kvlen-0-1-sk", "d80-kvlen", "d64-kvlen-per-batch-bias",
        "d64-kvlen-shared-bias", "d128-kvlen-per-batch-bias"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
def test_flash_kernel_head_dims_and_kv_len(cuda, case, dtype):
    gen = torch.Generator().manual_seed(3)
    b, h, sq, sk, d = case["b"], case["h"], case["sq"], case["sk"], case["d"]
    q = _randn(gen, b, h, sq, d).to(cuda, dtype)
    k, v = (_randn(gen, b, h, sk, d).to(cuda, dtype) for _ in range(2))
    bias = None
    if case["bias"] is not None:
        bias = _randn(gen, b if case["bias"] == "per_batch" else 1, h, sq, sk, scale=2.0).to(cuda)
    kv_len = None if case["kv_len"] is None else torch.tensor(case["kv_len"], dtype=torch.int32, device=cuda)
    scale = 1.0 / 8 if bias is not None else d ** -0.5
    before = FA.flash_attention.launches
    out = FA.flash_attention(q, k, v, scale, bias=bias, stable=case["stable"], kv_len=kv_len)
    torch.cuda.synchronize()
    assert FA.flash_attention.launches == before + 1
    assert out.shape == q.shape and out.dtype == dtype and bool(torch.isfinite(out).all())
    _assert_close_flash(out, FA.attention_plain(q, k, v, scale, bias, kv_len), dtype)
    if kv_len is not None:
        for i, n in enumerate(case["kv_len"]):
            if n == 0:
                assert not out[i].any()  # no key left: a zero row
            if n == 1:
                _assert_close(out[i], v[i, :, :1].expand_as(out[i]), dtype)


@pytest.mark.parametrize("case", [
    dict(b=3, h=1, sq=1, sk=1, stable=True, bias=None, kv_len=None),
    dict(b=1, h=12, sq=77, sk=77, stable=True, bias=None, kv_len=None),  # CLIP text's length
    dict(b=2, h=3, sq=300, sk=300, stable=True, bias=None, kv_len=None),
    dict(b=2, h=3, sq=300, sk=300, stable=False, bias=None, kv_len=None),
    dict(b=2, h=2, sq=70, sk=200, stable=True, bias=None, kv_len=None),  # Sq < Sk: every row sees the 130-key offset
    dict(b=2, h=2, sq=200, sk=70, stable=True, bias=None, kv_len=None),  # Sq > Sk: the first 130 rows see nothing
    dict(b=2, h=2, sq=200, sk=70, stable=False, bias=None, kv_len=None),
    dict(b=3, h=2, sq=100, sk=100, stable=True, bias=None, kv_len=[0, 1, 100]),
    dict(b=3, h=2, sq=100, sk=100, stable=False, bias=None, kv_len=[0, 1, 100]),
    dict(b=2, h=2, sq=90, sk=130, stable=True, bias=None, kv_len=[130, 57]),
    dict(b=2, h=4, sq=70, sk=70, stable=True, bias="per_batch", kv_len=None),
    dict(b=2, h=4, sq=70, sk=90, stable=False, bias="per_batch", kv_len=[90, 33]),
], ids=["one-row", "sq77", "stable-300", "unstable-300", "sq70-sk200", "sq200-sk70", "sq200-sk70-unstable",
        "kvlen-0-1-sk", "kvlen-0-1-sk-unstable", "offset-kvlen", "per-batch-bias", "per-batch-bias-kvlen"])
@pytest.mark.parametrize("d", [64, 80, 128])
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
def test_flash_kernel_causal(cuda, case, d, dtype):
    """Query i sees key j iff j <= i + (Sk - Sq) and j < kv_len; a row that
    sees no key is zero."""
    gen = torch.Generator().manual_seed(6)
    b, h, sq, sk = case["b"], case["h"], case["sq"], case["sk"]
    q = _randn(gen, b, h, sq, d).to(cuda, dtype)
    k, v = (_randn(gen, b, h, sk, d).to(cuda, dtype) for _ in range(2))
    bias = None
    if case["bias"] is not None:
        bias = _randn(gen, b, h, sq, sk, scale=2.0).to(cuda)
    kv_len = None if case["kv_len"] is None else torch.tensor(case["kv_len"], dtype=torch.int32, device=cuda)
    scale = 1.0 / 8 if bias is not None else d ** -0.5
    before = FA.flash_attention.launches
    out = FA.flash_attention(q, k, v, scale, bias=bias, stable=case["stable"], kv_len=kv_len, causal=True)
    torch.cuda.synchronize()
    assert FA.flash_attention.launches == before + 1
    assert out.shape == q.shape and out.dtype == dtype and bool(torch.isfinite(out).all())
    _assert_close_flash(out, FA.attention_plain(q, k, v, scale, bias, kv_len, causal=True), dtype)
    # the visible-key count of each row, reckoned here: zero rows and one-key rows
    lens = [sk] * b if case["kv_len"] is None else case["kv_len"]
    for bi, n in enumerate(lens):
        for row in range(sq):
            seen = max(0, min(n, row + sk - sq + 1))
            if seen == 0:
                assert not out[bi, :, row].any()
            elif seen == 1:
                _assert_close(out[bi, :, row], v[bi, :, 0], dtype)


def test_flash_kernel_stays_finite_on_rows_masked_by_the_bias(cuda):
    """A bias of -inf over every key of a row, or over a whole 16-key chunk,
    gives zeros or the softmax over the rest: never NaN (stable path)."""
    gen = torch.Generator().manual_seed(4)
    q, k, v = (_randn(gen, 1, 2, 40, 64).to(cuda) for _ in range(3))
    bias = torch.zeros(1, 2, 40, 40, device=cuda)
    bias[:, :, 3] = float("-inf")  # row 3 sees nothing
    bias[:, :, 5, :16] = float("-inf")  # row 5: first chunk fully masked
    out = FA.flash_attention(q, k, v, 0.125, bias=bias, stable=True)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all()) and not out[:, :, 3].any()
    ref = FA.attention_plain(q, k, v, 0.125, bias)
    rows = [i for i in range(40) if i != 3]
    _assert_close(out[:, :, rows], ref[:, :, rows], torch.float32)


def _rope_chunk(bh: int) -> int:
    """Heads a block of the rope kernel walks (csrc/rope.cu's launcher): B·H in as few chunks of at most 8
    as there can be, all but the last of one size."""
    chunks = -(-bh // 8)
    return -(-bh // chunks)


ROPE_CASES = {
    # name: (b, h, s); rows an S tile: 256 threads over D·(bytes a value)/16 threads a row (8 to 32 rows)
    "s1": (2, 3, 1),
    "s15": (1, 5, 15),
    "bh1-s17": (1, 1, 17),
    "bh1-s33": (1, 1, 33),
    "s257": (1, 7, 257),
    "s300": (2, 3, 300),
    "chunks-5-4-s65": (3, 3, 65),
    "chunks-ragged-s300": (1, 100, 300),  # 12 chunks of 8 heads and one of 4
    "s17000": (1, 6, 17000),
}


@pytest.mark.parametrize("case", list(ROPE_CASES))
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
def test_rope_kernel_matches_plain(cuda, case, d, dtype):
    """On the transposed view the models pass (the [B, S, H, D] projection
    seen as [B, H, S, D]) and on a contiguous tensor, at S on either side of
    the kernel's row tiles, B·H = 1, and B·H cut into head chunks with a
    short last chunk; the last quarter of the rows has cos = 1, sin = 0 (the
    Hunyuan text rows) and comes back bit-equal."""
    b, h, s = ROPE_CASES[case]
    if case.startswith("chunks"):
        assert (b * h) % _rope_chunk(b * h) != 0  # the last chunk is short
    gen = torch.Generator().manual_seed(5)
    base = _randn(gen, b, s, h, d).to(cuda, dtype)  # [B, S, H, D]
    ang = torch.rand((s, d // 2), generator=gen) * 6.28
    ang[s - s // 4:] = 0.0
    cos = torch.cos(ang).repeat_interleave(2, -1).to(cuda)
    sin = torch.sin(ang).repeat_interleave(2, -1).to(cuda)
    for x in (base.transpose(1, 2), base.transpose(1, 2).contiguous()):
        before = RO.rope_interleaved.launches
        out = RO.rope_interleaved(x, cos, sin)
        torch.cuda.synchronize()
        assert RO.rope_interleaved.launches == before + 1
        assert out.shape == x.shape and out.is_contiguous() and out.dtype == dtype
        _assert_close(out, RO.apply_rope_interleaved(x, cos, sin), dtype)
        assert torch.equal(out[:, :, s - s // 4:], x[:, :, s - s // 4:])


QK_CASES = {
    # name: (b, h, s); rows an S tile: 256 threads over 8 (bf16) or 16 (fp32) threads a row, so 32 or 16 rows
    "s1": (2, 3, 1),
    "s15": (1, 5, 15),
    "bh1-s17": (1, 1, 17),
    "s31": (2, 3, 31),
    "bh1-s33": (1, 1, 33),
    "s300": (2, 3, 300),
    "chunks-5-4-s65": (3, 3, 65),
    "chunks-ragged-s300": (1, 100, 300),  # 12 chunks of 8 heads and one of 4
    "s4276": (1, 6, 4276),
}


@pytest.mark.parametrize("case", list(QK_CASES))
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
def test_qk_prep_kernel_matches_plain(cuda, case, dtype):
    """On the transposed view the CogVideoX DiT passes (the [B, S, H, D]
    projection seen as [B, H, S, D]) and on a contiguous copy, bit-equal, at
    S on either side of the kernel's row tiles, B·H = 1, and B·H cut into head
    chunks with a short last chunk; within the bf16 or fp32 tolerance of the
    plain version. The first third of the rows has cos = 1, sin = 0 (the text
    prefix): there the output is the LayerNorm's, up to one rounding step of
    the activation dtype (the two reduce mean and variance in other orders)."""
    b, h, s = QK_CASES[case]
    if case.startswith("chunks"):
        assert (b * h) % _rope_chunk(b * h) != 0  # the last chunk is short
    gen = torch.Generator().manual_seed(1)
    base = _randn(gen, b, s, h, 64).to(cuda, dtype)  # [B, S, H, D]
    scale, bias = (1.0 + _randn(gen, 64, scale=0.1)).to(cuda), _randn(gen, 64, scale=0.1).to(cuda)
    ang = torch.rand((s, 32), generator=gen) * 6.28
    n_id = max(1, s // 3)
    ang[:n_id] = 0.0  # identity rows, as over the DiT's text prefix
    cos = torch.cos(ang).repeat_interleave(2, -1).to(cuda)
    sin = torch.sin(ang).repeat_interleave(2, -1).to(cuda)
    outs = []
    for x in (base.transpose(1, 2), base.transpose(1, 2).contiguous()):
        before = QK.qk_norm_rope.launches
        out = QK.qk_norm_rope(x, scale, bias, cos, sin, 1e-6)
        torch.cuda.synchronize()
        assert QK.qk_norm_rope.launches == before + 1
        assert out.shape == x.shape and out.is_contiguous() and out.dtype == dtype
        _assert_close(out, QK.qk_norm_rope_plain(x, scale, bias, cos, sin, 1e-6), dtype)
        ln = L.layer_norm(x[:, :, :n_id], scale, bias, 1e-6)
        atol, rtol = (2e-6, 1e-6) if dtype == torch.float32 else (1e-6, 8e-3)
        torch.testing.assert_close(out[:, :, :n_id].float(), ln.float(), atol=atol, rtol=rtol)
        outs.append(out)
    assert torch.equal(outs[0], outs[1])


def test_cuda_wrappers_raise_instead_of_falling_back(cuda):
    """What the kernels do not take raises on the card; nothing launches and
    nothing runs the plain version instead."""
    q = torch.zeros(1, 2, 8, 64, device=cuda)
    ones, zeros = torch.ones(64, device=cuda), torch.zeros(64, device=cuda)
    tab = torch.ones(8, 64, device=cuda)
    before = (FA.flash_attention.launches, QK.qk_norm_rope.launches, RO.rope_interleaved.launches)
    with pytest.raises(TypeError):
        FA.flash_attention(q.half(), q.half(), q.half(), 0.125)
    with pytest.raises(ValueError):
        FA.flash_attention(torch.zeros(1, 8, 2, 64, device=cuda).transpose(1, 2), q, q, 0.125)
    with pytest.raises(ValueError):
        wide = torch.zeros(1, 2, 8, 96, device=cuda)
        FA.flash_attention(wide, wide, wide, 0.125)
    with pytest.raises(ValueError):
        FA.flash_attention(q, q, q, 0.125, kv_len=torch.tensor([8], device=cuda))  # int64
    with pytest.raises(ValueError):
        RO.rope_interleaved(torch.zeros(1, 2, 8, 12, device=cuda), torch.ones(8, 12, device=cuda),
                            torch.zeros(8, 12, device=cuda))
    with pytest.raises(TypeError):
        RO.rope_interleaved(q.half(), tab, tab)
    with pytest.raises(TypeError):
        QK.qk_norm_rope(q.half(), ones, zeros, tab, tab, 1e-6)
    with pytest.raises(ValueError):
        QK.qk_norm_rope(q, ones, zeros, tab.half(), tab, 1e-6)
    assert (FA.flash_attention.launches, QK.qk_norm_rope.launches, RO.rope_interleaved.launches) == before


def test_dit_forward_card_matches_cpu(cuda):
    """A 2-layer DiT with head dim 64, fp32: the card through both kernels,
    the CPU through the plain versions. atol 1e-4, the bound the CPU tests
    hold whole forwards to (summation order compounds over the layers)."""
    from alg_tpu_torch.models.cogvideox.transformer import (CogVideoXTransformer, CogVideoXTransformerConfig,
                                                            cogvideox_rope)

    cfg = CogVideoXTransformerConfig(num_attention_heads=2, attention_head_dim=64, in_channels=8, out_channels=4,
                                     time_embed_dim=32, text_embed_dim=64, num_layers=2, sample_height=8,
                                     sample_width=8, max_text_seq_length=8)
    gen = torch.Generator().manual_seed(2)
    dit = L.init_random_(CogVideoXTransformer(cfg), gen)
    x, text = _randn(gen, 2, 3, 8, 8, 8), _randn(gen, 2, 8, 64)
    ts = torch.tensor([999.0, 400.0])
    cos, sin = (torch.from_numpy(a) for a in cogvideox_rope(cfg, 64, 64, 3))
    from alg_tpu_torch.ops.ada_norm import ada_norm

    with torch.no_grad():
        ref = dit(x, text, ts, cos, sin)
        before = (QK.qk_norm_rope.launches, FA.flash_attention.launches, ada_norm.launches)
        out = copy.deepcopy(dit).to(cuda)(*(a.to(cuda) for a in (x, text, ts, cos, sin)))
        torch.cuda.synchronize()
    assert (QK.qk_norm_rope.launches - before[0], FA.flash_attention.launches - before[1]) == (4, 2)
    assert ada_norm.launches - before[2] == 3 * 2  # three a block: norm1, gate + norm2, gate
    torch.testing.assert_close(out.cpu(), ref, atol=1e-4, rtol=0)


def test_hunyuan_dit_forward_card_matches_cpu(cuda):
    """A Hunyuan DiT of one double, one single and one refiner block at head
    dim 128, fp32, with a padded text mask: the card through the flash kernel
    (the joint ``kv_len``, the refiner's) and the rope kernel (identity rows
    over the text suffix), the CPU through the plain versions. atol 1e-4, as
    for the other whole forwards."""
    from alg_tpu_torch.models.hunyuan.transformer import (HunyuanVideoTransformer, HunyuanVideoTransformerConfig,
                                                          hunyuan_rope)

    cfg = HunyuanVideoTransformerConfig(in_channels=4, out_channels=4, num_attention_heads=2, attention_head_dim=128,
                                        num_layers=1, num_single_layers=1, num_refiner_layers=1, mlp_ratio=2.0,
                                        text_embed_dim=16, pooled_projection_dim=8)
    gen = torch.Generator().manual_seed(3)
    dit = L.init_random_(HunyuanVideoTransformer(cfg), gen)
    x, text, pooled = _randn(gen, 2, 4, 3, 8, 8), _randn(gen, 2, 9, 16), _randn(gen, 2, 8)
    ts, guidance = torch.tensor([999.0, 400.0]), torch.full((2,), 6000.0)
    mask = torch.tensor([[1] * 9, [1] * 5 + [0] * 4], dtype=torch.int32)
    cos, sin = hunyuan_rope(cfg, 3, 8, 8)
    with torch.no_grad():
        ref = dit(x, ts, text, mask, pooled, guidance, cos, sin)
        before = (RO.rope_interleaved.launches, FA.flash_attention.launches)
        out = copy.deepcopy(dit).to(cuda)(*(a.to(cuda) for a in (x, ts, text, mask, pooled, guidance)), cos, sin)
        torch.cuda.synchronize()
    assert (RO.rope_interleaved.launches - before[0], FA.flash_attention.launches - before[1]) == (4, 3)
    torch.testing.assert_close(out.cpu(), ref, atol=1e-4, rtol=0)


def test_llama_and_clip_text_card_match_cpu(cuda):
    """Two Llama layers at head dim 128 (causal with ``kv_len``, GQA) and two
    CLIP text layers at head dim 64 (causal), fp32, card against CPU."""
    from alg_tpu_torch.models.clip import CLIPTextConfig, CLIPTextModel
    from alg_tpu_torch.models.llama import LlamaConfig, LlamaModel

    gen = torch.Generator().manual_seed(4)
    llama = L.init_random_(LlamaModel(LlamaConfig(vocab_size=64, hidden_size=256, intermediate_size=128,
                                                  num_hidden_layers=2, num_attention_heads=2,
                                                  num_key_value_heads=1)), gen)
    embeds, kv_len = _randn(gen, 2, 40, 256), torch.tensor([40, 17], dtype=torch.int32)
    clip = L.init_random_(CLIPTextModel(CLIPTextConfig(vocab_size=64, hidden_size=128, intermediate_size=64,
                                                       num_hidden_layers=2, num_attention_heads=2,
                                                       max_position_embeddings=20, eos_token_id=63)), gen)
    ids = torch.randint(0, 63, (2, 20), generator=gen)
    ids[:, 11] = 63
    with torch.no_grad():
        ref_l, (ref_h, ref_p) = llama(embeds, None, kv_len), clip(ids)
        before = FA.flash_attention.launches
        out_l = copy.deepcopy(llama).to(cuda)(embeds.to(cuda), None, kv_len.to(cuda))
        out_h, out_p = copy.deepcopy(clip).to(cuda)(ids.to(cuda))
        torch.cuda.synchronize()
    assert FA.flash_attention.launches - before == 4
    for a, b in zip(out_l, ref_l):
        torch.testing.assert_close(a.cpu(), b, atol=1e-4, rtol=0)
    torch.testing.assert_close(out_h.cpu(), ref_h, atol=1e-4, rtol=0)
    torch.testing.assert_close(out_p.cpu(), ref_p, atol=1e-4, rtol=0)


# -- training kernels: the forward's LSE output, dq and dkv ----------------------------------


def _assert_close_grad(out, ref, dtype):
    """As ``_assert_close_flash``, but never tighter than the fp32 bound:
    where a gradient cancels (with one visible key ds = dp - delta is 0 in
    exact arithmetic) the reference is rounding noise and its size says
    nothing."""
    atol, rtol = TOL[dtype]
    if dtype == torch.bfloat16:
        atol = max(TOL[torch.float32][0], min(atol, 0.05 * ref.float().abs().mean().item()))
    torch.testing.assert_close(out.float().cpu(), ref.float().cpu(), atol=atol, rtol=rtol)


def _key_tile(q, bias=None):
    """Keys a tile of the bf16 kernel a call on the card takes (``FA.route``): the steps of a stable call's
    running max."""
    return FA.KEY_TILE[FA.route(q, bias=bias)]


def _assert_lse_close(lse, q, k, scale, bias, kv_len, causal, stable):
    """The forward's LSE within 1e-4 (base-2 units) of its plain version on
    the rows that see a key, with -inf on the same rows. The plain version
    is the kernel's denominator: for bf16 (the tensor-core forwards, over the
    key tiles of the one the call takes) ``tensor_core_lse_plain``, the TPU
    kernel's, which at D = 64 and 80 sums
    the bf16-rounded p, so a p on a rounding tie may round the other way in
    the kernel and add that function's ``tie`` to the bound; for fp32
    ``attention_plain_residuals``."""
    if q.dtype == torch.bfloat16:
        ref, tie = FA.tensor_core_lse_plain(q, k, scale, bias, kv_len, causal, stable, key_tile=_key_tile(q, bias))
    else:
        ref, tie = FA.attention_plain_residuals(q, k, k, scale, bias, kv_len, causal)[1], 0.0
    assert torch.equal(torch.isneginf(lse), torch.isneginf(ref))
    seen = torch.isfinite(ref)
    excess = (lse - ref).abs() - (1e-4 + torch.as_tensor(tie, device=lse.device))
    assert not bool((excess[seen] > 0).any()), f"LSE out by {float(excess[seen].max()):.3e} beyond its bound"
    return seen


BWD_CASES = {
    # name: (b, h, sq, sk, causal, kv_len, stable)
    "ragged-331x203": (2, 3, 331, 203, False, None, False),
    "one-query": (2, 2, 1, 77, False, None, True),
    "one-key": (1, 2, 50, 1, False, None, True),
    "kv_len-0-1-sk": (3, 2, 130, 97, False, [0, 1, 97], False),
    "causal-square-150": (1, 2, 150, 150, True, None, True),
    "causal-sq-lt-sk": (2, 2, 67, 160, True, [160, 90], True),
    "causal-sq-gt-sk": (1, 3, 140, 45, True, None, False),  # its first 95 rows see no key
}


@pytest.mark.parametrize("case", list(BWD_CASES))
@pytest.mark.parametrize("d", [64, 80, 128])
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
def test_lse_and_backward_kernels_match_plain(cuda, case, d, dtype):
    """The LSE within 1e-4 (base-2 units) of the kernel's denominator with
    -inf on the same rows (``_assert_lse_close``); dq, dk and dv within the
    attention tolerance above, exactly 0 where no key or no query reaches."""
    from alg_tpu_torch.ops import flash_attention_bwd as FB

    b, h, sq, sk, causal, kv_len, stable = BWD_CASES[case]
    gen = torch.Generator().manual_seed(1)
    q, do = (_randn(gen, b, h, sq, d).to(cuda, dtype) for _ in range(2))
    k, v = (_randn(gen, b, h, sk, d).to(cuda, dtype) for _ in range(2))
    lens = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32, device=cuda)
    scale = d ** -0.5
    before = (FA.flash_attention.residual_launches, FB.flash_attention_bwd_dq.launches,
              FB.flash_attention_bwd_dkv.launches)
    out, lse = FA.flash_attention(q, k, v, scale, stable=stable, kv_len=lens, causal=causal, return_residuals=True)
    assert torch.equal(out, FA.flash_attention(q, k, v, scale, stable=stable, kv_len=lens, causal=causal))
    seen = _assert_lse_close(lse, q, k, scale, None, lens, causal, stable)
    assert not out[~seen].any()

    got = FB.flash_attention_bwd(q, k, v, out, lse, do, scale, causal, lens)
    torch.cuda.synchronize()
    assert (FA.flash_attention.residual_launches, FB.flash_attention_bwd_dq.launches,
            FB.flash_attention_bwd_dkv.launches) == tuple(n + 1 for n in before)
    ref = FB.flash_attention_bwd_plain(q, k, v, out, lse, do, scale, causal, lens)
    for g, r in zip(got, ref):
        assert torch.isfinite(g).all()
        _assert_close_grad(g, r, dtype)
    assert not got[0][~seen].any()  # a row without keys: dq = 0
    if kv_len is not None:
        dead = torch.arange(sk, device=cuda)[None, :] >= lens[:, None]  # [B, Sk]: keys past kv_len
        for g in got[1:]:
            assert not g.transpose(1, 2)[dead].any()


def test_backward_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    from alg_tpu_torch.ops import flash_attention_bwd as FB

    q, k, v, do = (torch.randn(1, 2, 9, 64, device=cuda) for _ in range(4))
    out, lse = FA.flash_attention(q, k, v, 0.125, return_residuals=True)
    delta = FB.row_delta(out, do)
    with pytest.raises(ValueError):
        FB.flash_attention_bwd_dq(q, k, v, do, lse.double(), delta, 0.125)
    with pytest.raises(ValueError):
        FB.flash_attention_bwd_dkv(q, k, v, do.transpose(1, 2).contiguous().transpose(1, 2), lse, delta, 0.125)
    with pytest.raises(TypeError):
        FB.flash_attention_bwd_dq(q.half(), k.half(), v.half(), do.half(), lse, delta, 0.125)
    with pytest.raises(RuntimeError):  # the bare kernel wrapper records no graph and says so
        FA.flash_attention(q.requires_grad_(), k, v, 0.125)


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
def test_cuda_inputs_that_require_grad_get_a_grad_fn_from_all_three_wrappers(cuda, dtype):
    """The three kernel wrappers keep the autograd graph on the card, and
    their gradients agree with autograd through the plain versions."""
    from alg_tpu_torch.models.rope import apply_rope_interleaved
    from alg_tpu_torch.ops import flash_attention_bwd as FB
    from alg_tpu_torch.ops.attention import attention

    gen = torch.Generator().manual_seed(2)
    s, d = 75, 64
    ang = torch.rand(s, d // 2, generator=gen) * 6.28
    cos, sin = (f(ang).repeat_interleave(2, -1).contiguous().to(cuda) for f in (torch.cos, torch.sin))
    x = _randn(gen, 2, 3, s, d).to(cuda, dtype).requires_grad_()
    scale = (1.0 + 0.1 * _randn(gen, d)).to(cuda).requires_grad_()
    bias = (0.1 * _randn(gen, d)).to(cuda).requires_grad_()
    g = _randn(gen, 2, 3, s, d).to(cuda, dtype)

    launched = QK.qk_norm_rope.launches
    y = QK.qk_norm_rope(x, scale, bias, cos, sin, 1e-6)
    assert y.grad_fn is not None and QK.qk_norm_rope.launches == launched + 1
    got = torch.autograd.grad(y, (x, scale, bias), g)
    ref = torch.autograd.grad(QK.qk_norm_rope_plain(x, scale, bias, cos, sin, 1e-6), (x, scale, bias), g)
    for a, r in zip(got, ref):
        assert torch.equal(a, r)  # the backward is the plain composition's own

    xt = _randn(gen, 2, s, 3, d).to(cuda, dtype).transpose(1, 2).requires_grad_()  # a strided view, as Wan passes it
    launched = RO.rope_interleaved.launches
    y = RO.rope_interleaved(xt, cos, sin)
    assert y.grad_fn is not None and RO.rope_interleaved.launches == launched + 1
    got, = torch.autograd.grad(y, (xt,), g)
    ref, = torch.autograd.grad(apply_rope_interleaved(xt, cos, sin), (xt,), g)
    assert torch.equal(got, ref)

    q, k, v = (_randn(gen, 2, 3, s, d).to(cuda, dtype).requires_grad_() for _ in range(3))
    lens = torch.tensor([s, 40], dtype=torch.int32, device=cuda)
    counts = (FA.flash_attention.launches, FA.flash_attention.residual_launches, FB.flash_attention_bwd_dq.launches)
    o = attention(q, k, v, kv_len=lens, stable=False)
    assert o.grad_fn is not None
    assert (FA.flash_attention.launches, FA.flash_attention.residual_launches) == (counts[0] + 1, counts[1] + 1)
    got = torch.autograd.grad(o, (q, k, v), g)
    assert FB.flash_attention_bwd_dq.launches == counts[2] + 1
    ref = torch.autograd.grad(FA.attention_plain(q, k, v, d ** -0.5, None, lens), (q, k, v), g)
    for a, r in zip(got, ref):
        _assert_close_grad(a, r, dtype)
    # without a gradient: the same single launch as before, no residual, no graph
    counts = (FA.flash_attention.launches, FA.flash_attention.residual_launches)
    with torch.no_grad():
        assert attention(q, k, v, kv_len=lens).grad_fn is None
    assert attention(q.detach(), k.detach(), v.detach(), kv_len=lens).grad_fn is None
    assert (FA.flash_attention.launches, FA.flash_attention.residual_launches) == (counts[0] + 2, counts[1])


def test_attention_with_bias_differentiates_on_the_card(cuda):
    from alg_tpu_torch.ops.attention import attention

    gen = torch.Generator().manual_seed(3)
    q, k, v = (_randn(gen, 1, 2, 33, 64).to(cuda).requires_grad_() for _ in range(3))
    bias = _randn(gen, 1, 2, 33, 33).to(cuda).requires_grad_()
    g = _randn(gen, 1, 2, 33, 64).to(cuda)
    o = attention(q, k, v, scale=1.0, bias=bias)
    got = torch.autograd.grad(o, (q, k, v, bias), g)
    ref = torch.autograd.grad(FA.attention_plain(q, k, v, 1.0, bias), (q, k, v, bias), g)
    for a, r in zip(got, ref):
        assert torch.equal(a, r)  # the recompute VJP through the plain version


def test_lora_train_step_card_matches_cpu(cuda):
    """Two LoRA steps on a small Wan DiT (head dim 128, rope and cross
    attention through the kernels and their backward), remat on: card
    against CPU, fp32, losses rtol 1e-4, adapters atol 1e-4; then the
    gradients of one loss, card against CPU."""
    from alg_tpu_torch.models.wan.transformer import WanTransformer, WanTransformerConfig, wan_rope
    from alg_tpu_torch.training.lora import init_lora_params, make_lora_loss
    from alg_tpu_torch.training.losses import make_wan_flow_loss
    from alg_tpu_torch.core.remat import remat_blocks
    from alg_tpu_torch.training.train import TrainConfig, make_train_step, tree_leaves, tree_map, tree_unflatten

    cfg = WanTransformerConfig(num_attention_heads=2, attention_head_dim=128, in_channels=12, out_channels=4,
                               num_layers=2, ffn_dim=64, freq_dim=16, text_dim=64, image_dim=160)
    gen = torch.Generator().manual_seed(5)
    model = L.init_random_(WanTransformer(cfg), gen).requires_grad_(False)
    loras0 = init_lora_params(gen, dict(model.named_parameters()), rank=4, prefixes=("blocks",))
    cos, sin = wan_rope(cfg, 3, 8, 8)
    batch = {"latents": _randn(gen, 2, 4, 3, 8, 8), "condition": _randn(gen, 2, 8, 3, 8, 8),
             "encoder_hidden_states": _randn(gen, 2, 9, 64), "encoder_hidden_states_image": _randn(gen, 2, 5, 160)}
    draws = {"sigma": torch.rand(2, generator=gen), "noise": _randn(gen, 2, 4, 3, 8, 8)}
    runs = {}
    for dev in ("cpu", cuda):
        dit = copy.deepcopy(model).to(dev)
        loras = tree_map(lambda t: t.clone().to(dev).requires_grad_(), loras0)
        loss = make_lora_loss(make_wan_flow_loss(dit, rope_cos=cos, rope_sin=sin), dict(dit.named_parameters()),
                              scale=2.0, attach=True)
        # eps 1e-4: AdamW's update is sign-like (lr·g/(|g| + eps)); with the default 1e-8 an element whose
        # gradient is rounding noise moves by up to lr in a direction that differs between card and CPU
        step, opt = make_train_step(loss, TrainConfig(learning_rate=1e-2, eps=1e-4, remat=True))
        state, losses = opt.init(loras), []
        for _ in range(2):
            loras, state, m = step(loras, state, {n: t.to(dev) for n, t in batch.items()},
                                   {n: t.to(dev) for n, t in draws.items()})
            losses.append(float(m["loss"]))
        runs[str(dev)] = (losses, [leaf.detach().cpu() for leaf in tree_leaves(loras)], loss)
    (l_c, p_c, loss_c), (l_g, p_g, loss_g) = runs["cpu"], runs[str(cuda)]
    torch.testing.assert_close(torch.tensor(l_g), torch.tensor(l_c), rtol=1e-4, atol=0)
    for a, b in zip(p_g, p_c):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=0)
    # with no optimizer (and no eps) between: the gradients of one loss at the CPU run's adapters, where A
    # and B are both nonzero, within 1e-4 of each leaf's largest value
    grads = {}
    for dev, loss in (("cpu", loss_c), (cuda, loss_g)):
        at = tree_map(lambda t: t.clone().to(dev).requires_grad_(), tree_unflatten(loras0, p_c))
        with remat_blocks(True):
            value = loss(at, {n: t.to(dev) for n, t in batch.items()}, {n: t.to(dev) for n, t in draws.items()})
        grads[str(dev)] = [g.cpu() for g in torch.autograd.grad(value, tree_leaves(at))]
    for a, b in zip(grads[str(cuda)], grads["cpu"]):
        assert float(b.abs().max()) > 0
        torch.testing.assert_close(a, b, atol=1e-4 * float(b.abs().max()), rtol=0)


# -- int8 attention and the qk prolog ----------------------------------------------------------------------------


def _dit_like_qkv(gen, b, h, s, d):
    """Unit-norm rows times sqrt(D) for q and k, as after a per-head norm, a
    common-mode offset on k that the mean-centring removes, and normal v."""
    q, k = (_randn(gen, b, h, s, d) for _ in range(2))
    q, k = (t / t.norm(dim=-1, keepdim=True) * d ** 0.5 for t in (q, k))
    return q, k + 3.0 * _randn(gen, b, h, 1, d), _randn(gen, b, h, s, d)


INT8_CASES = {
    "one-row": dict(b=2, h=2, s=1, kv_len=None),
    "s15": dict(b=1, h=2, s=15, kv_len=None),
    "s16": dict(b=1, h=3, s=16, kv_len=None),  # one m16 row tile: a warp's rows in fp32 "qk" at D = 128
    "s17": dict(b=1, h=2, s=17, kv_len=None),
    "s31": dict(b=1, h=2, s=31, kv_len=None),
    "s32": dict(b=1, h=2, s=32, kv_len=None),  # one 32-key chunk of a key tile
    "s33": dict(b=1, h=2, s=33, kv_len=None),
    "s63": dict(b=1, h=3, s=63, kv_len=None),
    "s64": dict(b=1, h=3, s=64, kv_len=None),  # one key tile; the "full" rows of a block at D = 128
    "s65": dict(b=1, h=3, s=65, kv_len=None),
    "s127": dict(b=1, h=2, s=127, kv_len=None),
    "s128": dict(b=1, h=2, s=128, kv_len=None),  # the query rows of a block
    "s129": dict(b=1, h=2, s=129, kv_len=None),
    "s1500": dict(b=2, h=2, s=1500, kv_len=None),  # no multiple of 64, 512 or 1024
    "kvlen-0-1-s": dict(b=3, h=2, s=200, kv_len=[0, 1, 200]),
    "kvlen-chunk-edges": dict(b=3, h=2, s=200, kv_len=[31, 32, 33]),  # a 32-key chunk of P
    "kvlen-tile-edges": dict(b=3, h=2, s=200, kv_len=[63, 64, 65]),
    "kvlen-block-edges": dict(b=3, h=1, s=1100, kv_len=[1023, 1024, 1025]),  # at block_k = 1,024
    "kvlen-blocks-past": dict(b=2, h=2, s=1100, kv_len=[70, 1030]),  # whole tiles and a whole key block masked
}
BF16_STEP = 2.0 ** -7  # the spacing of bf16 values in [1, 2): one step at x is at most BF16_STEP·|x|


@pytest.fixture
def full_fp32_reductions(cuda):
    """bf16 products of the plain version with fp32 partial sums (cuBLAS may otherwise reduce in bf16)."""
    kept = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    yield
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = kept


@pytest.mark.parametrize("case", list(INT8_CASES))
@pytest.mark.parametrize("block_k", [64, 1024], ids=["bk64", "bk1024"])
@pytest.mark.parametrize("pv_int8", [False, True], ids=["qk", "full"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
def test_int8_kernel_matches_plain(cuda, full_fp32_reductions, case, block_k, pv_int8, d, dtype):
    """The int8 kernel against its plain version on the card: bf16 inputs
    through its bf16 entry, fp32 through its fp32 one. fp32 ``"qk"``:
    atol 2e-5 + rtol 2e-5 (the same codes and scales; only the order of the
    fp32 sums differs). ``"full"``: mean under 1e-5 and max under 2e-3 in
    fp32, since a P code on a rounding tie may flip (one code is 1/127 of a
    row's largest p); in bf16 the bf16 attention tolerance. bf16 ``"qk"``:
    one bf16 step of the plain version, since both round P to bf16 alike
    (rtol 2**-7, and atol 2**-7 of the output's mean magnitude for outputs
    near zero, where the order of the fp32 sums and the plain version's
    rounding of its product to bf16 show)."""
    from alg_tpu_torch.ops import flash_attention_int8 as I8

    c = INT8_CASES[case]
    gen = torch.Generator().manual_seed(11)
    q, k, v = (t.to(cuda, dtype) for t in _dit_like_qkv(gen, c["b"], c["h"], c["s"], d))
    kv_len = None if c["kv_len"] is None else torch.tensor(c["kv_len"], dtype=torch.int32, device=cuda)
    which = "tc" if dtype == torch.bfloat16 else "tc_fp32"
    assert I8.route(q, pv_int8) == which
    before = (I8.flash_attention_int8.launches, I8.flash_attention_int8.launches_by_route[which])
    out = I8.flash_attention_int8(q, k, v, d ** -0.5, block_q=128, block_k=block_k, pv_int8=pv_int8, kv_len=kv_len)
    torch.cuda.synchronize()
    assert (I8.flash_attention_int8.launches, I8.flash_attention_int8.launches_by_route[which]) == (
        before[0] + 1, before[1] + 1)
    assert out.shape == q.shape and out.dtype == dtype and bool(torch.isfinite(out).all())
    ref = I8.flash_attention_int8_plain(q, k, v, d ** -0.5, 128, block_k, pv_int8, kv_len)
    if dtype == torch.bfloat16 and not pv_int8:
        seen = ref.float().abs().sum(-1) > 0
        size = ref.float().abs()[seen].mean().item() if bool(seen.any()) else 0.0
        torch.testing.assert_close(out.float(), ref.float(), atol=BF16_STEP * size, rtol=BF16_STEP)
    elif dtype == torch.bfloat16:
        _assert_close_flash(out, ref, dtype)
    elif pv_int8:
        err = (out - ref).abs()
        assert err.mean().item() < 1e-5 and err.max().item() < 2e-3, (err.mean().item(), err.max().item())
    else:
        torch.testing.assert_close(out, ref, atol=2e-5, rtol=2e-5)
    if kv_len is not None:
        for i, n in enumerate(c["kv_len"]):
            if n == 0:
                assert not out[i].any()  # no key left: a zero row
            if n == 1:
                _assert_close(out[i], v[i, :, :1].expand_as(out[i]), dtype)
    # mean drift against exact attention on this distribution, the JAX package's own bound (its bound on the
    # largest error was set at S = 512 with 256-key blocks; one P scale over 1,024 keys is coarser)
    exact = FA.attention_plain(q.float(), k.float(), v.float(), d ** -0.5, None, kv_len)
    rms = exact.pow(2).mean().sqrt().item()
    if rms > 0 and dtype == torch.float32:
        assert (out - exact).abs().mean().item() / rms < (3e-2 if pv_int8 else 2e-2)


def test_int8_route_and_refusals_on_the_card(cuda):
    """``set_attention_int8`` sends a qualifying CUDA call to the int8 kernel
    and leaves the others on the bf16 kernel; what the int8 kernel does not
    take raises and launches nothing."""
    from alg_tpu_torch.ops import attention as A
    from alg_tpu_torch.ops import flash_attention_int8 as I8

    gen = torch.Generator().manual_seed(12)
    q, k, v = (t.to(cuda) for t in _dit_like_qkv(gen, 1, 2, 96, 64))
    A.set_attention_int8("full")
    try:
        counts = (I8.flash_attention_int8.launches, FA.flash_attention.launches)
        out = A.attention(q, k, v, stable=False)
        assert (I8.flash_attention_int8.launches, FA.flash_attention.launches) == (counts[0] + 1, counts[1])
        torch.testing.assert_close(out, I8.flash_attention_int8(q, k, v, 64 ** -0.5, pv_int8=True))
        A.attention(q, k, v)  # stable: the text and vision encoders' calls
        A.attention(q, k, v, stable=False, causal=True)
        A.attention(q, k[:, :, :50], v[:, :, :50], stable=False)
        assert (I8.flash_attention_int8.launches, FA.flash_attention.launches) == (counts[0] + 2, counts[1] + 3)
        wide = torch.zeros(1, 2, 96, 80, device=cuda)
        with pytest.raises(ValueError, match="D in"):
            A.attention(wide, wide, wide, stable=False)  # it does not quietly take the bf16 kernel
        with pytest.raises(RuntimeError, match="requires a gradient"):
            A.attention(q.clone().requires_grad_(), k, v, stable=False)
    finally:
        A.set_attention_int8(False)
    with pytest.raises(ValueError, match="self-attention"):
        I8.flash_attention_int8(q, k[:, :, :50], v[:, :, :50], 0.125)
    with pytest.raises(ValueError, match="multiple of"):
        I8.flash_attention_int8(q, k, v, 0.125, block_k=96)
    with pytest.raises(TypeError):
        I8.flash_attention_int8(q.half(), k.half(), v.half(), 0.125)
    assert I8.flash_attention_int8.launches == counts[0] + 2


@pytest.mark.parametrize("case", ["s1500", "kvlen-0-1-s", "kvlen-block-edges"])
@pytest.mark.parametrize("block_k", [64, 1024], ids=["bk64", "bk1024"])
@pytest.mark.parametrize("d", [64, 128])
def test_int8_fp32_full_rounds_to_the_bf16_route(cuda, case, block_k, d):
    """``"full"`` mode in fp32 and in bf16 share one kernel body; only the
    output's type differs. On bf16-representable values both routes get the
    same codes and scales, and the fp32 output rounded to bf16 is the bf16
    route's output bit for bit."""
    from alg_tpu_torch.ops import flash_attention_int8 as I8

    c = INT8_CASES[case]
    gen = torch.Generator().manual_seed(14)
    qb, kb, vb = (t.to(cuda, torch.bfloat16) for t in _dit_like_qkv(gen, c["b"], c["h"], c["s"], d))
    q, k, v = (t.float() for t in (qb, kb, vb))
    kv_len = None if c["kv_len"] is None else torch.tensor(c["kv_len"], dtype=torch.int32, device=cuda)
    for got, want in zip(I8.quantize_qk_int8(q, k, d ** -0.5, 128, block_k, kv_len),
                         I8.quantize_qk_int8(qb, kb, d ** -0.5, 128, block_k, kv_len)):
        assert torch.equal(got, want)
    for got, want in zip(I8.quantize_v_int8(v, kv_len), I8.quantize_v_int8(vb, kv_len)):
        assert torch.equal(got, want)
    counts = dict(I8.flash_attention_int8.launches_by_route)
    out = I8.flash_attention_int8(q, k, v, d ** -0.5, block_q=128, block_k=block_k, pv_int8=True, kv_len=kv_len)
    out_bf16 = I8.flash_attention_int8(qb, kb, vb, d ** -0.5, block_q=128, block_k=block_k, pv_int8=True,
                                       kv_len=kv_len)
    torch.cuda.synchronize()
    assert I8.flash_attention_int8.launches_by_route == {key: n + 1 for key, n in counts.items()}
    assert out.dtype == torch.float32 and out_bf16.dtype == torch.bfloat16
    assert torch.equal(out.to(torch.bfloat16), out_bf16)


@pytest.mark.parametrize("pv_int8", [False, True], ids=["qk", "full"])
def test_int8_routes_on_the_card(cuda, pv_int8):
    """bf16 takes the kernel's bf16 entry and fp32 its fp32 entry, in both
    modes; each launch is counted once in ``launches`` and once under its
    route; the two routes agree to the int8 drift (mean difference under 5%
    of the output's rms: bf16 inputs quantize to slightly other codes, and
    in ``"qk"`` mode the bf16 route rounds P to bf16)."""
    from alg_tpu_torch.ops import flash_attention_int8 as I8

    gen = torch.Generator().manual_seed(13)
    q, k, v = (t.to(cuda) for t in _dit_like_qkv(gen, 2, 2, 300, 64))
    counts = (I8.flash_attention_int8.launches, dict(I8.flash_attention_int8.launches_by_route))
    outs = {}
    for dtype, which in ((torch.float32, "tc_fp32"), (torch.bfloat16, "tc")):
        args = [t.to(dtype) for t in (q, k, v)]
        assert I8.route(args[0], pv_int8) == which
        outs[which] = I8.flash_attention_int8(*args, 0.125, block_q=128, block_k=128, pv_int8=pv_int8)
    torch.cuda.synchronize()
    assert I8.flash_attention_int8.launches == counts[0] + 2
    assert I8.flash_attention_int8.launches_by_route == {key: n + 1 for key, n in counts[1].items()}
    ref = outs["tc_fp32"]
    assert bool(torch.isfinite(outs["tc"]).all())
    assert (outs["tc"].float() - ref).abs().mean().item() < 5e-2 * ref.pow(2).mean().sqrt().item()


PROLOG_MODES = [("layer", True, False, True), ("rms", True, True, True), (None, True, False, True),
                ("layer", False, False, True), ("layer", True, False, False)]


@pytest.mark.parametrize("mode,has_rope,stable,prolog_k", PROLOG_MODES,
                         ids=["layer-rope", "rms-rope-stable", "rope", "layer", "layer-rope-q-only"])
@pytest.mark.parametrize("d", [64, 80, 128])
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
def test_flash_kernel_with_the_qk_prolog(cuda, mode, has_rope, stable, prolog_k, d, dtype):
    """The prolog variant at a ragged S against ``apply_prolog_plain`` and
    the plain attention, alone and with ``kv_len`` and ``causal``; fp32 atol
    5e-6 + rtol 1e-5, bf16 the bf16 attention tolerance. A bf16 call runs the
    tensor-core forward, which rounds the unnormalised P to bf16 before P·V
    as ``alg_tpu``'s kernel does, so in bf16 the plain attention is
    ``tensor_core_attention_plain``, which rounds P the same way (one that
    keeps P in fp32 differs by more than the bound in a causal row of a few
    keys whose output cancels)."""
    gen = torch.Generator().manual_seed(13)
    b, h, s = 2, 3, 300
    q, k, v = (_randn(gen, b, h, s, d).to(cuda, dtype) for _ in range(3))
    ang = torch.rand(s, d // 2, generator=gen) * 3
    cos, sin = (f(ang).repeat_interleave(2, -1).contiguous().to(cuda) for f in (torch.cos, torch.sin))
    qs, qb, ks, kb = (torch.rand(d, generator=gen).to(cuda) for _ in range(4))
    prolog = {"norm": mode, "eps": 1e-6, "q_scale": qs, "q_bias": qb, "k_scale": ks, "k_bias": kb}
    if has_rope:
        prolog["cos"], prolog["sin"] = cos, sin
    qr, kr = FA.apply_prolog_plain(q, k, prolog)
    kwargs = dict(qk_norm=mode, norm_eps=1e-6, q_norm_scale=qs if mode else None,
                  q_norm_bias=qb if mode == "layer" else None, rope_cos=cos if has_rope else None,
                  rope_sin=sin if has_rope else None, prolog_k=prolog_k)
    if prolog_k:
        kwargs.update(k_norm_scale=ks if mode else None, k_norm_bias=kb if mode == "layer" else None)
    k_in = k if prolog_k else kr  # the caller brings k transformed when only the q side is fused
    kv_len = torch.tensor([s, 77], dtype=torch.int32, device=cuda)
    which = FA.route(q)
    for extra in (dict(), dict(kv_len=kv_len), dict(causal=True)):
        by_route = FA.flash_attention.launches_by_route
        counts = (FA.flash_attention.launches, by_route[which], FA.qk_prolog.launches)
        out = FA.flash_attention(q, k_in, v, d ** -0.5, stable=stable, **kwargs, **extra)
        torch.cuda.synchronize()
        assert (FA.flash_attention.launches, by_route[which], FA.qk_prolog.launches) == tuple(n + 1 for n in counts)
        if dtype == torch.float32:
            ref = FA.attention_plain(qr, kr, v, d ** -0.5, None, extra.get("kv_len"), extra.get("causal", False))
            torch.testing.assert_close(out, ref, atol=5e-6, rtol=1e-5)
        else:
            ref = FA.tensor_core_attention_plain(qr, kr, v, d ** -0.5, None, extra.get("kv_len"),
                                                 extra.get("causal", False), stable, key_tile=_key_tile(q))[0]
            _assert_close_flash(out, ref, dtype)


def test_attention_prolog_on_the_card(cuda):
    """``attention(prolog=...)`` launches the qk prolog kernel and then the
    forward for a call without a gradient, and with one applies the plain
    composition and differentiates through the backward kernels; both agree
    with the CPU."""
    from alg_tpu_torch.ops import attention as A

    gen = torch.Generator().manual_seed(14)
    q, k, v = (_randn(gen, 1, 2, 130, 128) for _ in range(3))
    ang = torch.rand(130, 64, generator=gen) * 3
    prolog = {"norm": "rms", "eps": 1e-6, "q_scale": torch.rand(128, generator=gen),
              "k_scale": torch.rand(128, generator=gen), "cos": torch.cos(ang).repeat_interleave(2, -1),
              "sin": torch.sin(ang).repeat_interleave(2, -1)}
    on_card = {name: t.to(cuda) if torch.is_tensor(t) else t for name, t in prolog.items()}
    ref = A.attention(q, k, v, stable=False, prolog=prolog)
    before = (FA.qk_prolog.launches, FA.flash_attention.launches_by_route["cuda_core"])
    out = A.attention(q.to(cuda), k.to(cuda), v.to(cuda), stable=False, prolog=on_card)
    assert (FA.qk_prolog.launches, FA.flash_attention.launches_by_route["cuda_core"]) == (before[0] + 1,
                                                                                         before[1] + 1)
    torch.testing.assert_close(out.cpu(), ref, atol=5e-6, rtol=1e-5)
    grads = {}
    for dev in ("cpu", cuda):
        leaves = [t.detach().clone().to(dev).requires_grad_() for t in (q, k, v, prolog["q_scale"])]
        pro = {**{name: t.to(dev) if torch.is_tensor(t) else t for name, t in prolog.items()}, "q_scale": leaves[3]}
        A.attention(*leaves[:3], stable=False, prolog=pro).square().sum().backward()
        grads[str(dev)] = [t.grad.cpu() for t in leaves]
    # the differentiable call launches no prolog kernel
    assert FA.qk_prolog.launches == before[0] + 1
    for got, want in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-4)


# -- the bf16 tensor-core kernels: csrc/flash_attention_tc.cu and csrc/flash_attention_bwd_tc.cu -----------------

TC_CASES = {
    # name: (b, h, sq, sk, d, kv_len, causal, stable, bias)
    "s1": (2, 2, 1, 1, 64, None, False, True, None),
    "s63": (1, 3, 63, 63, 64, None, False, False, None),
    "s65": (1, 3, 65, 65, 128, None, False, True, None),
    "s127": (1, 2, 127, 127, 64, None, False, False, None),
    "s129": (1, 2, 129, 129, 128, None, False, True, None),
    "s4276": (1, 2, 4276, 4276, 64, None, False, False, None),
    "sq70-sk300": (2, 2, 70, 300, 64, None, False, True, None),
    "sq300-sk70": (2, 2, 300, 70, 128, None, False, False, None),
    "kvlen-tile-edges-d64": (7, 2, 200, 200, 64, [0, 1, 63, 64, 65, 129, 200], False, False, None),
    "kvlen-tile-edges-d128": (7, 2, 150, 200, 128, [0, 1, 63, 64, 65, 127, 200], False, True, None),
    "causal-sq300-sk70": (2, 2, 300, 70, 64, None, True, True, None),
    "causal-sq70-sk300": (2, 2, 70, 300, 128, None, True, False, None),
    "causal-kvlen": (2, 2, 200, 200, 64, [200, 65], True, True, None),
    "bias-shared": (2, 3, 100, 150, 64, None, False, True, "shared"),
    "bias-per-batch-odd-sk": (2, 3, 100, 151, 64, [151, 40], False, True, "per_batch"),
    "bias-per-batch-unstable": (2, 2, 90, 200, 128, None, False, False, "per_batch"),
    "d80": (2, 3, 257, 300, 80, [300, 90], False, True, None),
    "d80-causal": (1, 2, 130, 130, 80, None, True, False, None),
}


@pytest.mark.parametrize("case", list(TC_CASES))
def test_tensor_core_forward_matches_plain(cuda, case):
    """bf16 without a prolog launches a tensor-core kernel (``"wgmma"`` at
    D = 64 or 128 without a bias, else ``"tc"``, counted under it): its output
    within the bf16 attention tolerance of the plain version, its LSE within
    1e-4 (base-2 units) of the kernel's denominator with -inf on the same
    rows (``_assert_lse_close``), zero rows where no key is visible, and the
    same output with and without the LSE."""
    b, h, sq, sk, d, kv_len, causal, stable, bias_kind = TC_CASES[case]
    gen = torch.Generator().manual_seed(21)
    q = _randn(gen, b, h, sq, d).to(cuda, torch.bfloat16)
    k, v = (_randn(gen, b, h, sk, d).to(cuda, torch.bfloat16) for _ in range(2))
    bias = None
    if bias_kind is not None:
        bias = _randn(gen, b if bias_kind == "per_batch" else 1, h, sq, sk, scale=2.0).to(cuda)
    lens = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32, device=cuda)
    scale = 1.0 / 8 if bias is not None else d ** -0.5
    which = "wgmma" if d in FA.WGMMA_HEAD_DIMS and bias is None else "tc"
    assert FA.route(q, bias=bias) == which
    counts = (FA.flash_attention.launches, FA.flash_attention.launches_by_route[which])
    out, lse = FA.flash_attention(q, k, v, scale, bias=bias, stable=stable, kv_len=lens, causal=causal,
                                  return_residuals=True)
    alone = FA.flash_attention(q, k, v, scale, bias=bias, stable=stable, kv_len=lens, causal=causal)
    torch.cuda.synchronize()
    assert (FA.flash_attention.launches, FA.flash_attention.launches_by_route[which]) == (counts[0] + 2,
                                                                                          counts[1] + 2)
    assert torch.equal(out, alone) and out.dtype == torch.bfloat16 and bool(torch.isfinite(out).all())
    _assert_close_flash(out, FA.attention_plain(q, k, v, scale, bias, lens, causal), torch.bfloat16)
    seen = _assert_lse_close(lse, q, k, scale, bias, lens, causal, stable)
    assert not out[~seen].any()


@pytest.mark.parametrize("d", [64, 80, 128])
def test_tensor_core_forward_rescales_across_tiles(cuda, d):
    """``stable=True`` with logits near ±100 whose row maxima grow from key
    tile to key tile: the running max moves in every tile and the output is
    rescaled each time; against the plain fp32 softmax on the same bf16 inputs."""
    gen = torch.Generator().manual_seed(22)
    b, h, s = 1, 2, 700
    u = _randn(gen, 1, h, 1, d)  # a direction shared by every q and k row of a head, so |logit| reaches 100
    q, k = (u + 0.1 * _randn(gen, b, h, s, d) for _ in range(2))
    q = q / q.norm(dim=-1, keepdim=True) * 10.0
    ramp = torch.linspace(-1.0, 1.0, s)[None, None, :, None]  # keys late in the sequence give the largest logits
    k = k / k.norm(dim=-1, keepdim=True) * 10.0 * ramp
    q, k = (t.to(cuda, torch.bfloat16) for t in (q, k))
    v = _randn(gen, b, h, s, d).to(cuda, torch.bfloat16)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    assert 90.0 < float(logits.abs().max()) <= 100.5
    which = FA.route(q)
    before = FA.flash_attention.launches_by_route[which]
    out = FA.flash_attention(q, k, v, 1.0, stable=True)
    torch.cuda.synchronize()
    assert FA.flash_attention.launches_by_route[which] == before + 1 and bool(torch.isfinite(out).all())
    _assert_close_flash(out, FA.attention_plain(q, k, v, 1.0), torch.bfloat16)


TC_BWD_CASES = {
    # name: (b, h, sq, sk, d, kv_len, causal)
    "ragged-131x203-kvlen": (2, 2, 131, 203, 64, [203, 70], False),
    "causal-square-150": (1, 3, 150, 150, 128, None, True),
    "causal-sq67-sk160-kvlen": (2, 2, 67, 160, 80, [160, 90], True),
    "causal-sq140-sk45": (1, 2, 140, 45, 64, None, True),
    "one-query": (2, 2, 1, 77, 128, None, False),
    "one-key": (1, 2, 50, 1, 64, None, False),
    "kvlen-0-1-64-65": (4, 2, 100, 130, 128, [0, 1, 64, 65], False),
}


@pytest.mark.parametrize("case", list(TC_BWD_CASES))
def test_tensor_core_dkv_matches_plain(cuda, case):
    """bf16 dkv launches the tensor-core kernel: dk and dv within the bf16
    gradient tolerance of the plain version (which rounds P and dS to bf16 as
    the kernel does), exactly 0 for keys past ``kv_len``."""
    from alg_tpu_torch.ops import flash_attention_bwd as FB

    b, h, sq, sk, d, kv_len, causal = TC_BWD_CASES[case]
    gen = torch.Generator().manual_seed(23)
    q, do = (_randn(gen, b, h, sq, d).to(cuda, torch.bfloat16) for _ in range(2))
    k, v = (_randn(gen, b, h, sk, d).to(cuda, torch.bfloat16) for _ in range(2))
    lens = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32, device=cuda)
    scale = d ** -0.5
    out, lse = FA.flash_attention(q, k, v, scale, kv_len=lens, causal=causal, return_residuals=True)
    delta = FB.row_delta(out, do)
    dkv = FB.flash_attention_bwd_dkv
    counts = (dkv.launches, dkv.launches_by_route["tc"])
    dk, dv = dkv(q, k, v, do, lse, delta, scale, causal, lens)
    torch.cuda.synchronize()
    assert (dkv.launches, dkv.launches_by_route["tc"]) == (counts[0] + 1, counts[1] + 1)
    ref = FB.flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, scale, causal, lens)
    for g, r in zip((dk, dv), ref):
        assert g.dtype == torch.bfloat16 and bool(torch.isfinite(g).all())
        _assert_close_grad(g, r, torch.bfloat16)
    if kv_len is not None:
        dead = torch.arange(sk, device=cuda)[None, :] >= lens[:, None]
        for g in (dk, dv):
            assert not g.transpose(1, 2)[dead].any()


@pytest.mark.parametrize("case", list(TC_BWD_CASES))
def test_tensor_core_dq_matches_plain(cuda, case):
    """bf16 dq launches the tensor-core kernel: dq within the bf16 gradient
    tolerance of the plain version (which rounds dS to bf16 as the kernel
    does), exactly 0 for rows that see no key."""
    from alg_tpu_torch.ops import flash_attention_bwd as FB

    b, h, sq, sk, d, kv_len, causal = TC_BWD_CASES[case]
    gen = torch.Generator().manual_seed(24)
    q, do = (_randn(gen, b, h, sq, d).to(cuda, torch.bfloat16) for _ in range(2))
    k, v = (_randn(gen, b, h, sk, d).to(cuda, torch.bfloat16) for _ in range(2))
    lens = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32, device=cuda)
    scale = d ** -0.5
    out, lse = FA.flash_attention(q, k, v, scale, kv_len=lens, causal=causal, return_residuals=True)
    delta = FB.row_delta(out, do)
    dqk = FB.flash_attention_bwd_dq
    counts = (dqk.launches, dict(dqk.launches_by_route))
    dq = dqk(q, k, v, do, lse, delta, scale, causal, lens)
    torch.cuda.synchronize()
    assert (dqk.launches, dqk.launches_by_route) == (counts[0] + 1, {**counts[1], "tc": counts[1]["tc"] + 1})
    assert dq.dtype == torch.bfloat16 and bool(torch.isfinite(dq).all())
    _assert_close_grad(dq, FB.flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, scale, causal, lens),
                       torch.bfloat16)
    blind = torch.isneginf(lse)  # rows that see no key
    assert not dq[blind].any()


def test_bf16_dit_gradient_card_matches_cpu(cuda):
    """The gradient of one LoRA loss on a 2-layer CogVideoX DiT (head dim 64)
    in bf16, at adapters with A and B nonzero: the card, where the forward
    with the LSE, dq and dkv all run on the tensor cores, and the CPU's plain
    versions, each held against the fp32 gradient at the same weights (the
    bf16 weights and inputs in fp32, on the CPU). Each leaf's error on the
    card is within the CPU's own largest bf16 error in that leaf plus the
    bf16 gradient tolerance of the fp32 gradient: the card may differ from
    the CPU by their two bf16 errors, which is not a fault, but not be
    further from the exact gradient than bf16 arithmetic explains."""
    from alg_tpu_torch.models.cogvideox.transformer import (CogVideoXTransformer, CogVideoXTransformerConfig,
                                                            cogvideox_rope)
    from alg_tpu_torch.ops import flash_attention_bwd as FB
    from alg_tpu_torch.training.lora import init_lora_params, make_lora_loss
    from alg_tpu_torch.training.losses import make_cogvideox_vpred_loss
    from alg_tpu_torch.training.train import tree_leaves, tree_leaves_with_path, tree_map

    cfg = CogVideoXTransformerConfig(num_attention_heads=2, attention_head_dim=64, in_channels=8, out_channels=4,
                                     time_embed_dim=32, text_embed_dim=64, num_layers=2, sample_height=8,
                                     sample_width=8, max_text_seq_length=8)
    gen = torch.Generator().manual_seed(6)
    model = L.init_random_(CogVideoXTransformer(cfg), gen).requires_grad_(False).to(torch.bfloat16)
    loras0 = init_lora_params(gen, dict(model.named_parameters()), rank=4, prefixes=("blocks",))
    for path, leaf in tree_leaves_with_path(loras0):
        if path.endswith("/B"):  # B starts at 0, and A's gradient with it
            leaf.copy_(0.05 * _randn(gen, *leaf.shape))
    cos, sin = cogvideox_rope(cfg, 64, 64, 3)  # 3 latent frames of 8 x 8: 48 video tokens, 8 text tokens
    batch = {"latents": _randn(gen, 2, 3, 4, 8, 8), "image_latents": _randn(gen, 2, 3, 4, 8, 8),
             "encoder_hidden_states": _randn(gen, 2, 8, 64)}
    draws = {"t": torch.tensor([999, 400]), "noise": _randn(gen, 2, 3, 4, 8, 8)}
    routes = (FA.flash_attention.launches_by_route, FB.flash_attention_bwd_dq.launches_by_route,
              FB.flash_attention_bwd_dkv.launches_by_route)
    grads = {}
    for dev, dtype in (("cpu", torch.bfloat16), (cuda, torch.bfloat16), ("fp32", torch.float32)):
        on = "cpu" if dev == "fp32" else dev
        dit = copy.deepcopy(model).to(on, dtype)
        loss = make_lora_loss(make_cogvideox_vpred_loss(dit, rope_cos=cos, rope_sin=sin),
                              dict(dit.named_parameters()), scale=2.0, attach=True)
        at = tree_map(lambda t: t.clone().to(on).requires_grad_(), loras0)
        before = [dict(r) for r in routes]
        value = loss(at, {n: t.to(on, torch.bfloat16).to(dtype) for n, t in batch.items()},
                     {n: t.to(on) for n, t in draws.items()})
        grads[str(dev)] = [g.cpu() for g in torch.autograd.grad(value, tree_leaves(at))]
        torch.cuda.synchronize()
        want = [dict(r) for r in before]
        # on the card, two layers: two forwards with the LSE (head dim 64, no bias: the Hopper forward), two dq
        # and two dkv, all on the tensor cores
        if torch.device(on).type == "cuda":
            for r, key in zip(want, ("wgmma", "tc", "tc")):
                r[key] += 2
        assert [dict(r) for r in routes] == want
    for a, b, ref in zip(grads[str(cuda)], grads["cpu"], grads["fp32"]):
        assert float(b.abs().max()) > 0 and bool(torch.isfinite(a).all())
        atol, rtol = TOL[torch.bfloat16]
        atol = max(TOL[torch.float32][0], min(atol, 0.05 * ref.abs().mean().item()))
        card_err, cpu_err = (a.float() - ref).abs(), (b.float() - ref).abs()
        excess = card_err - (cpu_err.max() + atol + rtol * ref.abs())
        assert float(excess.max()) <= 0, (f"card error {card_err.max():.3e}, CPU bf16 error {cpu_err.max():.3e}, "
                                          f"excess {excess.max():.3e} over atol {atol:.2e} + rtol {rtol}")


def test_routes_on_the_card(cuda):
    """fp32 takes the CUDA-core kernels, each counted under its route and
    none as a tensor-core launch, and bf16 with a prolog the qk prolog kernel
    and then the forward of its route (D = 64 without a bias: the Hopper
    kernel, ``"wgmma"``); the CUDA-core entry points refuse bf16
    outright (cudaErrorInvalidValue), so no bf16 call can land on them
    unseen."""
    from alg_tpu_torch.ops import flash_attention_bwd as FB

    q = torch.randn(1, 2, 40, 64, device=cuda)
    fwd, dq = FA.flash_attention.launches_by_route, FB.flash_attention_bwd_dq.launches_by_route
    dkv = FB.flash_attention_bwd_dkv.launches_by_route
    counts = (dict(fwd), dict(dq), dict(dkv))
    out, lse = FA.flash_attention(q, q, q, 0.125, return_residuals=True)
    FB.flash_attention_bwd_dq(q, q, q, q, lse, FB.row_delta(out, q), 0.125)
    FB.flash_attention_bwd_dkv(q, q, q, q, lse, FB.row_delta(out, q), 0.125)
    ones = torch.ones(64, device=cuda)
    prologs = FA.qk_prolog.launches
    FA.flash_attention(q.bfloat16(), q.bfloat16(), q.bfloat16(), 0.125, qk_norm="rms", q_norm_scale=ones,
                       k_norm_scale=ones)
    torch.cuda.synchronize()
    assert fwd == {**counts[0], "cuda_core": counts[0]["cuda_core"] + 1, "wgmma": counts[0]["wgmma"] + 1}
    assert FA.qk_prolog.launches == prologs + 1
    assert dq == {**counts[1], "cuda_core": counts[1]["cuda_core"] + 1}
    assert dkv == {**counts[2], "cuda_core": counts[2]["cuda_core"] + 1}
    x = q.bfloat16()
    stream = torch.cuda.current_stream().cuda_stream
    bf16 = FA._build.DTYPE_CODE[torch.bfloat16]
    rc = FA._entry(64, "cuda_core")(bf16, x.data_ptr(), x.data_ptr(), x.data_ptr(), None, 0, None, x.data_ptr(),
                                    None, 1, 2, 40, 40, 0.125, 1, 0, stream)
    assert rc == 1  # cudaErrorInvalidValue
    rc = FB._entry(64, "dq_cuda_core")(bf16, *([x.data_ptr()] * 4), lse.data_ptr(), lse.data_ptr(), None,
                                       x.data_ptr(), 1, 2, 40, 40, 0.125, 0, stream)
    assert rc == 1
    rc = FB._entry(64, "dkv_cuda_core")(bf16, *([x.data_ptr()] * 4), lse.data_ptr(), lse.data_ptr(), None,
                                        x.data_ptr(), x.data_ptr(), 1, 2, 40, 40, 0.125, 0, stream)
    assert rc == 1


# -- the register-tiled fp32 kernels: csrc/flash_attention.cu and the dq and dkv kernels of csrc/flash_attention_bwd.cu

def _fp32_forward_heights(d: int) -> tuple:
    """The fp32 forward's query rows a block, by preference (csrc/flash_attention.cu): 128 (64 at
    D = 128) where that still gives every SM a block, else 32, else 16."""
    return (64 if d == 128 else 128, 32, 16)


def _fp32_dq_heights(d: int) -> tuple:
    """The fp32 dq kernel's query rows a block, by the forward's rule (csrc/flash_attention_bwd.cu): 128 at
    D = 64 (64 at D = 80 and 128), else 32, else 16."""
    return (128 if d == 64 else 64, 32, 16)


def _fp32_forward_rows(sq: int, bh: int, d: int, heights=_fp32_forward_heights) -> int:
    """Query rows a block of the fp32 forward (or, with ``heights=_fp32_dq_heights``, of dq) takes at
    [B·H = bh, Sq = sq, D = d] (the launchers' rule, csrc/flash_simt.cuh)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    heights = heights(d)
    for rows in heights[:-1]:
        if -(-sq // rows) * bh >= sms:
            return rows
    return heights[-1]


def _heads_for_rows(rows: int, sq: int, b: int, d: int, heights=_fp32_forward_heights) -> int:
    """The fewest heads with which a [b, h, sq, d] call takes blocks of ``rows`` query rows."""
    for h in range(1, 1025):
        if _fp32_forward_rows(sq, b * h, d, heights) == rows:
            return h
    raise AssertionError(f"no head count gives {rows}-row blocks at Sq = {sq}, B = {b}, D = {d}")


FP32_FWD_CASES = {
    # name: (b, sq, sk, d, kv_len, causal, stable, bias); keys a tile: 64 at D = 64; at D = 80 32 in the
    # 128-row blocks, else 64; at D = 128 48 in the 64-row blocks, else 32
    "s63-d128": (1, 63, 63, 128, None, False, False, None),
    "s64-d128": (1, 64, 64, 128, None, False, True, None),
    "s65-d128": (1, 65, 65, 128, None, False, True, None),
    "s127": (1, 127, 127, 64, None, False, False, None),
    "s128": (1, 128, 128, 64, None, False, True, None),
    "s129-d80": (1, 129, 129, 80, None, False, True, None),
    "sk31-d128": (1, 40, 31, 128, None, False, False, None),
    "sk49-d128": (1, 40, 49, 128, None, False, True, None),
    "sk33-d80": (1, 70, 33, 80, None, False, True, None),
    "sk63-d80": (1, 70, 63, 80, None, False, False, None),
    "sk65-d64": (1, 97, 65, 64, None, False, True, None),
    "sq1": (2, 1, 300, 64, None, False, True, None),
    "kvlen-0-1-64-65-d64": (5, 100, 130, 64, [0, 1, 64, 65, 130], False, True, None),
    "kvlen-0-1-32-33-48-49-d128": (7, 100, 100, 128, [0, 1, 32, 33, 48, 49, 100], False, False, None),
    "kvlen-0-1-64-65-d80": (5, 60, 70, 80, [0, 1, 64, 65, 70], False, True, None),
    "causal-sq70-sk200-d80": (1, 70, 200, 80, None, True, True, None),
    "causal-sq200-sk70-d64": (1, 200, 70, 64, None, True, False, None),
    "causal-kvlen-d128": (2, 130, 130, 128, [130, 45], True, True, None),
    "bias-shared-stable": (2, 100, 97, 64, None, False, True, "shared"),
    "bias-shared-unstable-d80": (1, 65, 80, 80, None, False, False, "shared"),
    "bias-per-batch-unstable-d128": (2, 65, 130, 128, None, False, False, "per_batch"),
    "bias-per-batch-stable-kvlen-d80": (3, 90, 90, 80, [90, 33, 1], False, True, "per_batch"),
}
# every block height each case can reach: 32-row blocks need Sq > 32 (else they are as many as the largest)
FP32_FWD_PARAMS = [(case, rows) for case, spec in FP32_FWD_CASES.items() for rows in _fp32_forward_heights(spec[3])
                   if rows != 32 or spec[1] > 32]


@pytest.mark.parametrize("case,rows", FP32_FWD_PARAMS, ids=[f"{c}-bq{r}" for c, r in FP32_FWD_PARAMS])
def test_fp32_forward_tiles_match_plain(cuda, case, rows):
    """The fp32 forward at the edges of its tiles (128 query rows a block, 64
    at D = 128, or 32 or 16, with as many heads as make the launcher pick that
    block; 32, 48 or 64 keys a tile): output and LSE against the plain
    version within the fp32 tolerance, -inf and zero rows where no key is
    visible, the same output with and without the LSE, and each call counted
    once under ``cuda_core`` and nowhere else."""
    b, sq, sk, d, kv_len, causal, stable, bias_kind = FP32_FWD_CASES[case]
    h = _heads_for_rows(rows, sq, b, d)
    gen = torch.Generator().manual_seed(31)
    q = _randn(gen, b, h, sq, d).to(cuda)
    k, v = (_randn(gen, b, h, sk, d).to(cuda) for _ in range(2))
    bias = None
    if bias_kind is not None:
        bias = _randn(gen, b if bias_kind == "per_batch" else 1, h, sq, sk, scale=2.0).to(cuda)
    lens = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32, device=cuda)
    scale = 1.0 / 8 if bias is not None else d ** -0.5
    routes = dict(FA.flash_attention.launches_by_route)
    out, lse = FA.flash_attention(q, k, v, scale, bias=bias, stable=stable, kv_len=lens, causal=causal,
                                  return_residuals=True)
    alone = FA.flash_attention(q, k, v, scale, bias=bias, stable=stable, kv_len=lens, causal=causal)
    torch.cuda.synchronize()
    assert FA.flash_attention.launches_by_route == {**routes, "cuda_core": routes["cuda_core"] + 2}
    assert torch.equal(out, alone) and out.dtype == torch.float32 and bool(torch.isfinite(out).all())
    ref, ref_lse = FA.attention_plain_residuals(q, k, v, scale, bias, lens, causal)
    _assert_close(out, ref, torch.float32)
    assert torch.equal(torch.isneginf(lse), torch.isneginf(ref_lse))
    seen = torch.isfinite(ref_lse)
    torch.testing.assert_close(lse[seen], ref_lse[seen], atol=1e-4, rtol=0)
    assert not out[~seen].any()


def test_fp32_forward_rescales_across_tiles(cuda):
    """``stable=True`` in fp32 with logits near ±100 whose row maxima grow
    from key tile to key tile, at all three head dims and block sizes."""
    gen = torch.Generator().manual_seed(32)
    for d in (64, 80, 128):
        for rows in _fp32_forward_heights(d):
            b, s = 1, 300
            h = _heads_for_rows(rows, s, b, d)
            u = _randn(gen, 1, h, 1, d)
            q, k = (u + 0.1 * _randn(gen, b, h, s, d) for _ in range(2))
            q = q / q.norm(dim=-1, keepdim=True) * 10.0
            k = k / k.norm(dim=-1, keepdim=True) * 10.0 * torch.linspace(-1.0, 1.0, s)[None, None, :, None]
            q, k, v = q.to(cuda), k.to(cuda), _randn(gen, b, h, s, d).to(cuda)
            out = FA.flash_attention(q, k, v, 1.0, stable=True)
            torch.cuda.synchronize()
            assert bool(torch.isfinite(out).all())
            _assert_close(out, FA.attention_plain(q, k, v, 1.0), torch.float32)


FP32_DKV_CASES = {
    # name: (b, h, sq, sk, d, kv_len, causal)
    "sk63-d64": (1, 2, 50, 63, 64, None, False),
    "sk64-d64": (1, 2, 50, 64, 64, None, False),
    "sk65-d80": (1, 2, 50, 65, 80, None, False),
    "sk63-d128": (1, 2, 50, 63, 128, None, False),
    "sk65-d128": (1, 2, 50, 65, 128, None, False),
    "sq31-d80": (1, 2, 31, 90, 80, None, False),
    "sq32-d64": (1, 2, 32, 90, 64, None, False),
    "sq33-d128": (1, 2, 33, 90, 128, None, False),
    "sq1": (2, 2, 1, 100, 64, None, False),
    "kvlen-0-1-64-65-d64": (5, 2, 70, 130, 64, [0, 1, 64, 65, 130], False),
    "kvlen-0-1-64-65-d80": (5, 2, 70, 130, 80, [0, 1, 64, 65, 130], False),
    "kvlen-0-1-64-65-d128": (5, 2, 70, 100, 128, [0, 1, 64, 65, 100], False),
    "causal-sq45-sk160-d80": (1, 3, 45, 160, 80, None, True),
    "causal-sq160-sk45-d128": (1, 2, 160, 45, 128, None, True),
    "causal-square-kvlen-d64": (2, 2, 130, 130, 64, [130, 70], True),
}


@pytest.mark.parametrize("case", list(FP32_DKV_CASES))
def test_fp32_dkv_tiles_match_plain(cuda, case):
    """The fp32 dkv kernel at the edges of its tiles (64 keys a block, 32
    queries a tile): dk and dv within the
    fp32 tolerance of the plain version, exactly 0 for keys past ``kv_len``,
    and the call counted once under ``cuda_core`` and nowhere else."""
    from alg_tpu_torch.ops import flash_attention_bwd as FB

    b, h, sq, sk, d, kv_len, causal = FP32_DKV_CASES[case]
    gen = torch.Generator().manual_seed(33)
    q, do = (_randn(gen, b, h, sq, d).to(cuda) for _ in range(2))
    k, v = (_randn(gen, b, h, sk, d).to(cuda) for _ in range(2))
    lens = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32, device=cuda)
    scale = d ** -0.5
    out, lse = FA.flash_attention(q, k, v, scale, kv_len=lens, causal=causal, return_residuals=True)
    delta = FB.row_delta(out, do)
    dkv = FB.flash_attention_bwd_dkv
    counts = (dkv.launches, dict(dkv.launches_by_route))
    dk, dv = dkv(q, k, v, do, lse, delta, scale, causal, lens)
    torch.cuda.synchronize()
    assert (dkv.launches, dkv.launches_by_route) == (counts[0] + 1, {**counts[1], "cuda_core": counts[1]["cuda_core"] + 1})
    ref = FB.flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, scale, causal, lens)
    for g, r in zip((dk, dv), ref):
        assert g.dtype == torch.float32 and bool(torch.isfinite(g).all())
        _assert_close(g, r, torch.float32)
    if kv_len is not None:
        dead = torch.arange(sk, device=cuda)[None, :] >= lens[:, None]
        for g in (dk, dv):
            assert not g.transpose(1, 2)[dead].any()


FP32_DQ_CASES = {
    # name: (b, sq, sk, d, kv_len, causal); keys a tile: 32 at D = 64 and 128 and 64 at D = 80 in the largest
    # blocks; 64 (32 at D = 128) in the 32- and 16-row blocks
    "s63-d128": (1, 63, 63, 128, None, False),
    "s64-d64": (1, 64, 64, 64, None, False),
    "s65-d80": (1, 65, 65, 80, None, False),
    "s127-d64": (1, 127, 127, 64, None, False),
    "s128-d128": (1, 128, 128, 128, None, False),
    "s129-d64": (1, 129, 129, 64, None, False),
    "sk31-d64": (1, 70, 31, 64, None, False),
    "sk33-d128": (1, 70, 33, 128, None, False),
    "sk63-d80": (1, 70, 63, 80, None, False),
    "sk65-d64": (1, 70, 65, 64, None, False),
    "sq1": (2, 1, 300, 64, None, False),
    "kvlen-0-1-32-33-64-65-d64": (7, 100, 130, 64, [0, 1, 32, 33, 64, 65, 130], False),
    "kvlen-0-1-32-33-d128": (5, 70, 100, 128, [0, 1, 32, 33, 100], False),
    "kvlen-0-1-64-65-d80": (5, 70, 90, 80, [0, 1, 64, 65, 90], False),
    "causal-sq70-sk200-d80": (1, 70, 200, 80, None, True),
    "causal-sq200-sk70-d64": (1, 200, 70, 64, None, True),  # its first 130 rows see no key
    "causal-sq160-sk45-d128": (1, 160, 45, 128, None, True),
    "causal-kvlen-d128": (2, 130, 130, 128, [130, 45], True),
    "wan-cross-text-d128": (1, 130, 512, 128, None, False),
    "wan-cross-image-d128": (1, 130, 257, 128, None, False),
}
FP32_DQ_PARAMS = [(case, rows) for case, spec in FP32_DQ_CASES.items() for rows in _fp32_dq_heights(spec[3])
                  if rows != 32 or spec[1] > 32]


@pytest.mark.parametrize("case,rows", FP32_DQ_PARAMS, ids=[f"{c}-bq{r}" for c, r in FP32_DQ_PARAMS])
def test_fp32_dq_tiles_match_plain(cuda, case, rows):
    """The fp32 dq kernel at the edges of its tiles (128, 64, 32 or 16 query
    rows a block, with as many heads as make the launcher pick that block;
    32 or 64 keys a tile): dq within the fp32 tolerance of the plain version,
    exactly 0 on rows that see no key, and the call counted once under
    ``cuda_core`` and nowhere else."""
    from alg_tpu_torch.ops import flash_attention_bwd as FB

    b, sq, sk, d, kv_len, causal = FP32_DQ_CASES[case]
    h = _heads_for_rows(rows, sq, b, d, _fp32_dq_heights)
    gen = torch.Generator().manual_seed(34)
    q, do = (_randn(gen, b, h, sq, d).to(cuda) for _ in range(2))
    k, v = (_randn(gen, b, h, sk, d).to(cuda) for _ in range(2))
    lens = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32, device=cuda)
    scale = d ** -0.5
    out, lse = FA.flash_attention(q, k, v, scale, kv_len=lens, causal=causal, return_residuals=True)
    delta = FB.row_delta(out, do)
    dq_fn = FB.flash_attention_bwd_dq
    counts = (dq_fn.launches, dict(dq_fn.launches_by_route))
    dq = dq_fn(q, k, v, do, lse, delta, scale, causal, lens)
    torch.cuda.synchronize()
    assert (dq_fn.launches, dq_fn.launches_by_route) == (
        counts[0] + 1, {**counts[1], "cuda_core": counts[1]["cuda_core"] + 1})
    assert dq.dtype == torch.float32 and bool(torch.isfinite(dq).all())
    _assert_close(dq, FB.flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, scale, causal, lens), torch.float32)
    unseen = torch.isneginf(lse)
    assert not dq[unseen].any()
    if (kv_len is not None and 0 in kv_len) or (causal and sq > sk):
        assert bool(unseen.any())  # the case reaches rows without a key


@pytest.mark.parametrize("d", [64, 128])
def test_cuda_core_int8_entry_refuses_bf16(cuda, d):
    """No int8 entry runs on the CUDA cores any more (the ``__dp4a`` kernel
    is retired), and each of the tensor-core kernel's two entries takes its
    own type alone: a direct bf16 call of the fp32 entry, or an fp32 call of
    the bf16 one, returns cudaErrorInvalidValue and launches nothing; bf16
    int8 attention takes the bf16 entry and fp32 the fp32 one
    (``flash_attention_int8.route``)."""
    from alg_tpu_torch.ops import flash_attention_int8 as I8

    assert set(I8._ENTRY_NAMES) == {"tc", "tc_fp32"}
    scales = torch.ones(2, 1, device=cuda)
    for dtype, other in ((torch.bfloat16, "tc_fp32"), (torch.float32, "tc")):
        x = torch.full((1, 2, 64, d), 7.0, dtype=dtype, device=cuda)
        rc = I8._entry(d, other)(FA._build.DTYPE_CODE[dtype], x.data_ptr(), x.data_ptr(), x.data_ptr(),
                                 scales.data_ptr(), scales.data_ptr(), None, None, x.data_ptr(), 1, 2, 64, 64, 64,
                                 0, 0, torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        assert rc == 1  # cudaErrorInvalidValue
        assert bool((x == 7.0).all())  # nothing was written
        assert I8.route(x) == ("tc" if dtype == torch.bfloat16 else "tc_fp32")


# -- the tensor-core forward's denominator: the TPU kernel's at each head dim ------------------------------------


@pytest.mark.parametrize("stable", [False, True], ids=["bounded", "stable"])
@pytest.mark.parametrize("d", [64, 80, 128])
def test_tensor_core_lse_takes_the_tpu_kernels_denominator(cuda, d, stable):
    """At D = 64 and 80 the tensor-core forward normalises by the sum of the
    bf16-rounded p, as the TPU kernel's ones column does, and at D = 128 by
    the sum of the fp32 p: its LSE lies within 1e-4 (base-2 units) of
    ``tensor_core_lse_plain``'s log2 of that sum (plus the running max when
    stable), and a p on a rounding tie adds ``tie``; at D = 64 and 80 its mean
    distance from that LSE is under a tenth of its distance from the fp32
    sum's (``attention_plain_residuals``)."""
    gen = torch.Generator().manual_seed(23 + d + stable)
    q, k, v = (_randn(gen, 2, 3, 300, d).to(cuda, torch.bfloat16) for _ in range(3))
    scale = d ** -0.5
    _, lse = FA.flash_attention(q, k, v, scale, stable=stable, return_residuals=True)
    torch.cuda.synchronize()
    _assert_lse_close(lse, q, k, scale, None, None, False, stable)
    if d % 128:
        want = FA.tensor_core_lse_plain(q, k, scale, stable=stable, key_tile=_key_tile(q))[0]
        fp32_sum = FA.attention_plain_residuals(q, k, v, scale)[1]
        err, err_fp32 = (float((lse - ref).abs().mean()) for ref in (want, fp32_sum))
        assert err < 0.1 * err_fp32, f"mean |LSE diff|: the rounded sum's {err:.3e}, the fp32 sum's {err_fp32:.3e}"


# -- the qk prolog kernel: csrc/qk_prolog.cu ---------------------------------------------------------------------

QK_PROLOG_MODES = {"layer-rope": ("layer", True, True), "rms-rope": ("rms", True, True), "rope": (None, True, True),
                   "layer": ("layer", False, True), "rms": ("rms", False, True),
                   "layer-rope-q-only": ("layer", True, False)}
# (b, h, sq, sk): S = 1 and either side of the row tiles (8, 16 or 32 rows a block by type and head dim), B·H
# either side of the 4 heads in flight and the 8-head chunks; sk != sq only where there is no RoPE
QK_PROLOG_SHAPES = [(1, 1, 1, 1), (1, 3, 7, 7), (1, 4, 8, 8), (1, 5, 9, 9), (2, 4, 15, 15), (1, 9, 16, 16),
                    (3, 3, 17, 17), (1, 1, 31, 31), (2, 8, 32, 32), (1, 17, 33, 33), (2, 5, 300, 300)]


def _assert_prolog_equal(got, want, dtype):
    """bf16: bit-equal but where a norm result lies on a rounding tie (the
    kernel sums the statistics in another order): at most 0.1% of the values
    (and at least 2) differ, each by at most two bf16 steps of its row's
    largest magnitude. fp32: atol 5e-6 + rtol 1e-5 (norm statistics in
    another order)."""
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=5e-6, rtol=1e-5)
        return
    differ = got != want
    assert int(differ.sum()) <= max(2, differ.numel() // 1000), f"{int(differ.sum())} of {differ.numel()} differ"
    step = 2.0 * BF16_STEP * want.float().abs().amax(-1, keepdim=True)
    assert bool(((got.float() - want.float()).abs() <= step).all())


@pytest.mark.parametrize("mode", list(QK_PROLOG_MODES))
@pytest.mark.parametrize("d", [64, 80, 128])
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
def test_qk_prolog_kernel_matches_plain(cuda, mode, d, dtype):
    """``qk_prolog`` against ``apply_prolog_plain`` on the card at every shape
    of ``QK_PROLOG_SHAPES`` (without RoPE also with Sk != Sq), one launch a
    call for q and k together; k comes back as it went with ``prolog_k=False``."""
    norm, rope, prolog_k = QK_PROLOG_MODES[mode]
    gen = torch.Generator().manual_seed(24 + d)
    shapes = QK_PROLOG_SHAPES + ([] if rope else [(2, 3, 33, 70), (1, 9, 70, 1)])
    for b, h, sq, sk in shapes:
        q = (_randn(gen, b, h, sq, d) + 0.5).to(cuda, dtype)
        k = (_randn(gen, b, h, sk, d) - 0.5).to(cuda, dtype)
        ang = torch.rand(sq, d // 2, generator=gen) * 6.28
        pro = {"norm": norm, "eps": 1e-6, **{name: (1.0 + 0.1 * _randn(gen, d)).to(cuda)
                                            for name in ("q_scale", "q_bias", "k_scale", "k_bias")}}
        if rope:
            pro["cos"], pro["sin"] = (f(ang).repeat_interleave(2, -1).contiguous().to(cuda) for f in (torch.cos, torch.sin))
        before = FA.qk_prolog.launches
        got = FA.qk_prolog(q, k, pro, prolog_k)
        torch.cuda.synchronize()
        assert FA.qk_prolog.launches == before + 1
        want = FA.apply_prolog_plain(q, k, pro, prolog_k)
        _assert_prolog_equal(got[0], want[0], dtype)
        if prolog_k:
            _assert_prolog_equal(got[1], want[1], dtype)
        else:
            assert got[1] is k


def test_qk_prolog_refuses_what_the_kernel_does_not_take(cuda):
    """On the card the wrapper raises instead of launching or falling back."""
    q = torch.zeros(1, 2, 8, 64, device=cuda)
    pro = {"norm": "rms", "eps": 1e-6, "q_scale": torch.ones(64, device=cuda), "k_scale": torch.ones(64, device=cuda)}
    before = FA.qk_prolog.launches
    with pytest.raises(TypeError):
        FA.qk_prolog(q.half(), q.half(), pro)
    with pytest.raises(ValueError):
        FA.qk_prolog(q, q, {**pro, "k_scale": torch.ones(64)})  # on the CPU
    with pytest.raises(ValueError):
        FA.qk_prolog(q, q, {**pro, "q_scale": torch.ones(65, device=cuda)[1:]})  # misaligned
    with pytest.raises(RuntimeError):
        FA.qk_prolog(q.requires_grad_(), q, pro)
    assert FA.qk_prolog.launches == before


@pytest.mark.parametrize("d", [64, 128])
def test_bf16_prolog_call_runs_the_tensor_core_forward(cuda, d):
    """A bf16 call with a prolog is the qk prolog kernel and then the
    tensor-core forward of its route, which rounds P to bf16 before P·V as the TPU kernel
    does: bit-equal to the forward without a prolog on ``qk_prolog``'s q and
    k, and within the bf16 attention tolerance of the plain composition."""
    gen = torch.Generator().manual_seed(25)
    q, k, v = (_randn(gen, 2, 3, 200, d).to(cuda, torch.bfloat16) for _ in range(3))
    ang = torch.rand(200, d // 2, generator=gen) * 6.28
    cos, sin = (f(ang).repeat_interleave(2, -1).contiguous().to(cuda) for f in (torch.cos, torch.sin))
    qs, qb, ks, kb = (torch.rand(d, generator=gen).to(cuda) for _ in range(4))
    pro = {"norm": "layer", "eps": 1e-6, "q_scale": qs, "q_bias": qb, "k_scale": ks, "k_bias": kb, "cos": cos,
           "sin": sin}
    counts = (FA.qk_prolog.launches, dict(FA.flash_attention.launches_by_route))
    out = FA.flash_attention(q, k, v, d ** -0.5, stable=False, qk_norm="layer", q_norm_scale=qs, q_norm_bias=qb,
                             k_norm_scale=ks, k_norm_bias=kb, rope_cos=cos, rope_sin=sin)
    torch.cuda.synchronize()
    assert FA.qk_prolog.launches == counts[0] + 1
    which = FA.route(q)
    assert FA.flash_attention.launches_by_route == {**counts[1], which: counts[1][which] + 1}
    assert torch.equal(out, FA.flash_attention(*FA.qk_prolog(q, k, pro), v, d ** -0.5, stable=False))
    qr, kr = FA.apply_prolog_plain(q, k, pro)
    _assert_close_flash(out, FA.attention_plain(qr, kr, v, d ** -0.5), torch.bfloat16)


# -- the sampling surface on the card: pixel-space ALG with a tiled encode, resumes across devices, DPM interrupted

def _small_cogvideox(dev, **pipe_kw):
    """A small CogVideoX pipeline (DiT head dim 64, two layers; T5 of two
    layers; the tiny VAE) on ``dev`` in fp32, from seed 5, the same weights
    on every device."""
    import numpy as np

    from alg_tpu_torch.models.cogvideox.transformer import CogVideoXTransformer, CogVideoXTransformerConfig
    from alg_tpu_torch.models.cogvideox.vae import CogVideoXVAE, CogVideoXVAEConfig
    from alg_tpu_torch.models.t5 import T5Config, T5Encoder
    from alg_tpu_torch.pipelines.cogvideox import CogVideoXPipeline

    tcfg = CogVideoXTransformerConfig(num_attention_heads=2, attention_head_dim=64, in_channels=8, out_channels=4,
                                      time_embed_dim=32, text_embed_dim=64, num_layers=2, sample_height=8,
                                      sample_width=8, max_text_seq_length=8)
    t5cfg = T5Config(vocab_size=128, d_model=64, d_kv=64, d_ff=128, num_layers=2, num_heads=2,
                     relative_attention_num_buckets=8, relative_attention_max_distance=16)
    vcfg = CogVideoXVAEConfig(block_out_channels=(8, 16, 16, 32), latent_channels=4, layers_per_block=1,
                              norm_num_groups=4)
    gen = torch.Generator().manual_seed(5)
    dit, t5, vae = (L.init_random_(m, gen).to(dev) for m in (CogVideoXTransformer(tcfg), T5Encoder(t5cfg),
                                                             CogVideoXVAE(vcfg)))

    def tokenize(prompts, max_len):
        return np.stack([np.random.RandomState(len(p) + 3).randint(0, 128, max_len) for p in prompts])

    return CogVideoXPipeline(transformer=dit, vae=vae, t5=t5, tokenize=tokenize, device=dev, **pipe_kw)


def _surface_kwargs(size=64, **over):
    import numpy as np

    image = np.random.RandomState(6).uniform(-1, 1, (1, 3, size, size)).astype(np.float32)
    return {**dict(image=image, prompt="a red fox", negative_prompt="", height=size, width=size, num_frames=5,
                   num_inference_steps=3, guidance_scale=6.0, seed=42, max_sequence_length=8, output_type="latent",
                   use_low_pass_guidance=True, lp_filter_type="down_up", lp_resize_factor=0.25,
                   lp_strength_schedule_type="interval", schedule_interval_end_time=0.5), **over}


def test_pixel_step_with_a_tiled_encode_card_matches_cpu(cuda):
    """Pixel-space ALG at 288 x 288 with ``vae_encode_tiling=True``: each
    step's encode of the filtered frame runs as 2 x 2 overlapping tiles, on
    the card through the kernels, on the CPU through the plain versions;
    latents within the golden atol 2e-3."""
    kw = _surface_kwargs(288, num_inference_steps=2, lp_filter_type="gaussian_blur", lp_filter_in_latent=False,
                         lp_blur_sigma=3.0, lp_blur_kernel_size=0.1)
    out, encodes = {}, {}
    for dev in ("cpu", cuda):
        pipe = _small_cogvideox(dev, vae_encode_tiling=True)
        calls = []
        encode = pipe.vae.encode
        pipe.vae.encode = lambda x: (calls.append(tuple(x.shape)), encode(x))[1]
        before = FA.flash_attention.launches
        out[str(dev)] = pipe(**kw)
        encodes[str(dev)] = calls
        launched = FA.flash_attention.launches - before
    # the image, then one rebuild a step: 3 encodes of 2 x 2 tiles of at most 256 x 256
    assert encodes["cpu"] == encodes["cuda"] and len(encodes["cuda"]) == 12
    assert all(shape[2] <= 256 and shape[3] <= 256 for shape in encodes["cuda"])
    assert launched == 2 * 2 + 2 * 2  # 2 DiT forwards x 2 layers + 2 T5 encodes x 2 layers
    torch.testing.assert_close(torch.from_numpy(out["cuda"]), torch.from_numpy(out["cpu"]), atol=2e-3, rtol=0)


@pytest.mark.parametrize("first,second", [("cuda", "cpu"), ("cpu", "cuda")], ids=["card-then-cpu", "cpu-then-card"])
def test_resume_across_devices(cuda, tmp_path, first, second):
    """A run interrupted after step 1 with a snapshot every step, resumed on
    the other device: equal to the resuming device's uninterrupted run within
    the golden atol 2e-3 (the first step ran elsewhere), and the snapshot
    removed at the end."""
    snap = str(tmp_path / "run.npz")
    kw = _surface_kwargs()
    interrupted = _small_cogvideox(first)

    def stop(i, _latents):
        if i == 0:
            interrupted.interrupt = True

    interrupted(checkpoint=snap, checkpoint_every=1, step_observer=stop, **kw)
    assert (tmp_path / "run.npz").exists()
    resumed = _small_cogvideox(second)(checkpoint=snap, checkpoint_every=1, **kw)
    assert not (tmp_path / "run.npz").exists()
    whole = _small_cogvideox(second)(**kw)
    torch.testing.assert_close(torch.from_numpy(resumed), torch.from_numpy(whole), atol=2e-3, rtol=0)


def test_dpm_interrupted_at_step_zero_card_matches_cpu(cuda):
    """DPM with an observer that interrupts after the first step: one
    first-order step, the card through the kernels against the CPU; the
    observer saw step 0 only."""
    out, seen = {}, {}
    for dev in ("cpu", cuda):
        pipe = _small_cogvideox(dev, scheduler="dpm")
        steps = []

        def stop(i, _latents, pipe=pipe, steps=steps):
            steps.append(i)
            pipe.interrupt = True

        out[str(dev)] = pipe(step_observer=stop, **_surface_kwargs())
        seen[str(dev)] = steps
    assert seen == {"cpu": [0], "cuda": [0]}
    torch.testing.assert_close(torch.from_numpy(out["cuda"]), torch.from_numpy(out["cpu"]), atol=2e-3, rtol=0)


# -- CogVideoX-1.5's shapes: S = 8,386 (9 frames at 768 x 1360) and 45,106 (81 frames), their ragged last tiles ------

# S = 226 text tokens + (latent frames / 2) x 48 x 85 video tokens
COGVIDEOX15_S = {"9f": 226 + 2 * 48 * 85, "81f": 226 + 11 * 48 * 85}
COGVIDEOX15_CASES = {f"{name}{d:+d}" if d else name: s + d for name, s in COGVIDEOX15_S.items() for d in (-1, 0, 1)}


def _rows_near_the_ends(s):
    """The first 64 query rows and the last 130: the tensor-core forward's last 128-row tile, ragged at these S."""
    return torch.cat([torch.arange(64), torch.arange(max(64, s - 130), s)])


@pytest.mark.parametrize("case", list(COGVIDEOX15_CASES))
def test_qk_prep_and_forward_at_cogvideox15_lengths(cuda, case):
    """qk_prep on the head-split view (bit-equal to the contiguous call,
    within the bf16 tolerance of its plain version) and the bf16 Hopper
    forward (``"wgmma"``), at 1.5's joint lengths and one row either side, B = 1, H = 2;
    the forward's rows near both ends against the plain version over all
    keys."""
    s = COGVIDEOX15_CASES[case]
    gen = torch.Generator(cuda).manual_seed(15)
    base = torch.randn((1, s, 2, 64), generator=gen, device=cuda).to(torch.bfloat16)
    scale = 1.0 + 0.1 * torch.randn(64, generator=gen, device=cuda)
    bias = 0.1 * torch.randn(64, generator=gen, device=cuda)
    ang = torch.rand((s, 32), generator=gen, device=cuda) * 6.28
    ang[:226] = 0.0
    cos, sin = (f(ang).repeat_interleave(2, -1).contiguous() for f in (torch.cos, torch.sin))
    view = base.transpose(1, 2)
    q = QK.qk_norm_rope(view, scale, bias, cos, sin, 1e-6)
    assert torch.equal(q, QK.qk_norm_rope(view.contiguous(), scale, bias, cos, sin, 1e-6))
    _assert_close(q, QK.qk_norm_rope_plain(view, scale, bias, cos, sin, 1e-6), torch.bfloat16)
    k, v = (torch.randn((1, 2, s, 64), generator=gen, device=cuda).to(torch.bfloat16) for _ in range(2))
    before = FA.flash_attention.launches_by_route["wgmma"]
    out = FA.flash_attention(q, k, v, 64 ** -0.5, stable=False)
    torch.cuda.synchronize()
    assert FA.flash_attention.launches_by_route["wgmma"] == before + 1 and bool(torch.isfinite(out).all())
    rows = _rows_near_the_ends(s).to(cuda)
    _assert_close_flash(out[:, :, rows], FA.attention_plain(q[:, :, rows], k, v, 64 ** -0.5), torch.bfloat16)


def test_qk_prep_and_forward_at_the_shipped_cogvideox15_shape(cuda):
    """[2, 48, 45106, 64] bf16, the shipped 2-pass call (277 M values a
    tensor): qk_prep whole against its plain version, the forward's rows near
    both ends of the last batch row and head against the plain version."""
    b, h, s = 2, 48, COGVIDEOX15_S["81f"]
    gen = torch.Generator(cuda).manual_seed(16)
    x = torch.randn((b, h, s, 64), generator=gen, device=cuda).to(torch.bfloat16)
    scale, bias = torch.ones(64, device=cuda), torch.zeros(64, device=cuda)
    ang = torch.rand((s, 32), generator=gen, device=cuda) * 6.28
    cos, sin = (f(ang).repeat_interleave(2, -1).contiguous() for f in (torch.cos, torch.sin))
    q = QK.qk_norm_rope(x, scale, bias, cos, sin, 1e-6)
    for i in range(b):  # the plain version one batch row at a time
        _assert_close(q[i:i + 1], QK.qk_norm_rope_plain(x[i:i + 1], scale, bias, cos, sin, 1e-6), torch.bfloat16)
    del x
    k = torch.randn((b, h, s, 64), generator=gen, device=cuda).to(torch.bfloat16)
    v = torch.randn((b, h, s, 64), generator=gen, device=cuda).to(torch.bfloat16)
    out = FA.flash_attention(q, k, v, 64 ** -0.5, stable=False)
    torch.cuda.synchronize()
    rows = _rows_near_the_ends(s).to(cuda)
    last = (slice(b - 1, b), slice(h - 2, h))
    ref = FA.attention_plain(q[last][:, :, rows], k[last], v[last], 64 ** -0.5)
    _assert_close_flash(out[last][:, :, rows], ref, torch.bfloat16)


def test_cogvideox15_dit_forward_card_matches_cpu(cuda):
    """A 2-layer CogVideoX-1.5 DiT (temporal patches of 2, the ofs
    embedding, the slice RoPE grid) with head dim 64, fp32: the card through
    both kernels, the CPU through the plain versions, atol 1e-4."""
    from alg_tpu_torch.models.cogvideox.transformer import (CogVideoXTransformer, CogVideoXTransformerConfig,
                                                            cogvideox_rope)

    cfg = CogVideoXTransformerConfig(num_attention_heads=2, attention_head_dim=64, in_channels=8, out_channels=4,
                                     time_embed_dim=32, ofs_embed_dim=32, text_embed_dim=64, num_layers=2,
                                     sample_height=300, sample_width=300, patch_size_t=2, max_text_seq_length=8)
    gen = torch.Generator().manual_seed(3)
    dit = L.init_random_(CogVideoXTransformer(cfg), gen)
    x, text = _randn(gen, 2, 4, 8, 8, 12), _randn(gen, 2, 8, 64)
    ts, ofs = torch.tensor([999.0, 400.0]), torch.tensor([2.0])
    cos, sin = (torch.from_numpy(a) for a in cogvideox_rope(cfg, 64, 96, 4))
    with torch.no_grad():
        ref = dit(x, text, ts, cos, sin, ofs=ofs)
        before = (QK.qk_norm_rope.launches, FA.flash_attention.launches)
        out = copy.deepcopy(dit).to(cuda)(*(a.to(cuda) for a in (x, text, ts, cos, sin)), ofs=ofs.to(cuda))
        torch.cuda.synchronize()
    assert (QK.qk_norm_rope.launches - before[0], FA.flash_attention.launches - before[1]) == (4, 2)
    assert out.shape == (2, 4, 4, 8, 12)
    torch.testing.assert_close(out.cpu(), ref, atol=1e-4, rtol=0)


# -- the W8A8 / W4A8 linears (ops/quant.py) -------------------------------------------------


@pytest.mark.parametrize("rows", [1, 16, 17, 33, 4097])
@pytest.mark.parametrize("mode", ["w8", "w4"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
def test_quantized_linear_on_the_card(cuda, rows, mode, dtype):
    """``QuantizedLinear`` with in = 128·3 and out = 8·33 at rows either side of ``torch._int_mm``'s least 17
    (fewer rows take the padded path): the weight quantized on the card bit-equal to the CPU's; the int32
    accumulators bit-equal to the int8 operands' fp64 product on the card and to the CPU's int32 product; the
    output and the QLoRA backward's ``dx`` against the CPU's plain version."""
    from alg_tpu_torch.models.layers import QuantizedLinear
    from alg_tpu_torch.ops import quant as Q

    gen = torch.Generator().manual_seed(rows)
    k, n = 3 * 128, 33 * 8
    lin = torch.nn.Linear(k, n, dtype=dtype)
    with torch.no_grad():
        lin.weight.copy_(_randn(gen, n, k, scale=k ** -0.5))
        lin.bias.copy_(_randn(gen, n, scale=0.1))
    plain = QuantizedLinear.from_linear(lin, mode)
    card = QuantizedLinear.from_linear(copy.deepcopy(lin).to(cuda), mode)
    for name, buf in plain.named_buffers():
        assert torch.equal(card.get_buffer(name).cpu(), buf), name
    x = _randn(gen, rows, k).to(dtype)
    xq, _ = Q.quantize_rows(x.to(cuda))
    acc = Q.int8_matmul(xq, card.int8_weight())
    assert acc.dtype == torch.int32 and acc.shape == (rows, n)
    assert torch.equal(acc.double(), xq.double() @ card.int8_weight().double().t())
    assert torch.equal(acc.cpu(), Q.int8_matmul(Q.quantize_rows(x)[0], plain.int8_weight()))
    xg, xc = x.to(cuda).requires_grad_(), x.clone().requires_grad_()
    yg, yc = card(xg), plain(xc)
    assert yg.dtype == dtype
    _assert_close(yg, yc, dtype)
    g = _randn(gen, rows, n).to(dtype)
    yg.backward(g.to(cuda))
    yc.backward(g)
    _assert_close(xg.grad, xc.grad, dtype)
    assert card.bias.grad is None


@pytest.mark.parametrize("mode", ["w8", "w4"])
def test_qlora_step_card_matches_cpu(cuda, mode):
    """One QLoRA step (rank 4, remat, AdamW lr 1e-2, eps 1e-4) over a small CogVideoX DiT quantized in place (block
    linears of 128 and 512), card against CPU in fp32, the card's quantized linears fed the CPU run's inputs
    (``quant_feed.qlora_step_agreement``, as ``chip_smoke.py``'s Q5): loss rtol 1e-5, gradients within 1e-4 of each
    leaf's largest, the card's step within atol 1e-5 of the CPU's optimizer on the card's gradients, and the
    quantized base takes no gradient."""
    out = qlora_step_agreement(cuda, mode, seed=6)
    print(out["line"])
    assert out["ok"], out["line"]


def _ring(q, k, v, sp, kv_len, stable, chunk_attention=None):
    """The ring of ``sp`` ranks played in turn in one process (``ops.attention._ring_attention_local`` with a
    rotation that hands over the previous rank's chunk); the ranks' outputs concatenated."""
    from alg_tpu_torch.ops.attention import _ring_attention_local

    chunk = k.shape[2] // sp
    kc, vc = k.split(chunk, dim=2), v.split(chunk, dim=2)
    outs = []
    for idx in range(sp):
        rotate = lambda r, k_, v_, i=idx: (lambda: (kc[(i - r - 1) % sp], vc[(i - r - 1) % sp]))  # noqa: E731
        outs.append(_ring_attention_local(q[:, :, idx * chunk:(idx + 1) * chunk], kc[idx], vc[idx], kv_len,
                                          scale=q.shape[-1] ** -0.5, stable=stable, sp=sp, index=idx, rotate=rotate,
                                          chunk_attention=chunk_attention))
    return torch.cat(outs, dim=2)


@pytest.mark.parametrize("case", [
    dict(b=2, h=3, s=300, d=64, sp=2, kv_len=None, stable=False),
    dict(b=1, h=2, s=243, d=128, sp=3, kv_len=[200], stable=False),
    dict(b=2, h=2, s=256, d=128, sp=4, kv_len=[60, 256], stable=True),
    dict(b=1, h=2, s=40, d=80, sp=4, kv_len=[0], stable=False),
], ids=["dense-sp2", "ragged-sq-sp3", "chunks-past-kv_len-sp4", "no-key-sp4"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
def test_ring_attention_on_the_kernel_matches_plain(cuda, case, dtype):
    """Ring attention over the forward kernel's LSE, one process playing every rank: against the same ring over
    the plain residual version, and against the plain attention of the whole sequence. A query length of 243
    at sp = 3 (chunks of 81, no multiple of the kernel's tiles); row 0's kv_len of 60 at sp = 4 leaves its
    chunks 1-3 wholly past it, which the kernel must return as zeros with an LSE of -inf for the merge to stay
    finite; a row with no key at all comes out as zeros."""
    gen = torch.Generator().manual_seed(90)
    shape = (case["b"], case["h"], case["s"], case["d"])
    q, k, v = (_randn(gen, *shape).to(dtype) for _ in range(3))
    kv_len = None if case["kv_len"] is None else torch.tensor(case["kv_len"], dtype=torch.int32)
    scale = case["d"] ** -0.5

    def plain_chunk(q_, k_, v_, kvl):
        return FA.attention_plain_residuals(q_, k_, v_, scale, kv_len=kvl)

    FA.flash_attention.residual_launches = 0
    out = _ring(q.to(cuda), k.to(cuda), v.to(cuda), case["sp"], None if kv_len is None else kv_len.to(cuda),
                case["stable"])
    assert FA.flash_attention.residual_launches == case["sp"] ** 2
    assert bool(torch.isfinite(out).all())
    plain_ring = _ring(q, k, v, case["sp"], kv_len, case["stable"], plain_chunk)
    whole = FA.attention_plain(q, k, v, scale, kv_len=kv_len)
    _assert_close_flash(out, plain_ring, dtype)
    _assert_close_flash(out, whole, dtype)
    if case["kv_len"] == [0]:
        assert bool((out == 0).all())


def test_flash_kernel_gives_zeros_and_minus_inf_lse_on_a_chunk_past_kv_len(cuda):
    """The ring's per-chunk call with ``kv_len`` 0 for one row and a partial count for the other: zeros and
    -inf where no key is seen, the plain residual version's output and LSE elsewhere, in both types."""
    gen = torch.Generator().manual_seed(91)
    for dtype in DTYPES:
        q, k, v = (_randn(gen, 2, 2, 64, 128).to(dtype) for _ in range(3))
        kvl = torch.tensor([0, 17], dtype=torch.int32)
        out, lse = FA.flash_attention(q.to(cuda), k.to(cuda), v.to(cuda), 128 ** -0.5, stable=False,
                                      kv_len=kvl.to(cuda), return_residuals=True)
        ref_out, ref_lse = FA.attention_plain_residuals(q, k, v, 128 ** -0.5, kv_len=kvl)
        assert bool((out[0] == 0).all()) and bool(torch.isneginf(lse[0]).all())
        _assert_close_flash(out, ref_out, dtype)
        torch.testing.assert_close(lse[1].cpu(), ref_lse[1], atol=2e-3 if dtype == torch.bfloat16 else 1e-4,
                                   rtol=1e-4)


# -- the Hopper forward: csrc/flash_attention_wgmma.cu (bf16, D = 64 and 128, no bias) --------------------------

WGMMA_CASES = {
    # name: (b, h, sq, sk, kv_len, causal, stable); 192 query rows a block at D = 64, 128 at D = 128; 128 keys a
    # tile
    "s1000": (2, 3, 1000, 1000, None, False, False),
    "s1000-stable": (2, 3, 1000, 1000, None, False, True),
    "s4276": (1, 3, 4276, 4276, None, False, False),
    "s4276-stable": (1, 3, 4276, 4276, None, False, True),
    "one-row": (3, 2, 1, 1, None, False, True),
    "block-edges": (1, 2, 193, 257, None, False, False),
    "block-edges-d128": (1, 2, 129, 385, None, False, True),
    "sq70-sk300": (2, 2, 70, 300, None, False, True),
    "sq300-sk70": (2, 2, 300, 70, None, False, False),
    "sq1000-sk4276": (1, 2, 1000, 4276, None, False, True),
    "kvlen-tile-edges": (7, 2, 200, 300, [0, 1, 127, 128, 129, 255, 300], False, False),
    "kvlen-tile-edges-stable": (7, 2, 150, 300, [0, 1, 127, 128, 129, 257, 300], False, True),
    "causal-square": (2, 2, 500, 500, None, True, True),
    "causal-sq200-sk600": (2, 2, 200, 600, None, True, False),
    "causal-sq600-sk200": (1, 3, 600, 200, None, True, True),  # its first 400 rows see no key
    "causal-kvlen": (2, 2, 400, 400, [400, 0], True, False),
}


def _tc_forward(q, k, v, scale, stable, kv_len=None, causal=False):
    """The same call through the ``"tc"`` kernel's entry point (``csrc/flash_attention_tc.cu``), which the
    wrapper no longer routes it to."""
    b, h, sq, d = q.shape
    out = torch.empty_like(q)
    rc = FA._entry(d, "tc")(FA._build.DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), None, 0,
                            None if kv_len is None else kv_len.data_ptr(), out.data_ptr(), None, b, h, sq,
                            k.shape[2], float(scale), int(stable), int(causal),
                            torch.cuda.current_stream().cuda_stream)
    assert rc == 0
    return out


@pytest.mark.parametrize("case", list(WGMMA_CASES))
@pytest.mark.parametrize("d", [64, 128], ids=["d64", "d128"])
def test_wgmma_forward_matches_the_tensor_core_arithmetic(cuda, case, d):
    """bf16 at D = 64 and 128 without a bias takes the Hopper kernel and no
    ``"tc"`` launch: its output within the bf16 attention tolerance of
    ``tensor_core_attention_plain`` over its 128-key tiles (the denominator
    Σ bf16(p) at D = 64, Σ p at 128), its LSE within 1e-4 of the kernel's
    denominator (``_assert_lse_close``) with -inf and zero rows where no key
    is visible, the same output with and without the LSE. Against the
    ``"tc"`` kernel it replaces: at D = 64 without a running max, where the
    key tiles do not enter the arithmetic, bit-equal; at D = 128, whose
    fp32 row sums the two kernels take in other orders, within the bf16
    tolerance."""
    b, h, sq, sk, kv_len, causal, stable = WGMMA_CASES[case]
    gen = torch.Generator().manual_seed(23)
    q = _randn(gen, b, h, sq, d).to(cuda, torch.bfloat16)
    k, v = (_randn(gen, b, h, sk, d).to(cuda, torch.bfloat16) for _ in range(2))
    lens = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32, device=cuda)
    scale = d ** -0.5
    assert FA.route(q) == "wgmma" and FA.KEY_TILE["wgmma"] == 128
    counts = dict(FA.flash_attention.launches_by_route)
    out, lse = FA.flash_attention(q, k, v, scale, stable=stable, kv_len=lens, causal=causal, return_residuals=True)
    alone = FA.flash_attention(q, k, v, scale, stable=stable, kv_len=lens, causal=causal)
    torch.cuda.synchronize()
    assert FA.flash_attention.launches_by_route == {**counts, "wgmma": counts["wgmma"] + 2}
    assert torch.equal(out, alone) and out.dtype == torch.bfloat16 and bool(torch.isfinite(out).all())
    ref = FA.tensor_core_attention_plain(q, k, v, scale, None, lens, causal, stable, key_tile=128)[0]
    _assert_close_flash(out, ref, torch.bfloat16)
    seen = _assert_lse_close(lse, q, k, scale, None, lens, causal, stable)
    assert not out[~seen].any()
    tc = _tc_forward(q, k, v, scale, stable, lens, causal)
    if d == 64 and not stable:
        assert torch.equal(out, tc)
    else:
        _assert_close_flash(out, tc, torch.bfloat16)


def _plain_heads(q, k, v, scale, stable, heads, rows=4096, kv_len=None):
    """``tensor_core_attention_plain`` (128-key tiles) of the (batch, head) pairs ``heads``, over row chunks."""
    out = {}
    for bi, hi in heads:
        kk, vv = k[bi:bi + 1, hi:hi + 1], v[bi:bi + 1, hi:hi + 1]
        lens = None if kv_len is None else kv_len[bi:bi + 1]
        out[bi, hi] = torch.cat([FA.tensor_core_attention_plain(q[bi:bi + 1, hi:hi + 1, i:i + rows], kk, vv, scale,
                                                                kv_len=lens, stable=stable, key_tile=128)[0]
                                 for i in range(0, q.shape[2], rows)], dim=2)
    return out


@pytest.mark.parametrize("stable", [False, True], ids=["unstable", "stable"])
@pytest.mark.parametrize("shape", [(3, 48, 18002, 64), (2, 48, 45106, 64)], ids=["cogvideox-b3", "cogvideox15"])
def test_wgmma_forward_at_the_shipped_lengths(cuda, shape, stable):
    """The DiT's calls at their full lengths (CogVideoX's 3-pass step at S =
    18,002, CogVideoX-1.5's at 45,106): every row of three heads (the first,
    one in the middle, the last) within the bf16 attention tolerance of
    ``tensor_core_attention_plain``; the whole output against the ``"tc"``
    kernel, bit-equal without a running max, within the tolerance with one."""
    b, h, s, d = shape
    gen = torch.Generator(cuda).manual_seed(24)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda).to(torch.bfloat16) for _ in range(3))
    before = FA.flash_attention.launches_by_route["wgmma"]
    out = FA.flash_attention(q, k, v, d ** -0.5, stable=stable)
    torch.cuda.synchronize()
    assert FA.flash_attention.launches_by_route["wgmma"] == before + 1 and bool(torch.isfinite(out).all())
    heads = [(0, 0), (b // 2, h // 2), (b - 1, h - 1)]
    for (bi, hi), ref in _plain_heads(q, k, v, d ** -0.5, stable, heads).items():
        _assert_close_flash(out[bi:bi + 1, hi:hi + 1], ref, torch.bfloat16)
    tc = _tc_forward(q, k, v, d ** -0.5, stable)
    if stable:
        _assert_close_flash(out, tc, torch.bfloat16)
    else:
        assert torch.equal(out, tc)


@pytest.mark.parametrize("case", [
    ((3, 40, 32760, 128), 32760, None),  # the Wan DiT's self-attention in a 3-pass step, 81 frames at 480 x 832
    ((3, 40, 32760, 128), 512, None),  # its cross-attention to the 512 text tokens
    ((3, 40, 32760, 128), 257, None),  # and to the 257 image tokens
    ((1, 24, 28128, 128), 28128, [27904]),  # HunyuanVideo's joint [video; text] at 129 frames, its text padded
], ids=["wan-self-b3", "wan-cross-text", "wan-cross-image", "hunyuan-joint-kvlen"])
def test_wgmma_forward_at_the_shipped_d128_lengths(cuda, case):
    """The D = 128 calls at their full lengths on the Hopper kernel, as the
    DiTs make them (no running max): every row of three heads (the first,
    one in the middle, the last) within the bf16 attention tolerance of
    ``tensor_core_attention_plain`` (Σ p over 128-key tiles); the whole
    output within the tolerance of the ``"tc"`` kernel it replaces."""
    shape, sk, kv_len = case
    b, h, s, d = shape
    gen = torch.Generator(cuda).manual_seed(25)
    q = torch.randn(shape, generator=gen, device=cuda).to(torch.bfloat16)
    k, v = (torch.randn((b, h, sk, d), generator=gen, device=cuda).to(torch.bfloat16) for _ in range(2))
    lens = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32, device=cuda)
    before = dict(FA.flash_attention.launches_by_route)
    out = FA.flash_attention(q, k, v, d ** -0.5, stable=False, kv_len=lens)
    torch.cuda.synchronize()
    assert FA.flash_attention.launches_by_route == {**before, "wgmma": before["wgmma"] + 1}
    assert bool(torch.isfinite(out).all())
    heads = [(0, 0), (b // 2, h // 2), (b - 1, h - 1)]
    for (bi, hi), ref in _plain_heads(q, k, v, d ** -0.5, False, heads, kv_len=lens).items():
        _assert_close_flash(out[bi:bi + 1, hi:hi + 1], ref, torch.bfloat16)
    _assert_close_flash(out, _tc_forward(q, k, v, d ** -0.5, False, lens), torch.bfloat16)


@pytest.mark.parametrize("d", [64, 128], ids=["d64", "d128"])
def test_wgmma_entry_refuses_what_it_does_not_take(cuda, d):
    """The Hopper entry points (``_d64``, ``_d128``) take bf16 without a bias only: fp32, or a bias pointer,
    returns cudaErrorInvalidValue and writes nothing."""
    x = torch.full((1, 2, 40, d), 7.0, device=cuda)
    fn = FA._entry(d, "wgmma")
    stream = torch.cuda.current_stream().cuda_stream
    fp32 = FA._build.DTYPE_CODE[torch.float32]
    assert fn(fp32, *([x.data_ptr()] * 3), None, 0, None, x.data_ptr(), None, 1, 2, 40, 40, 0.125, 0, 0, stream) == 1
    y = x.bfloat16()
    bias = torch.zeros((1, 2, 40, 40), device=cuda)
    bf16 = FA._build.DTYPE_CODE[torch.bfloat16]
    assert fn(bf16, *([y.data_ptr()] * 3), bias.data_ptr(), 0, None, y.data_ptr(), None, 1, 2, 40, 40, 0.125, 0, 0,
              stream) == 1
    torch.cuda.synchronize()
    assert bool((x == 7.0).all()) and bool((y == 7.0).all())


# -- the DiT blocks' AdaLN chain (csrc/ada_norm.cu) --------------------------------------------------------------

# The variants, by the parts of the chain a launch does: "add" the residual add (x + o), "gate" the gated add
# (x + g·o), "norm" the LayerNorm, "affine" its fp32 affine, "mod" the modulation. The blocks launch
# norm_affine_mod (CogVideoX norm1), gate_norm_affine_mod (the attention's gated residual with norm2), norm_mod
# (Wan), gate_norm_affine (Wan's gated residual with norm2), add_norm_mod (Wan's cross-attention residual with the
# MLP's norm) and gate (both MLPs' gated residual); norm and add the two left over.
ADA_VARIANTS = ["norm", "norm_affine", "norm_mod", "norm_affine_mod", "add_norm_mod", "gate_norm_affine",
                "gate_norm_affine_mod", "gate", "add"]
# rows a stream (CogVideoX: text, then video) and the width: the two widths of the main path, and a ragged
# one whose last warp holds 5 active lanes
ADA_SHAPES = {
    "cog": dict(b=2, rows=(5, 37), d=3072),
    "cog-no-text": dict(b=2, rows=(0, 29), d=3072),
    "wan": dict(b=3, rows=(300,), d=5120),
    "d40": dict(b=1, rows=(8,), d=40),
    "d40-two-streams": dict(b=2, rows=(3, 5), d=40),
}


def _ada_inputs(gen, dev, dtype, variant, b, rows, d):
    """Keyword arguments of ``ada_norm`` for ``variant``: o a column slice of a wider [B, ΣR, 3d] tensor (its
    rows step over the other columns), each stream's vectors [B, 1, d] views of one [B, 6d] modulation output."""
    parts = set(variant.split("_"))
    xs = tuple((_randn(gen, b, r, d, scale=2.0) + 0.5).to(dev, dtype) for r in rows)
    o = _randn(gen, b, sum(rows), 3 * d).to(dev, dtype)[:, :, d:2 * d]
    mods = [(0.3 * _randn(gen, b, 6 * d)).to(dev, dtype) for _ in rows]
    vec = lambda k: tuple(m[:, None, k * d:(k + 1) * d] for m in mods)  # noqa: E731
    return dict(xs=xs, o=o if parts & {"add", "gate"} else None, gates=vec(2) if "gate" in parts else None,
                scales=vec(1) if "mod" in parts else None, shifts=vec(0) if "mod" in parts else None,
                weight=(1.0 + 0.2 * _randn(gen, d)).to(dev, dtype) if "affine" in parts else None,
                bias=(0.2 * _randn(gen, d)).to(dev, dtype) if "affine" in parts else None, eps=1e-5,
                norm="norm" in parts)


def _bf16_ulp(v):
    """The spacing of bf16 values at |v| (8 significant bits)."""
    return torch.exp2(torch.floor(torch.log2(v.float().abs().clamp_min(2.0 ** -126))) - 7)


def _ada_norm_bound(kw, residuals, ref, dtype):
    """How far the kernel's normed rows may lie from the plain ones. fp32: 1e-5 + 1e-5·|ref| (the row sums'
    order). bf16: one rounding step at the norm's output, widened by 2^-19 of the magnitudes that meet in its
    fp32 value (the row sums' order moves the mean and the variance by a few fp32 ulps, and under cancellation
    in the affine that can be more than a step of a small result), carried through the modulation's two
    roundings (that times 1 + scale, a step of the product, a step of the result)."""
    if dtype == torch.float32:
        return 1e-5 + 1e-5 * ref.float().abs()
    from alg_tpu_torch.models import layers as Lm

    ln = torch.cat([Lm.layer_norm(x, kw["weight"], kw["bias"], kw["eps"]) for x in residuals], dim=1)
    mags = []
    for x in residuals:
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        mag = (xf.abs() + mean.abs()) * torch.rsqrt((xf - mean).square().mean(-1, keepdim=True) + kw["eps"])
        if kw["weight"] is not None:
            mag = mag * kw["weight"].float().abs() + kw["bias"].float().abs()
        mags.append(mag)
    at_norm = _bf16_ulp(ln) + 2.0 ** -19 * torch.cat(mags, dim=1)
    if kw["scales"] is None:
        return at_norm
    s1 = torch.cat([(1 + s).expand(x.shape) for s, x in zip(kw["scales"], residuals)], dim=1)
    return at_norm * s1.float().abs() + _bf16_ulp(ln * s1) + _bf16_ulp(ref)


def _check_ada_norm(kw, got, want, dtype):
    (res, y), (res_ref, y_ref) = got, want
    for a, r in zip(res, res_ref):
        assert a.shape == r.shape and torch.equal(a, r)  # the residual adds round as the plain ops do
    if y_ref is None:
        assert y is None
        return
    assert y.shape == y_ref.shape and y.dtype == y_ref.dtype
    err = (y.float() - y_ref.float()).abs()
    bound = _ada_norm_bound(kw, res_ref, y_ref, dtype)
    assert bool((err <= bound).all()), f"max|diff| {err.max().item():.3e}, worst excess {(err - bound).max():.3e}"


@pytest.mark.parametrize("shape", list(ADA_SHAPES))
@pytest.mark.parametrize("variant", ADA_VARIANTS)
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
def test_ada_norm_kernel_matches_plain(cuda, shape, variant, dtype):
    """Each variant against the plain composition on the card: the new residuals bit for bit, the normed rows
    within :func:`_ada_norm_bound`; one launch a call."""
    from alg_tpu_torch.ops import ada_norm as AN

    gen = torch.Generator().manual_seed(11)
    kw = _ada_inputs(gen, cuda, dtype, variant, **ADA_SHAPES[shape])
    xs = kw.pop("xs")
    before = AN.ada_norm.launches
    got = AN.ada_norm(xs, **kw)
    torch.cuda.synchronize()
    assert AN.ada_norm.launches == before + 1
    _check_ada_norm(kw, got, AN.ada_norm_plain(xs, **kw), dtype)
    if kw["o"] is None:
        assert all(a is x for a, x in zip(got[0], xs))


@pytest.mark.parametrize("shape", [(2, (226, 17776), 3072), (2, (226, 45106), 3072), (3, (32760,), 5120)],
                         ids=["cogvideox-49f", "cogvideox15-81f", "wan-81f"])
def test_ada_norm_kernel_at_the_shipped_lengths(cuda, shape):
    """The fused gate + norm launch of each cell's blocks, bf16, at the shipped joint lengths (CogVideoX's with
    norm2's affine and the modulation, Wan's with the affine alone)."""
    from alg_tpu_torch.ops import ada_norm as AN

    b, rows, d = shape
    gen = torch.Generator(cuda).manual_seed(12)
    variant = "gate_norm_affine_mod" if len(rows) == 2 else "gate_norm_affine"
    parts = set(variant.split("_"))
    xs = tuple(torch.randn((b, r, d), generator=gen, device=cuda).to(torch.bfloat16) for r in rows)
    o = torch.randn((b, sum(rows), d), generator=gen, device=cuda).to(torch.bfloat16)
    vec = lambda: tuple((0.3 * torch.randn((b, 1, d), generator=gen, device=cuda)).to(torch.bfloat16)  # noqa: E731
                        for _ in rows)
    kw = dict(o=o, gates=vec(), scales=vec() if "mod" in parts else None, eps=1e-6,
              weight=(1 + 0.2 * torch.randn(d, generator=gen, device=cuda)).to(torch.bfloat16),
              bias=(0.2 * torch.randn(d, generator=gen, device=cuda)).to(torch.bfloat16))
    kw["shifts"] = vec() if "mod" in parts else None
    _check_ada_norm(kw, AN.ada_norm(xs, **kw), AN.ada_norm_plain(xs, **kw), torch.bfloat16)


def test_ada_norm_gradients_are_the_plain_composition(cuda):
    """With inputs that require a gradient the forward is still one launch, and the gradients of every input,
    both streams, are those of autograd through the plain composition (its own backward)."""
    from alg_tpu_torch.ops import ada_norm as AN

    gen = torch.Generator().manual_seed(13)
    kw = _ada_inputs(gen, cuda, torch.float32, "gate_norm_affine_mod", b=2, rows=(3, 21), d=64)
    xs = tuple(x.requires_grad_() for x in kw.pop("xs"))
    for name in ("gates", "scales", "shifts"):
        kw[name] = tuple(v.detach().clone().requires_grad_() for v in kw[name])
    kw["o"] = kw["o"].detach().clone().requires_grad_()
    kw["weight"].requires_grad_()
    kw["bias"].requires_grad_()
    leaves = [*xs, kw["o"], *kw["gates"], *kw["scales"], *kw["shifts"], kw["weight"], kw["bias"]]
    before = AN.ada_norm.launches
    (e, h), y = AN.ada_norm(xs, **kw)
    assert AN.ada_norm.launches == before + 1 and y.grad_fn is not None
    cots = [_randn(gen, *t.shape).to(cuda) for t in (e, h, y)]
    got = torch.autograd.grad((e, h, y), leaves, cots)
    (e_r, h_r), y_r = AN.ada_norm_plain(xs, **kw)
    want = torch.autograd.grad((e_r, h_r, y_r), leaves, cots)
    for a, r in zip(got, want):
        assert torch.equal(a, r)


def test_ada_norm_refuses_what_the_kernel_does_not_take(cuda):
    """A width that is no multiple of 8 or above 5,120, half precision, misaligned rows, mixed dtypes: each
    raises on the card, launches nothing and runs nothing in its place."""
    from alg_tpu_torch.ops import ada_norm as AN

    x = torch.zeros(1, 4, 64, device=cuda)
    before = AN.ada_norm.launches
    with pytest.raises(ValueError, match="multiple of 8"):
        AN.ada_norm((torch.zeros(1, 4, 36, device=cuda),))
    with pytest.raises(ValueError, match="multiple of 8"):
        AN.ada_norm((torch.zeros(1, 4, 5128, device=cuda),))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        AN.ada_norm((x.half(),))
    with pytest.raises(ValueError, match="unit stride"):
        AN.ada_norm((torch.zeros(1, 4, 72, device=cuda)[:, :, 2:66],))
    with pytest.raises(TypeError):
        AN.ada_norm((x,), x.bfloat16())
    assert AN.ada_norm.launches == before
