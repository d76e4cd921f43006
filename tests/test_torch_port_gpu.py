"""The port's CUDA kernels on the card against their plain PyTorch versions,
at small ragged shapes that ``chip_smoke.py``'s main-path shapes do not
reach: Sq != Sk, fewer keys than one 16-key chunk, a per-batch bias, a
query tile that is mostly past Sq, a single row. Every test is marked
``gpu`` and skips without a CUDA card. On a machine with one::

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_port_gpu.py -q

(``--noconftest``: the suite's ``conftest.py`` imports jax, which the port
does not need.) Nothing here imports jax.

Tolerances, as in ``chip_smoke.py``: fp32 with TF32 off, atol 2e-5 + rtol
1e-5 (only the summation order differs); bf16, atol 2e-2 + rtol 1e-2 (the
kernels round once at the end where the plain versions round after each
op, or round the probabilities before P·V: about two bf16 ulps)."""

import copy

import pytest
import torch

from alg_tpu_torch.models import layers as L
from alg_tpu_torch.ops import flash_attention as FA
from alg_tpu_torch.ops import qk_prep as QK

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
    _assert_close(out, FA.attention_plain(q, k, v, scale, bias), dtype)


@pytest.mark.parametrize("s", [1, 300])
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
def test_qk_prep_kernel_matches_plain(cuda, s, dtype):
    gen = torch.Generator().manual_seed(1)
    x = _randn(gen, 2, 3, s, 64).to(cuda, dtype)
    scale, bias = (1.0 + _randn(gen, 64, scale=0.1)).to(cuda), _randn(gen, 64, scale=0.1).to(cuda)
    ang = torch.rand((s, 32), generator=gen) * 6.28
    n_id = s // 3
    ang[:n_id] = 0.0  # identity rows, as over the DiT's text prefix
    cos = torch.cos(ang).repeat_interleave(2, -1).to(cuda)
    sin = torch.sin(ang).repeat_interleave(2, -1).to(cuda)
    before = QK.qk_norm_rope.launches
    out = QK.qk_norm_rope(x, scale, bias, cos, sin, 1e-6)
    torch.cuda.synchronize()
    assert QK.qk_norm_rope.launches == before + 1
    _assert_close(out, QK.qk_norm_rope_plain(x, scale, bias, cos, sin, 1e-6), dtype)
    # identity rows reduce to the LayerNorm output, up to one rounding step
    # of the activation dtype (the two reduce mean and variance in other orders)
    ln = L.layer_norm(x[:, :, :n_id], scale, bias, 1e-6)
    atol, rtol = (2e-6, 1e-6) if dtype == torch.float32 else (1e-6, 8e-3)
    torch.testing.assert_close(out[:, :, :n_id].float(), ln.float(), atol=atol, rtol=rtol)


def test_cuda_wrappers_raise_instead_of_falling_back(cuda):
    """What the kernels do not take raises on the card; nothing launches and
    nothing runs the plain version instead."""
    q = torch.zeros(1, 2, 8, 64, device=cuda)
    ones, zeros = torch.ones(64, device=cuda), torch.zeros(64, device=cuda)
    tab = torch.ones(8, 64, device=cuda)
    before = (FA.flash_attention.launches, QK.qk_norm_rope.launches)
    with pytest.raises(TypeError):
        FA.flash_attention(q.half(), q.half(), q.half(), 0.125)
    with pytest.raises(ValueError):
        FA.flash_attention(torch.zeros(1, 8, 2, 64, device=cuda).transpose(1, 2), q, q, 0.125)
    with pytest.raises(ValueError):
        wide = torch.zeros(1, 2, 8, 128, device=cuda)
        FA.flash_attention(wide, wide, wide, 0.125)
    with pytest.raises(TypeError):
        QK.qk_norm_rope(q.half(), ones, zeros, tab, tab, 1e-6)
    with pytest.raises(ValueError):
        QK.qk_norm_rope(q, ones, zeros, tab.half(), tab, 1e-6)
    assert (FA.flash_attention.launches, QK.qk_norm_rope.launches) == before


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
    with torch.no_grad():
        ref = dit(x, text, ts, cos, sin)
        before = (QK.qk_norm_rope.launches, FA.flash_attention.launches)
        out = copy.deepcopy(dit).to(cuda)(*(a.to(cuda) for a in (x, text, ts, cos, sin)))
        torch.cuda.synchronize()
    assert (QK.qk_norm_rope.launches - before[0], FA.flash_attention.launches - before[1]) == (4, 2)
    torch.testing.assert_close(out.cpu(), ref, atol=1e-4, rtol=0)
