"""The DiT blocks' AdaLN chain (``alg_tpu_torch/ops/ada_norm.py``) on the CPU.

The plain composition is bit for bit the expressions it replaced in the
CogVideoX and Wan blocks, for each of the four variants the blocks launch
(norm only, gate + norm, plain add + norm, gate only) in both dtypes and at
tiny widths; a CogVideoX and a Wan block give the outputs of the blocks as
they were written before, bit for bit; the autograd wrapper (its forward
standing in for the kernel) gives the plain composition's gradients; the
argument and layout checks refuse what the kernel does not take, and a
device other than CPU or CUDA raises. The kernel itself is held to the plain
composition on the card (``tests/test_torch_port_gpu.py``)."""

import ctypes
import re

import pytest
import torch

from alg_tpu_torch.models import layers as L
from alg_tpu_torch.models.cogvideox.transformer import CogVideoXBlock, CogVideoXTransformerConfig
from alg_tpu_torch.models.wan.transformer import WanBlock, WanTransformerConfig
from alg_tpu_torch.ops import _build
from alg_tpu_torch.ops import ada_norm as A

from torch_port_common import one_thread  # noqa: F401  (one torch thread)

DTYPES = [torch.float32, torch.bfloat16]


def _rand(gen, *shape, dtype=torch.float32, scale=1.0):
    return (torch.randn(shape, generator=gen) * scale).to(dtype)


def _streams(gen, dtype, b, rows, d):
    xs = tuple(_rand(gen, b, r, d, dtype=dtype, scale=2.0) + 0.5 for r in rows)
    o = _rand(gen, b, sum(rows), d, dtype=dtype)
    vec = lambda: tuple(_rand(gen, b, 1, d, dtype=dtype, scale=0.3) for _ in rows)  # noqa: E731
    return xs, o, vec(), vec(), vec(), 1.0 + _rand(gen, d, dtype=dtype, scale=0.1), _rand(gen, d, dtype=dtype,
                                                                                          scale=0.1)


def _equal(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("text_len", [3, 0])
def test_plain_is_the_cogvideox_expressions(dtype, text_len):
    """norm1 (both streams' modulated norms, concatenated), the attention's
    gated residuals with norm2, the MLP's gated residuals."""
    gen = torch.Generator().manual_seed(1)
    (enc, hid), o, gates, scales, shifts, w, bias = _streams(gen, dtype, 2, (text_len, 7), 40)
    (e_gate, gate), (e_scale, scale), (e_shift, shift) = gates, scales, shifts

    def norms(enc, hid):
        hn = L.layer_norm(hid, w, bias, 1e-5) * (1 + scale) + shift
        en = L.layer_norm(enc, w, bias, 1e-5) * (1 + e_scale) + e_shift
        return torch.cat([en, hn], dim=1)

    kw = dict(scales=(e_scale, scale), shifts=(e_shift, shift), weight=w, bias=bias, eps=1e-5)
    (e1, h1), joint = A.ada_norm((enc, hid), **kw)
    _equal(joint, norms(enc, hid))
    assert e1 is enc and h1 is hid

    (e2, h2), joint = A.ada_norm((enc, hid), o, gates=(e_gate, gate), **kw)
    want_e, want_h = enc + e_gate * o[:, :text_len], hid + gate * o[:, text_len:]
    _equal(e2, want_e)
    _equal(h2, want_h)
    _equal(joint, norms(want_e, want_h))

    (e3, h3), none = A.ada_norm((enc, hid), o, gates=(e_gate, gate), norm=False)
    assert none is None
    _equal(h3, hid + gate * o[:, text_len:])
    _equal(e3, enc + e_gate * o[:, :text_len])


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
def test_plain_is_the_wan_expressions(dtype):
    """The modulated norm without an affine, the gated residual with norm2's
    affine, the plain residual with the modulated norm, the gated residual."""
    gen = torch.Generator().manual_seed(2)
    (x,), o, (gate,), (scale,), (shift,), w, bias = _streams(gen, dtype, 3, (9,), 48)
    eps = 1e-6

    (same,), xn = A.ada_norm((x,), scales=(scale,), shifts=(shift,), eps=eps)
    assert same is x
    _equal(xn, L.layer_norm(x, None, None, eps) * (1 + scale) + shift)

    (x2,), xn = A.ada_norm((x,), o, gates=(gate,), weight=w, bias=bias, eps=eps)
    _equal(x2, x + gate * o)
    _equal(xn, L.layer_norm(x + gate * o, w, bias, eps))

    (x3,), xn = A.ada_norm((x,), o, scales=(scale,), shifts=(shift,), eps=eps)
    _equal(x3, x + o)
    _equal(xn, L.layer_norm(x + o, None, None, eps) * (1 + scale) + shift)

    (x4,), none = A.ada_norm((x,), o, gates=(gate,), norm=False)
    assert none is None
    _equal(x4, x + gate * o)


def _perturb_norms(module, gen):
    """Norm affines away from 1 and 0, so that a dropped or misplaced affine shows."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, L.LayerNorm) and m.weight is not None:
                m.weight.copy_(1.0 + 0.2 * torch.randn(m.weight.shape, generator=gen))
                m.bias.copy_(0.2 * torch.randn(m.bias.shape, generator=gen))
    return module


def _parent_cogvideox_block(blk, hidden, encoder, temb, rope_cos, rope_sin):
    """The CogVideoX block's forward as written before the chain had a kernel."""
    def norm(m, hidden, encoder):
        shift, scale, gate, e_shift, e_scale, e_gate = m.linear(L.silu(temb)).chunk(6, dim=-1)
        hn = m.norm(hidden) * (1 + scale[:, None]) + shift[:, None]
        en = m.norm(encoder) * (1 + e_scale[:, None]) + e_shift[:, None]
        return hn, en, gate[:, None], e_gate[:, None]

    text_len = encoder.shape[1]
    hn, en, gate, e_gate = norm(blk.norm1, hidden, encoder)
    o = blk.attn(torch.cat([en, hn], dim=1), rope_cos, rope_sin)
    encoder = encoder + e_gate * o[:, :text_len]
    hidden = hidden + gate * o[:, text_len:]
    hn, en, gate, e_gate = norm(blk.norm2, hidden, encoder)
    ff = blk.ff(torch.cat([en, hn], dim=1))
    return hidden + gate * ff[:, text_len:], encoder + e_gate * ff[:, :text_len]


def _parent_wan_block(blk, x, temb6, text, img, rope_cos, rope_sin):
    """The Wan block's forward as written before the chain had a kernel."""
    mod = blk.scale_shift_table.float()[None] + temb6.float()
    shift, scale, gate, c_shift, c_scale, c_gate = (m.to(x.dtype) for m in mod.chunk(6, dim=1))
    xn = L.layer_norm(x, None, None, blk.eps) * (1 + scale) + shift
    o = blk.attn1(xn, xn, rope_cos, rope_sin)
    x = x + gate * o
    xn = blk.norm2(x)
    o = blk.attn2(xn, text, extra_kv=img)
    x = x + o
    xn = L.layer_norm(x, None, None, blk.eps) * (1 + c_scale) + c_shift
    return x + c_gate * blk.ffn(xn)


def _rope_tables(gen, s, d, identity_rows=0):
    ang = torch.rand((s, d // 2), generator=gen) * 6.28
    ang[:identity_rows] = 0.0
    return torch.cos(ang).repeat_interleave(2, -1), torch.sin(ang).repeat_interleave(2, -1)


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
def test_cogvideox_block_is_the_parent_block(dtype):
    cfg = CogVideoXTransformerConfig(num_attention_heads=2, attention_head_dim=16, time_embed_dim=24, num_layers=1)
    gen = torch.Generator().manual_seed(3)
    blk = _perturb_norms(L.init_random_(CogVideoXBlock(cfg, dtype=dtype), gen), gen)
    hidden, encoder = _rand(gen, 2, 10, 32, dtype=dtype), _rand(gen, 2, 4, 32, dtype=dtype)
    temb = _rand(gen, 2, 24, dtype=dtype)
    cos, sin = _rope_tables(gen, 14, 16, identity_rows=4)
    with torch.no_grad():
        got = blk(hidden, encoder, temb, cos, sin)
        want = _parent_cogvideox_block(blk, hidden, encoder, temb, cos, sin)
    for g, w in zip(got, want):
        _equal(g, w)


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
def test_wan_block_is_the_parent_block(dtype):
    cfg = WanTransformerConfig(num_attention_heads=2, attention_head_dim=16, num_layers=1, ffn_dim=48, text_dim=24,
                               image_dim=20)
    gen = torch.Generator().manual_seed(4)
    blk = _perturb_norms(L.init_random_(WanBlock(cfg, dtype=dtype), gen), gen)
    x, temb6 = _rand(gen, 2, 12, 32, dtype=dtype), _rand(gen, 2, 6, 32, dtype=dtype)
    text, img = _rand(gen, 2, 5, 32, dtype=dtype), _rand(gen, 2, 3, 32, dtype=dtype)
    cos, sin = _rope_tables(gen, 12, 16)
    with torch.no_grad():
        got = blk(x, temb6, text, img, cos, sin)
        want = _parent_wan_block(blk, x, temb6, text, img, cos, sin)
    _equal(got, want)


@pytest.mark.parametrize("variant", ["norm", "gate_norm", "add_norm", "gate"])
def test_autograd_wrapper_gives_the_plain_gradients(variant, monkeypatch):
    """The wrapper's autograd function, its forward standing in for the
    kernel: the gradients of every input, two streams, against autograd
    through the plain composition."""
    gen = torch.Generator().manual_seed(5)
    xs, o, gates, scales, shifts, w, bias = _streams(gen, torch.float64, 2, (3, 5), 16)
    kw = dict(norm=variant != "gate", o=None if variant == "norm" else o,
              gates=gates if variant in ("gate_norm", "gate") else None,
              scales=scales if variant in ("norm", "add_norm") else None,
              shifts=shifts if variant in ("norm", "add_norm") else None,
              weight=w if variant == "gate_norm" else None, bias=bias if variant == "gate_norm" else None)
    leaves = [t.requires_grad_() for t in (*xs, o, *gates, *scales, *shifts, w, bias)]
    launched = []
    monkeypatch.setattr(A, "_launch", lambda spec, *t: launched.append(spec) or A._plain_flat(spec, *t))

    xs_in = tuple(xs)
    spec = A._spec(xs_in, kw["o"], kw["gates"], kw["scales"], kw["shifts"], kw["weight"], kw["bias"], 1e-5,
                   kw["norm"])
    flat = A._flat(xs_in, kw["o"], kw["gates"], kw["scales"], kw["shifts"], kw["weight"], kw["bias"])
    out = A._AdaNormFunction.apply(spec, *flat)
    assert len(launched) == 1
    ref = A._outputs(spec, *A.ada_norm_plain(xs_in, eps=1e-5, **kw))  # new residuals with o, y with norm
    assert len(out) == len(ref)
    cots = [torch.randn(r.shape, generator=gen, dtype=r.dtype) for r in ref]
    used = [t for t in leaves if any(t is f for f in flat if f is not None)]
    got = torch.autograd.grad(out, used, cots, allow_unused=True)
    want = torch.autograd.grad(ref, used, cots, allow_unused=True)
    for g, r in zip(got, want):
        if r is None:
            assert g is None or not g.abs().any()
        else:
            torch.testing.assert_close(g, r, rtol=1e-12, atol=1e-12)


def test_arguments_that_make_no_sense_raise():
    x = torch.zeros(1, 2, 8)
    o, v = torch.zeros(1, 2, 8), torch.zeros(1, 1, 8)
    with pytest.raises(ValueError, match="does nothing"):
        A.ada_norm((x,), norm=False)
    with pytest.raises(ValueError, match="need a branch output"):
        A.ada_norm((x,), gates=(v,))
    with pytest.raises(ValueError, match="with shifts"):
        A.ada_norm((x,), scales=(v,))
    with pytest.raises(ValueError, match="need norm=True"):
        A.ada_norm((x,), o, scales=(v,), shifts=(v,), norm=False)
    with pytest.raises(ValueError, match="one a stream"):
        A.ada_norm((x, x), o.repeat(1, 2, 1), gates=(v,))
    with pytest.raises(ValueError, match="1 or 2 streams"):
        A.ada_norm((x, x, x))


def test_a_device_other_than_cpu_or_cuda_raises():
    x = torch.zeros(1, 2, 8, device="meta")
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        A.ada_norm((x,))


def test_kernel_checks_refuse_what_the_kernel_does_not_take():
    """The checks the wrapper makes before a launch (they read shapes,
    strides and addresses only, so they run here on CPU tensors)."""
    def check(xs, o=None, gates=None, w=None):
        A._check(xs, o, gates, None, None, w, w)

    x = torch.zeros(2, 4, 64, dtype=torch.bfloat16)
    check((x,), x, (torch.zeros(2, 1, 64, dtype=torch.bfloat16),), torch.ones(64))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        check((x.half(),))
    for d in (36, 0, 5128):
        with pytest.raises(ValueError, match="multiple of 8"):
            check((torch.zeros(2, 4, d),))
    with pytest.raises(ValueError, match="at least one row"):
        check((torch.zeros(2, 0, 64),))
    with pytest.raises(ValueError, match="unit stride"):
        check((torch.zeros(2, 64, 4).transpose(1, 2),))
    with pytest.raises(ValueError, match="unit stride"):
        check((torch.zeros(2, 4, 72)[:, :, 2:66],))  # rows that start 8 bytes past 16-byte boundaries
    with pytest.raises(ValueError, match="want shape"):
        check((x,), torch.zeros(2, 5, 64, dtype=torch.bfloat16))
    with pytest.raises(TypeError, match="want torch.bfloat16"):
        check((x,), x.float())
    with pytest.raises(ValueError, match="want a float"):
        check((x,), w=torch.ones(32))
    # o as a slice of a wider joint tensor: its rows step over the columns left out
    joint = torch.zeros(2, 4, 128, dtype=torch.bfloat16)
    check((x,), joint[:, :, 64:])


def test_the_wrapper_mirrors_the_kernel_source():
    """The ctypes structures have the C structs' sizes, and the mode bits are the source's."""
    src = (_build.SOURCE_DIR / "ada_norm.cu").read_text()
    bits = dict(re.findall(r"k(Add|Gate|Norm|Affine|Mod) = (\d+)", src))
    assert {k: int(v) for k, v in bits.items()} == {"Add": A._ADD, "Gate": A._GATE, "Norm": A._NORM,
                                                    "Affine": A._AFFINE, "Mod": A._MOD}
    assert ctypes.sizeof(A._Stream) == 5 * 8 + 10 * 8  # five pointers, ten long longs
    assert ctypes.sizeof(A._Args) == A.MAX_STREAMS * ctypes.sizeof(A._Stream) + 4 * 8 + 7 * 8 + 8  # eps padded
    assert f"kMaxStreams = {A.MAX_STREAMS};" in src and f"d <= {A.MAX_DIM}" in src
