"""The tensor-core attention kernels' surroundings on the CPU: which calls
the wrappers route to them, that the build compiles them, the plain
version of the backward arithmetic they follow in bf16, against the JAX
package, a torch model of the forward's softmax arithmetic (its denominator)
against the JAX package's forward kernel, and a numpy model of the int8
kernel's fragment layout.

The kernels themselves (``csrc/flash_attention_tc.cu``,
``csrc/flash_attention_bwd_dq_tc.cu``, ``csrc/flash_attention_bwd_tc.cu``,
``csrc/flash_attention_int8_tc.cu``) run only on the card; the on-card tests
in ``test_torch_port_gpu.py`` hold them against the plain versions.

bf16 backward against ``alg_tpu.ops.flash_attention_bwd.flash_attention_bwd``
in Pallas interpret mode: both round dS (and for dv P) to bf16 before the
products that make dq, dk and dv, so the two differ only in the order of
fp32 sums and in the rounding of the outputs to bf16. Tolerance: one bf16
step at each output's largest magnitude (atol = max|ref| · 2**-7, rtol 0)."""

import functools
import re
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from alg_tpu.ops import flash_attention as JFA
from alg_tpu.ops.flash_attention_bwd import flash_attention_bwd as jax_flash_attention_bwd

from alg_tpu_torch.ops import _build
from alg_tpu_torch.ops import flash_attention as FA
from alg_tpu_torch.ops import flash_attention_bwd as FB
from alg_tpu_torch.ops import flash_attention_int8 as I8

from test_torch_port_ops_bwd import CASES

BF16_STEP = 2.0 ** -7  # the spacing of bf16 values in [1, 2)


def _on(device, dtype, head_dim=64):
    """A stand-in for a [1, 1, 1, head_dim] tensor on ``device``: the routing reads device, dtype and head dim
    only."""
    return types.SimpleNamespace(device=torch.device(device), dtype=dtype, shape=(1, 1, 1, head_dim))


@pytest.mark.parametrize("device,dtype,prolog,want", [
    ("cpu", torch.bfloat16, False, "plain"),
    ("cpu", torch.float32, True, "plain"),
    ("cuda", torch.bfloat16, False, "wgmma"),
    ("cuda", torch.float32, False, "cuda_core"),
    ("cuda", torch.bfloat16, True, "wgmma"),
    ("cuda", torch.float32, True, "cuda_core"),
], ids=["cpu-bf16", "cpu-fp32-prolog", "cuda-bf16", "cuda-fp32", "cuda-bf16-prolog", "cuda-fp32-prolog"])
def test_forward_route(device, dtype, prolog, want):
    """Every CUDA bf16 call at D = 64 without a bias takes the Hopper kernel
    (``csrc/flash_attention_wgmma.cu``), every fp32 one the CUDA-core kernel:
    a qk prolog runs as a launch of its own ahead of the forward
    (``qk_prolog``), so a bf16 call with one rounds P to bf16 before P·V as
    the TPU kernel does."""
    assert FA.route(_on(device, dtype), prolog) == want


@pytest.mark.parametrize("has_bias", [False, True], ids=["no-bias", "bias"])
@pytest.mark.parametrize("head_dim", [64, 80, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_forward_kernel_route_table(dtype, head_dim, has_bias):
    """``kernel_route`` on what a call can observe: bf16 at D = 64 or 128
    without a bias (the CogVideoX DiTs, CLIP-L vision; the Wan DiT's self-
    and cross-attention, the HunyuanVideo DiT and refiner, Llama; the
    training and ring calls) takes ``"wgmma"``; bf16 with a bias (T5, UMT5)
    or at D = 80 (CLIP ViT-H) ``"tc"``; fp32 ``"cuda_core"`` whatever else it
    has. ``route`` agrees on a CUDA tensor with a bias."""
    want = "cuda_core" if dtype == torch.float32 else "wgmma" if head_dim in (64, 128) and not has_bias else "tc"
    assert FA.kernel_route(dtype, head_dim, has_bias) == want
    bias = torch.zeros(1) if has_bias else None
    assert FA.route(_on("cuda", dtype, head_dim), bias=bias) == want
    if want != "cuda_core":
        assert FA.KEY_TILE[want] in (64, 128)


@pytest.mark.parametrize("dtype", [torch.float16, torch.int8, torch.float64], ids=["fp16", "int8", "fp64"])
def test_forward_kernel_route_refuses_other_dtypes(dtype):
    with pytest.raises(TypeError):
        FA.kernel_route(dtype, 64, False)


@pytest.mark.parametrize("device,dtype,want", [
    ("cpu", torch.bfloat16, "plain"), ("cuda", torch.bfloat16, "tc"), ("cuda", torch.float32, "cuda_core"),
], ids=["cpu-bf16", "cuda-bf16", "cuda-fp32"])
def test_dkv_route(device, dtype, want):
    assert FB.dkv_route(_on(device, dtype)) == want


@pytest.mark.parametrize("device,dtype,want", [
    ("cpu", torch.bfloat16, "plain"), ("cuda", torch.bfloat16, "tc"), ("cuda", torch.float32, "cuda_core"),
], ids=["cpu-bf16", "cuda-bf16", "cuda-fp32"])
def test_dq_route(device, dtype, want):
    assert FB.dq_route(_on(device, dtype)) == want


@pytest.mark.parametrize("pv_int8", [False, True], ids=["qk", "full"])
@pytest.mark.parametrize("device,dtype,want", [
    ("cpu", torch.bfloat16, "plain"), ("cpu", torch.float32, "plain"), ("cuda", torch.bfloat16, "tc"),
    ("cuda", torch.float32, "tc_fp32"),
], ids=["cpu-bf16", "cpu-fp32", "cuda-bf16", "cuda-fp32"])
def test_int8_route(device, dtype, pv_int8, want):
    """int8 attention takes the tensor-core kernel in both modes and both types: bf16 through its bf16 entry
    point, fp32 through its fp32 one (Q·Kᵀ on the int8 tensor cores, "qk" P·V in exact fp32 FMAs)."""
    assert I8.route(_on(device, dtype), pv_int8) == want


@pytest.mark.parametrize("route", [lambda t: FA.route(t), lambda t: FA.route(t, True), FB.dq_route, FB.dkv_route,
                                   lambda t: I8.route(t), lambda t: I8.route(t, True)],
                         ids=["forward", "forward-prolog", "dq", "dkv", "int8-qk", "int8-full"])
def test_routes_raise_for_other_devices_and_dtypes(route):
    with pytest.raises(RuntimeError, match="no kernel for device"):
        route(_on("meta", torch.bfloat16))
    with pytest.raises(TypeError):
        route(_on("cuda", torch.float16))


def test_each_route_names_an_entry_point_of_the_sources():
    """Every C entry point the wrappers can reach is defined in a source, one per head dim; the Hopper
    forward's (``"wgmma"``) at each of its head dims, ``WGMMA_HEAD_DIMS`` (64 and 128), and no other."""
    defined = "".join(p.read_text() for p in _build._sources()[0])
    forward = {key: name for key, name in FA._ENTRY_NAMES.items() if key != "wgmma"}
    for names, macro in ((forward, "ALG_FLASH_HEAD_DIM"), (FB._ENTRY_NAMES, "ALG_FLASH_HEAD_DIM"),
                         (I8._ENTRY_NAMES, "ALG_INT8_HEAD_DIM"), ({"prolog": FA.PROLOG_ENTRY_NAME}, "ALG_QK_HEAD_DIM")):
        for name in names.values():
            stem = name.format(d="")
            assert f"ALG_CAT({stem}, {macro})" in defined, stem
    assert FA.WGMMA_HEAD_DIMS == (64, 128)
    for d in FA.HEAD_DIMS:
        wgmma = FA._ENTRY_NAMES["wgmma"].format(d=d)
        assert bool(re.search(rf'extern "C" int {wgmma}\(', defined)) == (d in FA.WGMMA_HEAD_DIMS), wgmma


def test_only_the_prolog_unit_includes_the_cuda_core_forward_body():
    """The CUDA-core forward body ``flash_attention.cuh`` and the unit of the
    in-kernel prolog over it are gone: no source includes them, the qk prolog
    is a unit of its own (``qk_prolog.cu``) that includes no attention body,
    and the fp32 forward, dq and dkv share ``flash_simt.cuh``."""
    sources = [*_build._sources()[0], *_build._sources()[1]]
    includes = {p.name: re.findall(r'^#include "([^"]+)"', p.read_text(), re.MULTILINE) for p in sources}
    retired = {"flash_attention.cuh", "flash_attention_prolog.cu"}
    assert not retired & set(includes) and not [name for name, inc in includes.items() if retired & set(inc)]
    assert includes["qk_prolog.cu"] == ["common.cuh"]
    assert "flash_simt.cuh" in includes["flash_attention.cu"]
    assert "flash_simt.cuh" in includes["flash_attention_bwd.cu"]


@pytest.mark.parametrize("src,macro,dims", [
    ("flash_attention_tc", "ALG_FLASH_HEAD_DIM", (64, 80, 128)),
    ("flash_attention_bwd_tc", "ALG_FLASH_HEAD_DIM", (64, 80, 128)),
    ("flash_attention_bwd_dq_tc", "ALG_FLASH_HEAD_DIM", (64, 80, 128)),
    ("flash_attention_int8_tc", "ALG_INT8_HEAD_DIM", I8.HEAD_DIMS),
], ids=["flash_attention_tc", "flash_attention_bwd_tc", "flash_attention_bwd_dq_tc", "flash_attention_int8_tc"])
def test_compile_units_list_the_tensor_core_units(src, macro, dims):
    units = {stem: extra for stem, _, extra in _build.compile_units()}
    for d in dims:
        assert units[f"{src}.{macro}_{d}"] == (f"-D{macro}={d}",)
    assert "mma.cuh" in {p.name for p in _build._sources()[1]}
    if macro == "ALG_INT8_HEAD_DIM":  # one int8 unit a head dim: both types' entry points in it
        assert {stem for stem in units if macro in stem} == {f"{src}.{macro}_{d}" for d in dims}


def test_cuda_core_int8_unit_has_no_bf16_instantiation():
    """The CUDA-core int8 unit (``flash_attention_int8.cu``, its products by
    ``__dp4a``) is retired: fp32 int8 attention runs on the int8 tensor cores
    too, through the fp32 entry of ``flash_attention_int8_tc.cu``. Each entry
    instantiates the kernel on its own type alone (the fp32 entry returns
    cudaErrorInvalidValue for bf16, the bf16 one for fp32), and no source
    takes a product by ``__dp4a``: the one left sums a register's four P
    codes against 0x01010101."""
    sources = [*_build._sources()[0], *_build._sources()[1]]
    assert "flash_attention_int8.cu" not in {p.name for p in sources}
    src = (_build.SOURCE_DIR / "flash_attention_int8_tc.cu").read_text()
    for stem, kind, code in (("alg_flash_attention_int8_tc_fp32_d", "float", "kFloat32"),
                             ("alg_flash_attention_int8_tc_d", "bf16", "kBFloat16")):
        assert re.search(rf"ALG_CAT\({stem}, ALG_INT8_HEAD_DIM\)\([^{{]*\{{\s*return entry<{kind}>\(alg::{code},", src)
    assert re.search(r"if \(dtype != want \|\|", src)
    dp4a = [line for p in sources for line in p.read_text().splitlines() if "__dp4a(" in line]
    assert dp4a and all("0x01010101" in line for line in dp4a), dp4a


class _InterpretPallas:
    """``jax.experimental.pallas`` as a module of the JAX package sees it, but
    with every ``pallas_call`` in interpret mode."""

    def __init__(self, real):
        self._real = real

    def __getattr__(self, name):
        return getattr(self._real, name)

    def pallas_call(self, *args, **kwargs):
        return self._real.pallas_call(*args, interpret=True, **kwargs)


def interpret_jax_flash(monkeypatch):
    """``alg_tpu``'s flash forward with its Pallas kernel in interpret mode,
    for the calling test only: the JAX function has no interpret switch, so
    its module's ``pl`` gives way to :class:`_InterpretPallas` (undone after
    the test) and the function runs without its ``jax.jit`` wrapper, whose
    cache would outlive the swap."""
    monkeypatch.setattr(JFA, "pl", _InterpretPallas(JFA.pl))
    return JFA.flash_attention.__wrapped__


@pytest.mark.parametrize("stable", [False, True], ids=["bounded", "stable"])
@pytest.mark.parametrize("d", [64, 80, 128])
def test_tc_forward_denominator_matches_the_jax_kernel(d, stable, monkeypatch):
    """The denominator the tensor-core forward takes, against ``alg_tpu``'s
    ``_fwd_kernel`` in interpret mode (``block_q`` = ``block_k`` = 128, two
    key blocks, so that the running max moves): at D = 64 and 80 that kernel
    sums the rows through a ones column appended to V, the sum of the
    bf16-rounded p; at D = 128 it sums the fp32 p. The torch model of the
    kernel's arithmetic with the denominator of its head dim is closer to the
    JAX kernel than the model with the other one: fewer outputs that differ,
    no larger max |diff|, a closer LSE (both stated on failure); and within
    one bf16 step of the outputs' largest magnitude and 1e-3 of the LSE
    (base-2 units): the two exp2s differ in the last bit, so a p on a bf16
    rounding tie may round the other way and move its row's sum by one bf16
    step of itself."""
    jax_fwd = interpret_jax_flash(monkeypatch)
    r = np.random.RandomState(d + stable)
    q, k, v = (torch.from_numpy(r.randn(1, 2, 256, d).astype(np.float32)).bfloat16().float().numpy()
               for _ in range(3))
    out, lse = jax_fwd(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), scale=d ** -0.5, stable=stable,
                       block_q=128, block_k=128, return_residuals=True)
    out, lse = np.asarray(out.astype(jnp.float32)), np.asarray(lse)
    found = {}
    for rounded_sum in (True, False):
        o, ls = FA.tensor_core_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)), d ** -0.5, stable=stable,
                                               key_tile=128, rounded_sum=rounded_sum)
        o, ls = o.bfloat16().float().numpy(), ls.numpy()
        diff = np.abs(o - out)
        found[rounded_sum] = (int((diff > 0).sum()), float(diff.max()), float(np.abs(ls - lse).max()))
    want, other = found[d % 128 != 0], found[d % 128 == 0]
    said = f"(outputs that differ, max|diff|, max|LSE diff|): this head dim's sum {want}, the other sum {other}"
    assert want[0] < other[0] and want[1] <= other[1] and want[2] < other[2], said
    assert want[1] <= BF16_STEP * np.abs(out).max() and want[2] < 1e-3, said
    # the port's plain version of the kernel's LSE, over the JAX kernel's 128-key blocks: within 1e-4 but for
    # the p on a rounding tie that its `tie` bounds
    port, tie = FA.tensor_core_lse_plain(torch.from_numpy(q), torch.from_numpy(k), d ** -0.5, stable=stable,
                                         key_tile=128)
    excess = np.abs(port.numpy() - lse) - tie.numpy() - 1e-4
    assert excess.max() <= 0, f"LSE out by {excess.max():.3e} beyond its bound"


@pytest.mark.parametrize("case", [
    dict(d=128, causal=True, kv_len=None, bias=False, stable=False),
    dict(d=128, causal=False, kv_len=(200, 77), bias=False, stable=True),
    dict(d=64, causal=True, kv_len=(256, 130), bias=False, stable=False),
    dict(d=64, causal=False, kv_len=None, bias=True, stable=True),
], ids=["d128-causal", "d128-kv_len-stable", "d64-causal-kv_len", "d64-bias-stable"])
def test_tensor_core_attention_plain_matches_the_jax_kernel(case, monkeypatch):
    """``tensor_core_attention_plain`` (P rounded to bf16 before P·V, the
    denominator of the head dim) against ``alg_tpu``'s ``_fwd_kernel`` in
    interpret mode on bf16 inputs, with the masks and the bias: within one
    bf16 step of the outputs' largest magnitude, and closer than the plain
    attention that keeps P in fp32 (both stated on failure)."""
    jax_fwd = interpret_jax_flash(monkeypatch)
    d, s = case["d"], 256
    r = np.random.RandomState(d + 3 * case["causal"])
    q, k, v = (torch.from_numpy(r.randn(2, 2, s, d).astype(np.float32)).bfloat16() for _ in range(3))
    kv_len = None if case["kv_len"] is None else torch.tensor(case["kv_len"], dtype=torch.int32)
    bias = torch.from_numpy(r.randn(1, 2, s, s).astype(np.float32)) if case["bias"] else None
    scale = d ** -0.5
    out = jax_fwd(*(jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (q, k, v)), scale=scale,
                  causal=case["causal"], kv_len=None if kv_len is None else jnp.asarray(kv_len.numpy()),
                  bias=None if bias is None else jnp.asarray(bias.numpy()), block_q=128, block_k=128,
                  stable=case["stable"])
    out = np.asarray(out.astype(jnp.float32))
    mine = FA.tensor_core_attention_plain(q, k, v, scale, bias, kv_len, case["causal"], case["stable"],
                                          key_tile=128)[0].float().numpy()
    fp32_p = FA.attention_plain(q, k, v, scale, bias, kv_len, case["causal"]).float().numpy()
    step = BF16_STEP * np.abs(out).max()
    said = (f"max|diff| against the JAX kernel: P rounded {np.abs(mine - out).max():.3e}, "
            f"P in fp32 {np.abs(fp32_p - out).max():.3e}; one bf16 step {step:.3e}")
    assert np.abs(mine - out).max() <= step, said
    assert np.abs(mine - out).max() < np.abs(fp32_p - out).max(), said


def _int8_a_operand(codes):
    """The A operand of ``mma.m16n8k32.s8`` that the int8 kernel hands over
    for a 16-row, 32-key chunk of P codes: lane ``4g + t`` holds, from its
    Q·Kᵀ accumulators, the codes of rows ``g`` and ``g + 8`` at keys
    ``8j + 2t + e`` (n8 tile j, e = 0, 1) and packs the code of (j, row
    half hf, e) into byte ``2 (j % 2) + e`` of register ``2 (j // 2) + hf``
    (``chunk_codes`` in ``csrc/flash_attention_int8_tc.cu``). Returns the
    16 x 32 matrix the instruction reads from those registers, by the PTX
    ISA's fragment layout: register r, byte i of lane 4g + t is element
    (g + 8 (r % 2), 16 (r // 2) + 4t + i)."""
    regs = np.zeros((32, 4, 4), np.int64)
    for lane in range(32):
        g, t = divmod(lane, 4)
        for j in range(4):
            for hf in range(2):
                for e in range(2):
                    regs[lane, 2 * (j // 2) + hf, 2 * (j % 2) + e] = codes[g + 8 * hf, 8 * j + 2 * t + e]
    a = np.zeros((16, 32), np.int64)
    for lane in range(32):
        g, t = divmod(lane, 4)
        for r in range(4):
            for i in range(4):
                a[g + 8 * (r % 2), 16 * (r // 2) + 4 * t + i] = regs[lane, r, i]
    return a


def _int8_b_operand(vt_chunk):
    """The B operand (32 positions x 8 channels) that ``ldmatrix`` gives the
    kernel from 8 channel rows of V's transposed codes over one 32-position
    chunk: b0 of lane 4g + t is bytes 4t..4t+3 of the chunk's first 16
    positions of channel g, b1 the same of its last 16; by the PTX layout
    byte i of b0 is element (4t + i, g) and of b1 (16 + 4t + i, g)."""
    b = np.zeros((32, 8), np.int64)
    for lane in range(32):
        g, t = divmod(lane, 4)
        for half in range(2):
            for i in range(4):
                b[16 * half + 4 * t + i, g] = vt_chunk[g, 16 * half + 4 * t + i]
    return b


@pytest.mark.parametrize("s", [64, 50, 100], ids=["s64", "s50-padded", "s100-two-tiles"])
def test_int8_pv_fragments_give_the_plain_integer_product(s):
    """The P codes as the int8 kernel packs them, against V's codes as
    ``pv_codes_for_tc`` transposes and reorders them, give through the
    m16n8k32 fragment layouts the plain int32 product P·V, chunk by chunk
    and channel tile by channel tile; keys past S are zero in V's copy. A
    wrong key order would pair a code with another key's values here."""
    rng = np.random.RandomState(3)
    d = 64
    v_int = torch.from_numpy(rng.randint(-127, 128, (1, s, d)).astype(np.int8))
    vt = I8.pv_codes_for_tc(v_int)[0].numpy().astype(np.int64)  # [D, keys]
    keys = vt.shape[1]
    assert keys == -(-s // I8.KEY_TILE) * I8.KEY_TILE and not vt[:, I8.int8_pv_key_order(keys).numpy() >= s].any()
    codes = rng.randint(0, 128, (16, keys)).astype(np.int64)
    codes[:, s:] = 0  # no key there
    want = codes[:, :s] @ v_int[0].numpy().astype(np.int64)
    got = np.zeros((16, d), np.int64)
    for c in range(keys // 32):
        a = _int8_a_operand(codes[:, 32 * c:32 * c + 32])
        for dt in range(d // 8):
            got[:, 8 * dt:8 * dt + 8] += a @ _int8_b_operand(vt[8 * dt:8 * dt + 8, 32 * c:32 * c + 32])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("d", [64, 128])
def test_int8_fp32_pv_tiles_give_the_plain_product(d):
    """A numpy model of the fp32 ``"qk"`` instantiation's P·V over one
    32-key chunk of a warp (``csrc/flash_attention_int8_tc.cu``): lane
    ``4g + t`` writes its Q·Kᵀ accumulators' p (rows ``16 mt + 8 hf + g``,
    keys ``8 j + 2 t + e``) transposed into the warp's slice at
    ``key · (R + 4) + row`` (R the warp's rows: 32 at D = 64, 16 at 128),
    each cell once and the 32 stores of a step in 32 different banks; lane
    ``(rg, cg)`` (``D / 8`` column groups) then owns rows ``8 rg..8 rg + 7``
    and columns ``4 cg..4 cg + 3`` and ``D / 2 + 4 cg..``, each output once,
    and its sums over the chunk give P·V."""
    rows = 32 if d == 64 else 16
    stride, col_groups = rows + 4, d // 8
    rng = np.random.RandomState(5)
    p, v = rng.rand(rows, 32), rng.randn(32, d)
    pw = np.full(32 * stride, np.nan)
    for mt in range(rows // 16):
        for j in range(4):
            for hf in range(2):
                for e in range(2):
                    at = [(8 * j + 2 * (lane % 4) + e) * stride + 16 * mt + 8 * hf + lane // 4 for lane in range(32)]
                    assert len({a % 32 for a in at}) == 32  # one bank a lane
                    for lane, a in enumerate(at):
                        assert np.isnan(pw[a])  # each cell once
                        pw[a] = p[16 * mt + 8 * hf + lane // 4, 8 * j + 2 * (lane % 4) + e]
    out, owners = np.zeros((rows, d)), np.zeros((rows, d), np.int64)
    for lane in range(32):
        rg, cg = divmod(lane, col_groups)
        cols = [4 * cg + c for c in range(4)] + [d // 2 + 4 * cg + c for c in range(4)]
        for i in range(8):
            for c, col in enumerate(cols):
                out[8 * rg + i, col] = sum(pw[n * stride + 8 * rg + i] * v[n, col] for n in range(32))
                owners[8 * rg + i, col] += 1
    assert (owners == 1).all()
    np.testing.assert_allclose(out, p @ v, rtol=1e-12, atol=1e-12)


def test_int8_pv_key_order_is_a_permutation_within_each_chunk():
    order = I8.int8_pv_key_order(128).numpy()
    for c in range(4):
        assert sorted(order[32 * c:32 * c + 32]) == list(range(32 * c, 32 * c + 32))
    assert list(order[:8]) == [0, 1, 8, 9, 2, 3, 10, 11]  # lane 0's codes, then lane 1's


def _bf16_inputs(case, seed=0):
    """The case's inputs drawn in fp32 from a numpy seed and rounded to bf16, as numpy fp32 holding bf16 values."""
    b, h, sq, sk, d, causal, kv_len = CASES[case]
    r = np.random.RandomState(seed)
    q, do = (r.randn(b, h, sq, d) for _ in range(2))
    k, v = (r.randn(b, h, sk, d) for _ in range(2))
    q, k, v, do = (torch.from_numpy(a.astype(np.float32)).bfloat16().float().numpy() for a in (q, k, v, do))
    return q, k, v, do, d ** -0.5, causal, None if kv_len is None else np.asarray(kv_len, np.int32)


@pytest.mark.parametrize("case", list(CASES))
def test_bf16_backward_plain_matches_jax_interpret_kernels(case):
    q, k, v, do, scale, causal, kv_len = _bf16_inputs(case)
    tq, tk, tv, tdo = (torch.from_numpy(a).bfloat16() for a in (q, k, v, do))
    tlen = None if kv_len is None else torch.from_numpy(kv_len)
    o, lse = FA.attention_plain_residuals(tq, tk, tv, scale, None, tlen, causal)
    got = FB.flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo, scale, causal, tlen)
    jlen = None if kv_len is None else jnp.asarray(kv_len)
    ref = jax_flash_attention_bwd(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, o.float().numpy())),
                                  jnp.asarray(lse.numpy()), jnp.asarray(do, jnp.bfloat16), scale=scale,
                                  causal=causal, kv_len=jlen, block_q=128, block_k=128, interpret=True)
    for g, r, name in zip(got, ref, ("dq", "dk", "dv")):
        r = np.asarray(r.astype(jnp.float32))
        assert g.dtype == torch.bfloat16 and torch.isfinite(g).all(), name
        np.testing.assert_allclose(g.float().numpy(), r, atol=BF16_STEP * np.abs(r).max(), rtol=0, err_msg=name)


def test_bf16_dkv_plain_rounds_p_and_ds():
    """The plain dkv version rounds P and dS to bf16 before its products (an
    identity in fp32): on bf16 inputs it differs from the same arithmetic
    with fp32 P and dS, and in fp32 it is that arithmetic."""
    q, k, v, do, scale, causal, kv_len = _bf16_inputs("dense-ragged", seed=1)
    t = [torch.from_numpy(a) for a in (q, k, v, do)]
    o, lse = FA.attention_plain_residuals(*t[:3], scale)
    delta = FB.row_delta(o, t[3])
    p, ds = FB._p_ds_plain(*t[:3], t[3], lse, delta, scale, False, None)
    unrounded = (torch.matmul(ds.transpose(-1, -2), t[0]) * scale, torch.matmul(p.transpose(-1, -2), t[3]))
    for got, want in zip(FB.flash_attention_bwd_dkv_plain(*t[:3], t[3], lse, delta, scale), unrounded):
        assert torch.equal(got, want)
    bf = [a.bfloat16() for a in t]
    got = FB.flash_attention_bwd_dkv_plain(*bf[:3], bf[3], lse, delta, scale)
    assert any(not torch.equal(g, w.bfloat16()) for g, w in zip(got, unrounded))


def test_bf16_dq_plain_rounds_ds():
    """The plain dq version rounds dS to bf16 before its product with k (an
    identity in fp32): in fp32 it is the unrounded arithmetic exactly, on
    bf16 inputs it differs from it."""
    q, k, v, do, scale, causal, kv_len = _bf16_inputs("dense-ragged", seed=1)
    t = [torch.from_numpy(a) for a in (q, k, v, do)]
    o, lse = FA.attention_plain_residuals(*t[:3], scale)
    delta = FB.row_delta(o, t[3])
    _, ds = FB._p_ds_plain(*t[:3], t[3], lse, delta, scale, False, None)
    unrounded = torch.matmul(ds, t[1]) * scale
    assert torch.equal(FB.flash_attention_bwd_dq_plain(*t[:3], t[3], lse, delta, scale), unrounded)
    bf = [a.bfloat16() for a in t]
    got = FB.flash_attention_bwd_dq_plain(*bf[:3], bf[3], lse, delta, scale)
    assert got.dtype == torch.bfloat16 and not torch.equal(got, unrounded.bfloat16())


@pytest.mark.parametrize("case", list(CASES))
def test_bf16_dq_plain_is_closer_to_jax_than_fp32_ds(case):
    """The fault the rounding repairs: on bf16 inputs ``alg_tpu``'s
    ``_dq_kernel`` (interpret mode) rounds dS to bf16 before dS·k. The plain
    dq, which now does too, is closer to it than the same arithmetic with
    dS kept in fp32 (the port's dq before): a smaller mean |diff| and no
    larger max |diff|, both stated on failure."""
    q, k, v, do, scale, causal, kv_len = _bf16_inputs(case)
    tq, tk, tv, tdo = (torch.from_numpy(a).bfloat16() for a in (q, k, v, do))
    tlen = None if kv_len is None else torch.from_numpy(kv_len)
    o, lse = FA.attention_plain_residuals(tq, tk, tv, scale, None, tlen, causal)
    delta = FB.row_delta(o, tdo)
    got = FB.flash_attention_bwd_dq_plain(tq, tk, tv, tdo, lse, delta, scale, causal, tlen).float().numpy()
    _, ds = FB._p_ds_plain(tq, tk, tv, tdo, lse, delta, scale, causal, tlen)
    fp32_ds = (torch.matmul(ds, tk.float()) * scale).bfloat16().float().numpy()
    jlen = None if kv_len is None else jnp.asarray(kv_len)
    ref = jax_flash_attention_bwd(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, o.float().numpy())),
                                  jnp.asarray(lse.numpy()), jnp.asarray(do, jnp.bfloat16), scale=scale,
                                  causal=causal, kv_len=jlen, block_q=128, block_k=128, interpret=True)[0]
    ref = np.asarray(ref.astype(jnp.float32))
    new, old = np.abs(got - ref), np.abs(fp32_ds - ref)
    said = (f"rounded dS: max|diff| {new.max():.3e}, mean {new.mean():.3e}; "
            f"fp32 dS: max|diff| {old.max():.3e}, mean {old.mean():.3e}")
    assert new.mean() < old.mean() and new.max() <= old.max(), said
