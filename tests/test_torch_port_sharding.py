"""The port's multi-device layer on the CPU: the mesh, Megatron tensor
parallelism in the three DiTs and the sequence-parallel attention (gather,
ring, Ulysses), each over gloo ranks (``torch_dist_workers.spawn``) held
against ``alg_tpu``'s sharded counterpart on ``conftest.py``'s virtual CPU
devices, on the same numpy weights and inputs, with ``alg_tpu``'s
tolerances: 2e-5 for DiT outputs, 1e-5 for sequence-parallel attention."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_dist_workers as W
from torch_port_common import one_thread, port_cfg, random_tree  # noqa: F401


def _cpus(n):
    return jax.local_devices(backend="cpu")[:n]


@pytest.fixture
def xla_attention():
    from alg_tpu.ops.attention import set_attention_impl

    set_attention_impl("xla")
    yield
    set_attention_impl(None)


def _jax_sharded(fn, params, specs, dims, data_args=(), seq_mode=None, pp_micro=None):
    """``fn(params, *data_args)`` jitted with ``params`` placed by ``specs``
    (staged over pp when ``pp_micro`` is given) and ``data_args`` over dp on
    a ``dims`` = (dp, pp, sp, tp) mesh of CPU devices; with ``seq_mode`` the
    attention runs sequence-parallel over sp."""
    import contextlib

    from alg_tpu.ops.attention import attention_mesh_scope
    from alg_tpu.sharding import make_mesh
    from alg_tpu.sharding.partition import add_pp
    from alg_tpu.sharding.pipeline import pipeline_blocks

    dp, pp, sp, tp = dims
    mesh = make_mesh(dp=dp, pp=pp, sp=sp, tp=tp, devices=_cpus(dp * pp * sp * tp))
    if pp_micro is not None:
        specs = add_pp(specs)
    p = jax.tree.map(lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), params, specs)
    data = [jax.device_put(jnp.asarray(a), NamedSharding(mesh, P("dp"))) for a in data_args]
    scope = attention_mesh_scope(mesh, seq_axis="sp", seq_mode=seq_mode) if seq_mode else contextlib.nullcontext()
    pipe = pipeline_blocks(mesh, n_micro=pp_micro) if pp_micro else contextlib.nullcontext()
    with mesh, scope, pipe:
        return np.asarray(jax.jit(fn)(p, *data))


def _assemble(results, dims, which=1):
    """The whole batch from the ranks' dp rows (every rank of a dp group must agree)."""
    by_dp = {}
    for res in results:
        coords, out = res[0], res[which]
        d = coords["dp"]
        if d in by_dp:
            np.testing.assert_array_equal(by_dp[d], out)
        by_dp[d] = out
    return np.concatenate([by_dp[d] for d in range(dims[0])])


def test_mesh_layout_groups_and_world_checks(tmp_path):
    """(dp, pp, sp, tp) order over the ranks, a line of ranks per axis, the
    tp fill-in, and a mesh larger than the world raising with torchrun in
    its message."""
    res = W.spawn(W.mesh_layout, 4, tmp_path, (2, 1, 1, 2))
    assert [r["coords"] for r in res] == [{"dp": d, "pp": 0, "sp": 0, "tp": t} for d in (0, 1) for t in (0, 1)]
    assert res[1]["groups"] == {"dp": [1, 3], "pp": [1], "sp": [1], "tp": [0, 1]}
    assert res[2]["model"] == [2, 3]
    assert res[0]["tp_fill"] == res[0]["cpu_mesh"] == {"dp": 2, "pp": 1, "sp": 1, "tp": 2}
    assert "torchrun --nproc_per_node 8" in res[0]["too_big"]


def _case(family, layers=2, text_len=5):
    """(port config, numpy tree, port keyword inputs, the port's batch keys,
    JAX forward ``fn(params, *batch)``, JAX specs function, JAX batch
    arrays) for a tiny DiT of ``family``."""
    rng = np.random.RandomState(0)
    if family == "cogvideox":
        from alg_tpu.models.cogvideox import (CogVideoXTransformerConfig, cogvideox_rope, cogvideox_transformer,
                                              init_cogvideox_transformer)
        from alg_tpu.sharding import cogvideox_transformer_specs as specs

        from alg_tpu_torch.models.cogvideox import transformer as T

        cfg = CogVideoXTransformerConfig(num_attention_heads=4, attention_head_dim=16, in_channels=8,
                                         out_channels=4, time_embed_dim=16, text_embed_dim=12, num_layers=layers,
                                         sample_height=8, sample_width=8, max_text_seq_length=text_len)
        tree = random_tree(lambda k: init_cogvideox_transformer(k, cfg), 1)
        cos, sin = cogvideox_rope(cfg, 32, 32, 2)
        x, txt = rng.randn(2, 2, 8, 4, 4).astype(np.float32), rng.randn(2, text_len, 12).astype(np.float32)
        ts = np.array([700.0, 300.0], np.float32)
        inputs = dict(hidden_states=x, encoder_hidden_states=txt, timestep=ts, rope_cos=cos, rope_sin=sin)
        fwd = lambda p, x, t, ts: cogvideox_transformer(p, cfg, x, t, ts, cos, sin)  # noqa: E731
        return (port_cfg(T.CogVideoXTransformerConfig, cfg), tree, inputs,
                ("hidden_states", "encoder_hidden_states", "timestep"), fwd, specs, (x, txt, ts))
    if family == "wan":
        from alg_tpu.models.wan import WanTransformerConfig, init_wan_transformer, wan_rope, wan_transformer
        from alg_tpu.sharding import wan_transformer_specs as specs

        from alg_tpu_torch.models.wan import transformer as WT

        cfg = WanTransformerConfig(num_attention_heads=4, attention_head_dim=12, in_channels=9, out_channels=4,
                                   num_layers=layers, ffn_dim=32, freq_dim=16, text_dim=8, image_dim=10)
        tree = random_tree(lambda k: init_wan_transformer(k, cfg), 2)
        cos, sin = wan_rope(cfg, 2, 4, 4)
        x, txt = rng.randn(2, 9, 2, 4, 4).astype(np.float32), rng.randn(2, text_len, 8).astype(np.float32)
        img, ts = rng.randn(2, 5, 10).astype(np.float32), np.array([500.0, 900.0], np.float32)
        inputs = dict(hidden_states=x, timestep=ts, encoder_hidden_states=txt, encoder_hidden_states_image=img,
                      rope_cos=cos, rope_sin=sin)
        fwd = lambda p, x, t, tx, im: wan_transformer(p, cfg, x, t, tx, im, cos, sin)  # noqa: E731
        return (port_cfg(WT.WanTransformerConfig, cfg), tree, inputs,
                ("hidden_states", "timestep", "encoder_hidden_states", "encoder_hidden_states_image"), fwd, specs,
                (x, ts, txt, img))
    from alg_tpu.models.hunyuan import (HunyuanVideoTransformerConfig, hunyuan_rope, hunyuan_transformer,
                                        init_hunyuan_transformer)
    from alg_tpu.sharding import hunyuan_transformer_specs as specs

    from alg_tpu_torch.models.hunyuan import transformer as HT

    cfg = HunyuanVideoTransformerConfig(in_channels=4, out_channels=4, num_attention_heads=4, attention_head_dim=8,
                                        num_layers=layers, num_single_layers=layers, num_refiner_layers=1,
                                        mlp_ratio=2.0, text_embed_dim=12, pooled_projection_dim=6,
                                        rope_axes_dim=(2, 4, 2))
    tree = random_tree(lambda k: init_hunyuan_transformer(k, cfg), 3)
    cos, sin = hunyuan_rope(cfg, 3, 4, 4)
    x, txt = rng.randn(2, 4, 3, 4, 4).astype(np.float32), rng.randn(2, text_len, 12).astype(np.float32)
    mask = np.ones((2, text_len), np.int32)
    mask[0, 3:] = 0  # 15 keys of row 0's 20 at text_len 8: its last chunk at sp = 4 lies wholly past them
    pooled, ts = rng.randn(2, 6).astype(np.float32), np.array([500.0, 900.0], np.float32)
    guidance = np.array([6000.0, 6000.0], np.float32)
    inputs = dict(hidden_states=x, timestep=ts, encoder_hidden_states=txt, encoder_attention_mask=mask,
                  pooled_projections=pooled, guidance=guidance, rope_cos=cos, rope_sin=sin)
    fwd = lambda p, x, t, e, m, pl, g: hunyuan_transformer(p, cfg, x, t, e, m, pl, guidance=g,  # noqa: E731
                                                          rope_cos=cos, rope_sin=sin)
    return (port_cfg(HT.HunyuanVideoTransformerConfig, cfg), tree, inputs,
            ("hidden_states", "timestep", "encoder_hidden_states", "encoder_attention_mask", "pooled_projections",
             "guidance"), fwd, specs, (x, ts, txt, mask, pooled, guidance))


# against alg_tpu: its 2e-5, but the port's own whole-forward tolerance for
# HunyuanVideo (tests/test_torch_port_hunyuan_models.py, FWD_ATOL), where the
# unsharded port and alg_tpu already differ by up to 6e-5 on these weights
FWD_ATOL = {"cogvideox": 2e-5, "wan": 2e-5, "hunyuan": 1e-4}

# (family, (dp, pp, sp, tp), sp mode, GPipe microbatches, DiT layers, text length)
LAYOUTS = [
    ("cogvideox", (2, 1, 1, 2), None, None, 2, 5),
    ("wan", (2, 1, 1, 2), None, None, 2, 7),
    ("hunyuan", (2, 1, 1, 2), None, None, 1, 7),
    ("hunyuan", (1, 1, 1, 4), None, None, 1, 7),
    ("cogvideox", (1, 1, 2, 2), "ring", None, 2, 4),
    ("wan", (1, 1, 2, 2), "ulysses", None, 2, 7),
    ("hunyuan", (1, 1, 4, 1), "ring", None, 1, 8),
    ("cogvideox", (1, 2, 1, 2), None, 2, 4, 5),
    ("wan", (1, 2, 1, 2), None, 2, 4, 7),
    ("hunyuan", (1, 2, 1, 1), None, 2, 2, 7),
]


@pytest.mark.parametrize("family,dims,seq_mode,pp_micro,layers,text_len", LAYOUTS,
                         ids=[f"{f}-dp{d[0]}pp{d[1]}sp{d[2]}tp{d[3]}{'-' + m if m else ''}"
                              for f, d, m, *_ in LAYOUTS])
def test_sharded_dit_matches_alg_tpu(tmp_path, xla_attention, family, dims, seq_mode, pp_micro, layers, text_len):
    """A DiT forward over gloo ranks against ``alg_tpu``'s over the same
    layout: tensor parallelism (Wan's tp RMS norm, Hunyuan's segmented
    ``proj_out``), sequence-parallel attention inside the DiT (Hunyuan's
    joint sequence of 20 tokens at sp = 4 has key chunks wholly past the
    padded prompt's ``kv_len``), and GPipe over pp with 2 microbatches;
    also within 2e-5 of the port's unsharded forward."""
    tcfg, tree, inputs, batch_keys, fwd, specs, batch = _case(family, layers, text_len)
    kind = {"cogvideox": "dit", "wan": "wan_dit", "hunyuan": "hunyuan_dit"}[family]
    ranks = W.Ranks(W.dit_forward, int(np.prod(dims)), tmp_path, kind, tcfg, tree, inputs, dims,
                    seq_mode or "gather", pp_micro, None, batch_keys)
    params = jax.tree.map(jnp.asarray, tree)
    ref = _jax_sharded(fwd, params, specs(params), dims, batch, seq_mode=seq_mode, pp_micro=pp_micro)
    res = ranks.results()
    out = _assemble(res, dims)
    np.testing.assert_allclose(out, _assemble(res, dims, which=2), atol=2e-5)  # against the port unsharded
    np.testing.assert_allclose(out, ref, atol=FWD_ATOL[family])


def test_tp_w4_dit_matches_unsharded_w4_and_misalignment_raises(tmp_path, xla_attention):
    """W4A8 linears shard: column-parallel codes and both scale trees on
    their rows, row-parallel along whole 128-element groups (dim 512: the
    attention output's 128-groups over tp = 4). On ``alg_tpu``'s quantized
    tree, the port's forward at tp = 4 against ``alg_tpu``'s at tp = 4, and
    against the port's unsharded W4A8 forward (``alg_tpu``'s own test holds
    its sharded forward to its unsharded one), both within 2e-5. At dim 128
    the row-parallel split would cut a group and raises."""
    from alg_tpu.models.cogvideox import (CogVideoXTransformerConfig, cogvideox_rope, cogvideox_transformer,
                                          init_cogvideox_transformer)
    from alg_tpu.ops.quant import quantize_transformer_params
    from alg_tpu.sharding import cogvideox_transformer_specs

    from alg_tpu_torch.models.cogvideox import transformer as T

    def case(head_dim):
        cfg = CogVideoXTransformerConfig(num_attention_heads=4, attention_head_dim=head_dim, in_channels=8,
                                         out_channels=4, time_embed_dim=16, text_embed_dim=12, num_layers=2,
                                         sample_height=8, sample_width=8, max_text_seq_length=5)
        return cfg, random_tree(lambda k: init_cogvideox_transformer(k, cfg), 4)

    jcfg, tree = case(128)
    qtree = jax.tree.map(np.asarray, quantize_transformer_params(jax.tree.map(jnp.asarray, tree), mode="w4"))
    assert "kernel_q4" in qtree["blocks"]["attn"]["to_out"]
    cos, sin = cogvideox_rope(jcfg, 32, 32, 2)
    rng = np.random.RandomState(2)
    x, txt = rng.randn(2, 2, 8, 4, 4).astype(np.float32), rng.randn(2, 5, 12).astype(np.float32)
    ts = np.array([700.0, 700.0], np.float32)
    inputs = dict(hidden_states=x, encoder_hidden_states=txt, timestep=ts, rope_cos=cos, rope_sin=sin)
    mis_cfg, mis_tree = case(32)
    ranks = W.Ranks(W.w4_forward, 4, tmp_path, port_cfg(T.CogVideoXTransformerConfig, jcfg), qtree, inputs,
                    (port_cfg(T.CogVideoXTransformerConfig, mis_cfg), mis_tree))
    qp = jax.tree.map(jnp.asarray, qtree)
    fwd = lambda p, x, t, ts: cogvideox_transformer(p, jcfg, x, t, ts, cos, sin)  # noqa: E731
    ref = _jax_sharded(fwd, qp, cogvideox_transformer_specs(qp), (1, 1, 1, 4), (x, txt, ts))
    for coords, out, unsharded, refused in ranks.results():
        np.testing.assert_allclose(out, ref, atol=2e-5)
        np.testing.assert_allclose(out, unsharded, atol=2e-5)
        assert "W4A8 row-parallel linear with in dim 128 cannot shard over tp=4" in refused


ATT_LAYOUTS = [("gather", (2, 1, 2, 1)), ("ring", (1, 1, 4, 1)), ("ring", (2, 1, 2, 1)), ("ulysses", (1, 1, 2, 2)),
               ("ulysses", (1, 1, 4, 1))]


@pytest.mark.parametrize("seq_mode,dims", ATT_LAYOUTS,
                         ids=[f"{m}-dp{d[0]}sp{d[2]}tp{d[3]}" for m, d in ATT_LAYOUTS])
def test_sp_attention_matches_alg_tpu(tmp_path, xla_attention, seq_mode, dims):
    """Sequence-parallel attention over gloo ranks (each with its dp rows
    and tp heads) against ``alg_tpu``'s shard_map'd attention over the same
    layout, atol 1e-5: dense; ``kv_len`` [20, 64] (at sp = 4 two of row 0's
    16-key chunks lie wholly past it); cross-attention (queries split only);
    a sequence of 63 that sp does not divide (warns, runs
    sequence-replicated); Ulysses over 2 heads at sp = 4 (warns, gathers);
    causal (raises)."""
    from alg_tpu.ops.attention import attention, attention_mesh_scope
    from alg_tpu.sharding import make_mesh

    rng = np.random.RandomState(0)
    q, k, v = (rng.randn(2, 4, 64, 16).astype(np.float32) for _ in range(3))
    kv = rng.randn(2, 4, 7, 16).astype(np.float32)
    kv_len = np.array([20, 64], np.int32)
    cases = [("dense", {}, None), ("kv_len", {"kv_len": kv_len}, None), ("cross", {"k": kv, "v": kv}, None),
             ("odd", {"q": q[:, :, :63], "k": k[:, :, :63], "v": v[:, :, :63]}, "not divisible by sp"),
             ("causal", {"causal": True}, "non-causal only")]
    if seq_mode == "ulysses" and dims[2] == 4:
        cases.append(("two_heads", {"q": q[:, :2], "k": k[:, :2], "v": v[:, :2]}, "falling back to gathered-KV"))
    dp, pp, sp, tp = dims
    ranks = W.Ranks(W.attention_calls, dp * sp * tp, tmp_path, q, k, v, dims, seq_mode, cases)
    mesh = make_mesh(dp=dp, sp=sp, tp=tp, devices=_cpus(dp * sp * tp))
    refs = {}
    for name, kw, expect in cases:
        if name == "causal":
            continue
        kw = dict(kw)
        qkv = [jnp.asarray(kw.pop(n, d)) for n, d in (("q", q), ("k", k), ("v", v))]
        kvl = None if "kv_len" not in kw else jnp.asarray(kw["kv_len"])
        with mesh, attention_mesh_scope(mesh, seq_axis="sp", seq_mode=seq_mode):
            refs[name] = np.asarray(jax.jit(lambda q_, k_, v_, n: attention(q_, k_, v_, kv_len=n))(*qkv, kvl))
    res = ranks.results()
    for name, _, expect in cases:
        msgs = [r[1][name + ":warnings"] for r in res]
        if name == "causal":
            assert all("non-causal only" in r[1]["causal"] for r in res)
            continue
        if expect is not None:
            assert all(any(expect in m for m in ms) for ms in msgs), (name, msgs)
        by = {}
        for coords, out in res:
            by.setdefault(coords["dp"], {})[coords["tp"]] = out[name]
        out = np.concatenate([np.concatenate([by[d][t] for t in range(tp)], axis=1) for d in range(dp)])
        np.testing.assert_allclose(out, refs[name], atol=1e-5, err_msg=name)
        assert np.isfinite(out).all()


class _StubMesh:
    """Stage 0 of a two-stage pp mesh, for the checks that run before any exchange."""

    def size(self, axis):
        return 2 if axis == "pp" else 1

    def local_rank(self, axis):
        return 0

    def group(self, axis):
        return None

    def group_ranks(self, axis):
        return [0, 1] if axis == "pp" else [0]


def test_pp_validation_errors():
    """``alg_tpu``'s messages (``tests/test_pipeline_parallel.py``): layers
    that pp does not divide, a batch that the microbatches do not divide,
    carry and context that disagree on the batch; and a model staged for
    another layout."""
    import torch
    from torch import nn

    from alg_tpu_torch.sharding.partition import RemoteBlock
    from alg_tpu_torch.sharding.pipeline import pipeline_blocks, run_blocks

    with pipeline_blocks(_StubMesh()):
        with pytest.raises(ValueError, match="not divisible by pp"):
            run_blocks([nn.Identity()] * 3, (torch.zeros(2, 4),))
        with pytest.raises(ValueError, match="not divisible by n_micro"):
            run_blocks([nn.Identity()] * 2, (torch.zeros(3, 4),))
        with pytest.raises(ValueError, match="disagree on batch axis"):
            run_blocks([nn.Identity()] * 2, (torch.zeros(2, 4),), (torch.zeros(4, 1),))
        with pytest.raises(ValueError, match="another pipeline layout"):
            run_blocks([RemoteBlock(), nn.Identity()], (torch.zeros(2, 4),))


def test_shard_batch_and_prefetch_take_this_ranks_dp_rows():
    """``shard_batch`` and ``prefetch(mesh=)`` keep dp rank r's contiguous
    rows; a batch that dp does not divide raises."""
    from alg_tpu_torch.training.data import prefetch
    from alg_tpu_torch.training.train import shard_batch

    class Dp2:
        def size(self, axis):
            return 2 if axis == "dp" else 1

        def local_rank(self, axis):
            return 1 if axis == "dp" else 0

    batch = {"latents": np.arange(8, dtype=np.float32).reshape(4, 2)}
    np.testing.assert_array_equal(shard_batch(batch, Dp2())["latents"], batch["latents"][2:])
    got = list(prefetch(iter([batch]), 1, "cpu", mesh=Dp2()))
    np.testing.assert_array_equal(got[0]["latents"].numpy(), batch["latents"][2:])
    with pytest.raises(ValueError, match="not divisible by dp=2"):
        shard_batch({"x": np.zeros((3, 1))}, Dp2())
