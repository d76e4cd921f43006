"""The port's training state on the CPU: checkpoint and bit-exact resume,
EMA, parameter files, the latent dataset and prefetch, and the optimizer
against optax on plain arrays (the counterparts of
``tests/test_train_checkpoint.py``)."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from alg_tpu.models.cogvideox import init_cogvideox_transformer
from alg_tpu.training.data import LatentDataset as JaxLatentDataset

from alg_tpu_torch.models.cogvideox.transformer import cogvideox_rope
from alg_tpu_torch.training import checkpoint as C
from alg_tpu_torch.training import data as D
from alg_tpu_torch.training import lora as TL
from alg_tpu_torch.training import losses as TLoss
from alg_tpu_torch.training import train as TT

from torch_port_common import one_thread, port_module, random_tree, tiny_configs


def _setup(accum=1, **tc):
    tcfg, _, _ = tiny_configs()
    model = port_module("dit", tcfg, random_tree(lambda k: init_cogvideox_transformer(k, tcfg), 1))
    cos, sin = cogvideox_rope(model.cfg, 64, 64, 2)
    base = {n: p.detach() for n, p in model.named_parameters()}
    loss = TL.make_lora_loss(TLoss.make_cogvideox_vpred_loss(model, rope_cos=cos, rope_sin=sin), base, attach=True)
    step, opt = TT.make_train_step(loss, TT.TrainConfig(learning_rate=1e-2, weight_decay=0.01, accum_steps=accum, **tc))

    def fresh():
        loras = TL.init_lora_params(torch.Generator().manual_seed(1), base, rank=2, prefixes=("blocks",))
        return TT.tree_map(lambda t: (t + 0.02).requires_grad_(), loras)

    return step, opt, fresh


def _batch(seed, b=2):
    rng = np.random.RandomState(seed)
    return {"latents": torch.from_numpy(rng.randn(b, 2, 4, 8, 8).astype(np.float32)),
            "image_latents": torch.from_numpy(rng.randn(b, 2, 4, 8, 8).astype(np.float32)),
            "encoder_hidden_states": torch.from_numpy(rng.randn(b, 3, 12).astype(np.float32))}


@pytest.mark.parametrize("with_ema", [False, True], ids=["plain", "ema"])
def test_resume_is_bit_exact(tmp_path, with_ema):
    """4 straight steps == 2 steps, save, load, 2 steps (generator state by step index)."""
    step, opt, fresh = _setup()
    ema_fn = C.make_ema_update(0.9)

    def run(p, o, ema, steps):
        for i in steps:
            p, o, _ = step(p, o, _batch(i), torch.Generator().manual_seed(100 + i))
            if ema is not None:
                ema = ema_fn(ema, p)
        return p, o, ema

    p = fresh()
    p, o, e = run(p, opt.init(p), C.init_ema(p) if with_ema else None, range(4))

    q = fresh()
    q, r, f = run(q, opt.init(q), C.init_ema(q) if with_ema else None, range(2))
    path = str(tmp_path / "ck.npz")
    C.save_train_state(path, 2, q, r, ema=f)
    like = fresh()
    s, q2, r2, f2 = C.load_train_state(path, like, opt.init(like), ema_like=C.init_ema(like))
    assert s == 2 and (f2 is None) == (not with_ema) and int(r2["count"]) == 2
    assert all(t.requires_grad for t in TT.tree_leaves(q2))
    q2, r2, f2 = run(q2, r2, f2, range(2, 4))
    for a, b in zip(TT.tree_leaves(p) + TT.tree_leaves(o), TT.tree_leaves(q2) + TT.tree_leaves(r2)):
        assert torch.equal(a, b)
    if with_ema:
        assert all(torch.equal(a, b) for a, b in zip(TT.tree_leaves(e), TT.tree_leaves(f2)))
        with pytest.raises(ValueError, match="EMA"):
            C.load_train_state(path, like, opt.init(like))


def test_ema_matches_manual_formula():
    step, opt, fresh = _setup()
    p = fresh()
    o, ema, ema_fn = opt.init(p), C.init_ema(p), C.make_ema_update(0.9)
    assert all(e.dtype == torch.float32 and e.data_ptr() != x.data_ptr() and not e.requires_grad
               for e, x in zip(TT.tree_leaves(ema), TT.tree_leaves(p)))
    manual = [x.detach().numpy().astype(np.float64) for x in TT.tree_leaves(p)]
    for i in range(3):
        p, o, _ = step(p, o, _batch(i), torch.Generator().manual_seed(i))
        ema = ema_fn(ema, p)
        manual = [m * 0.9 + x.detach().numpy().astype(np.float64) * 0.1 for m, x in zip(manual, TT.tree_leaves(p))]
    for e, m in zip(TT.tree_leaves(ema), manual):
        np.testing.assert_allclose(e.numpy(), m, atol=1e-6)


def test_shape_mismatch_and_latest_and_prune(tmp_path):
    d = str(tmp_path)
    tree = {"w": torch.ones(2)}
    for s in (100, 300, 200):
        C.save_train_state(C.checkpoint_path(d, s), s, tree, {})
    assert C.latest_checkpoint(d).endswith("step_00000300.npz")
    C.prune_checkpoints(d, keep=2)
    assert sorted(os.listdir(d)) == ["step_00000200.npz", "step_00000300.npz"]
    assert C.latest_checkpoint(str(tmp_path / "missing")) is None
    with pytest.raises(ValueError, match="shape"):
        C.load_train_state(C.checkpoint_path(d, 300), {"w": torch.ones(3)}, {})


def test_save_load_params_npz_roundtrip(tmp_path):
    tree = {"blocks/attn/to_q": {"A": torch.randn(2, 4, 3), "B": torch.randn(2, 3, 4).bfloat16()},
            "scalar": torch.tensor(3, dtype=torch.int32)}
    path = str(tmp_path / "p.npz")
    TT.save_params_npz(path, tree)
    with np.load(path) as z:
        assert sorted(z.files) == ["blocks/attn/to_q/A", "blocks/attn/to_q/B", "scalar"]
    like = TT.tree_map(torch.zeros_like, tree)
    like["blocks/attn/to_q"]["A"].requires_grad_()
    got = TT.load_params_npz(path, like)
    for a, b in zip(TT.tree_leaves(got), TT.tree_leaves(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert got["blocks/attn/to_q"]["A"].requires_grad and not got["blocks/attn/to_q"]["B"].requires_grad
    with pytest.raises(ValueError, match="unconsumed"):
        TT.load_params_npz(path, {"scalar": like["scalar"]})


def test_dataset_prefetch_and_resume_order(tmp_path):
    rng = np.random.RandomState(3)
    for i in range(5):
        np.savez(tmp_path / f"ex{i}.npz", latents=rng.randn(2, 4, 4, 4).astype(np.float32),
                 encoder_hidden_states=rng.randn(3, 6).astype(np.float32))
    ds = D.LatentDataset(str(tmp_path))
    assert len(ds) == 5
    full = list(ds.batches(2, steps=6, seed=11))
    resumed = list(ds.batches(2, steps=6, seed=11, start=4))
    assert len(full) == 6 and len(resumed) == 2
    for a, b, c in zip(full[4:], resumed, list(JaxLatentDataset(str(tmp_path)).batches(2, steps=6, seed=11))[4:]):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
            np.testing.assert_array_equal(a[k], c[k])  # the same order as the JAX package's dataset
    fetched = list(D.prefetch(ds.batches(2, steps=6, seed=11), depth=2, device="cpu"))
    assert len(fetched) == 6
    for a, b in zip(full, fetched):
        for k in a:
            assert isinstance(b[k], torch.Tensor)
            np.testing.assert_array_equal(a[k], b[k].numpy())

    def boom():
        yield {"latents": np.zeros((1,), np.float32)}
        raise RuntimeError("reader died")

    it = D.prefetch(boom(), depth=1, device="cpu")
    next(it)
    with pytest.raises(RuntimeError, match="reader died"):
        list(it)
    with pytest.raises(FileNotFoundError):
        D.LatentDataset(str(tmp_path / "empty"))


@pytest.mark.parametrize("clip", [0.0, 0.5, 1e6], ids=["no-clip", "clip-binds", "clip-idle"])
def test_optimizer_matches_optax_on_plain_arrays(clip):
    """Five updates of clip + AdamW on a small tree against
    ``optax.chain(clip_by_global_norm, adamw)``: updates rtol 1e-5."""
    tc = dict(learning_rate=3e-3, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1, grad_clip=clip)
    rng = np.random.RandomState(0)
    params = {"a": rng.randn(3, 4).astype(np.float32), "b": {"c": rng.randn(5).astype(np.float32)}}
    txs = ([optax.clip_by_global_norm(clip)] if clip > 0 else []) + [optax.adamw(
        tc["learning_rate"], b1=tc["b1"], b2=tc["b2"], eps=tc["eps"], weight_decay=tc["weight_decay"])]
    jopt = optax.chain(*txs)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jopt.init(jp)
    opt = TT.make_optimizer(TT.TrainConfig(**tc))
    tp = TT.tree_map(torch.from_numpy, params)
    state = opt.init(tp)
    for i in range(5):
        grads = {"a": rng.randn(3, 4).astype(np.float32), "b": {"c": rng.randn(5).astype(np.float32)}}
        ju, jstate = jopt.update(jax.tree.map(jnp.asarray, grads), jstate, jp)
        jp = optax.apply_updates(jp, ju)
        tu, state = opt.update(TT.tree_map(torch.from_numpy, grads), state, tp)
        tp = TT.tree_map(torch.add, tp, tu)
        for a, b in zip(TT.tree_leaves(tu), jax.tree.leaves(ju)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-9)
    assert int(state["count"]) == 5
    for a, b in zip(TT.tree_leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)


def test_tree_helpers_keep_structure_and_order():
    tree = {"b": {"y": torch.tensor(1.0), "x": torch.tensor(2.0)}, "a": torch.tensor(3.0)}
    assert [float(t) for t in TT.tree_leaves(tree)] == [3.0, 2.0, 1.0]
    assert [k for k, _ in TT.tree_leaves_with_path(tree)] == ["a", "b/x", "b/y"]
    doubled = TT.tree_map(lambda t: t * 2, tree)
    assert list(doubled) == ["b", "a"] and float(doubled["b"]["y"]) == 2.0
    assert float(TT.global_norm(tree)) == pytest.approx(14 ** 0.5)
