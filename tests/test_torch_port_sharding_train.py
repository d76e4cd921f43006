"""The port's mesh-sharded full fine-tune step on the CPU: dp2·tp2 and
pp2·tp2 over gloo ranks (``torch_dist_workers.spawn``) against ``alg_tpu``'s
``make_sharded_train_step`` over the same layout on ``conftest.py``'s
virtual CPU devices, on the same weights, batch and draws, one step and
two, with ``alg_tpu``'s tolerances (``tests/test_pipeline_parallel.py``):
the first loss within rtol 1e-5, the second within 1e-4, the parameters
within 5e-5; and ``train_cli`` with the mesh flags."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_dist_workers as W
from torch_port_common import one_thread, port_cfg, random_tree  # noqa: F401


def _cog_draws(key, shape):
    """The draws ``alg_tpu``'s v-prediction loss takes from ``key``."""
    kt, kn = jax.random.split(key)
    return {"t": np.asarray(jax.random.randint(kt, (shape[0],), 0, 1000)).astype(np.int64),
            "noise": np.asarray(jax.random.normal(kn, shape, jnp.float32))}


@pytest.mark.parametrize("flags", [["--dp", "2"], ["--tp", "2"], ["--pp", "2", "--pp_micro", "2"]],
                         ids=["dp2", "tp2", "pp2"])
def test_train_cli_mesh_flags_match_the_unsharded_run(tmp_path, flags):
    """``train_cli --mode full`` with a mesh flag over two gloo ranks: the
    losses of the unsharded run in this process, and rank 0 writes the
    whole parameter tree, within 5e-5 of the unsharded run's."""
    import test_torch_port_training_cli as TCLI

    from alg_tpu_torch import train_cli

    model, config = TCLI._tiny("cogvideox")
    argv = ["--config", "unused.yaml", "--device", "cpu", "--lr", "1e-2", "--log_every", "100", "--synthetic", "4",
            "--steps", "2", "--batch_size", "2", "--mode", "full"]
    ranks = W.Ranks(W.cli_run, 2, tmp_path / "ranks", "train_cli", argv + ["--output", str(tmp_path / "mesh.npz"),
                                                                            *flags], None, config, model)
    ref = train_cli.run(config, train_cli.make_parser().parse_args(argv + ["--output", str(tmp_path / "one.npz")]),
                        transformer=model)
    with np.load(tmp_path / "one.npz") as z:
        want = {k: z[k] for k in z.files}
    (out, saved), (out1, _) = ranks.results()
    np.testing.assert_allclose(out["losses"], ref["losses"], rtol=1e-5)
    assert out1["losses"] == out["losses"]
    assert set(saved) == set(want)
    for name, value in want.items():
        np.testing.assert_allclose(saved[name], value, atol=5e-5, err_msg=name)


def test_train_cli_one_rank_mesh_is_the_unsharded_step(tmp_path):
    """In a one-rank launch ``--dp 1 --tp 1 --pp 1`` ask for no mesh, as in
    ``alg_tpu``; ``run(mesh=make_mesh())`` takes the sharded step over the
    DiT sharded from the host, bit for bit the unsharded run's losses and
    parameters, and leaves the given DiT (whose storage the rank shares
    with this process) as it was."""
    import test_torch_port_training_cli as TCLI

    from alg_tpu_torch import train_cli

    model, config = TCLI._tiny("cogvideox")
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    argv = ["--config", "unused.yaml", "--device", "cpu", "--lr", "1e-2", "--log_every", "100", "--synthetic", "4",
            "--steps", "2", "--batch_size", "2", "--mode", "full", "--output", str(tmp_path / "out.npz")]
    ranks = W.Ranks(W.train_cli_one_rank, 1, tmp_path / "ranks", config, argv, model)
    ref = train_cli.run(config, train_cli.make_parser().parse_args(argv), transformer=model)
    [(unsharded, losses, trained)] = ranks.results()
    assert unsharded
    assert losses == ref["losses"]
    assert set(trained) == set(ref["trainable"])
    for name, value in ref["trainable"].items():
        np.testing.assert_array_equal(trained[name], value.detach().numpy(), err_msg=name)
    for name, p in model.named_parameters():
        assert torch.equal(p, before[name]), name


def _cog_case():
    from alg_tpu.models.cogvideox import CogVideoXTransformerConfig, cogvideox_rope, init_cogvideox_transformer

    cfg = CogVideoXTransformerConfig(num_attention_heads=4, attention_head_dim=16, in_channels=8, out_channels=4,
                                     time_embed_dim=16, text_embed_dim=12, num_layers=2, sample_height=8,
                                     sample_width=8, max_text_seq_length=5)
    tree = random_tree(lambda k: init_cogvideox_transformer(k, cfg), 5)
    rng = np.random.RandomState(5)
    batch = {"latents": rng.randn(4, 2, 4, 4, 4).astype(np.float32),
             "image_latents": rng.randn(4, 2, 4, 4, 4).astype(np.float32),
             "encoder_hidden_states": rng.randn(4, 5, 12).astype(np.float32)}
    return cfg, tree, cogvideox_rope(cfg, 32, 32, 2), batch, [jax.random.PRNGKey(9), jax.random.PRNGKey(10)]


def _train_config(dims):
    return dict(learning_rate=1e-3, eps=1e-2, remat=dims[1] > 1)  # remat under pp, as alg_tpu's pp test


_JAX_STEPS = {}  # dims -> alg_tpu's sharded step, its state and the metrics of the steps taken so far


def _alg_tpu_steps(dims, n):
    """``alg_tpu``'s ``make_sharded_train_step`` over ``dims`` on the CPU
    devices: the metrics of its first ``n`` steps and the parameters after
    them. The steps are kept for the module, so the test of the second step
    takes one step more, not two."""
    from alg_tpu.ops.attention import set_attention_impl
    from alg_tpu.sharding import make_mesh
    from alg_tpu.sharding.partition import cogvideox_transformer_specs
    from alg_tpu.training import TrainConfig, make_cogvideox_vpred_loss, make_sharded_train_step, shard_batch

    cfg, tree, rope, batch, keys = _cog_case()
    dp, pp, sp, tp = dims
    mesh = make_mesh(dp=dp, pp=pp, sp=sp, tp=tp, devices=jax.local_devices(backend="cpu")[:4])
    set_attention_impl("xla")
    try:
        with mesh:
            if dims not in _JAX_STEPS:
                params = jax.tree.map(jnp.asarray, tree)
                jstep, p_sh, o_sh = make_sharded_train_step(
                    make_cogvideox_vpred_loss(cfg, rope_cos=rope[0], rope_sin=rope[1]),
                    TrainConfig(**_train_config(dims)), mesh, params, cogvideox_transformer_specs(params),
                    pp_micro=2 if pp > 1 else None)
                _JAX_STEPS[dims] = [jstep, p_sh, o_sh, shard_batch(jax.tree.map(jnp.asarray, batch), mesh), []]
            state = _JAX_STEPS[dims]
            while len(state[4]) < n:
                state[1], state[2], m = state[0](state[1], state[2], state[3], keys[len(state[4])])
                state[4].append((float(m["loss"]), float(m["grad_norm"])))
    finally:
        set_attention_impl(None)
    return state[4][:n], state[1]


@pytest.mark.parametrize("dims,steps", [((2, 1, 1, 2), 1), ((2, 1, 1, 2), 2), ((1, 2, 1, 2), 1), ((1, 2, 1, 2), 2)],
                         ids=["dp2tp2-step1", "dp2tp2-step2", "pp2tp2-step1", "pp2tp2-step2"])
def test_sharded_train_step_matches_alg_tpu(tmp_path, dims, steps):
    """Megatron gradients of the replicated norms and modulation linears,
    the dp mean, GPipe's backward with the non-block gradients summed over
    pp once, the global-norm clip over shards, AdamW on local shards and
    its moments carried into the second step: the port's ``steps`` steps
    against ``alg_tpu``'s, the parameters after the last. The step trains
    the sharded DiT's own parameters, and a DiT sharded from the host onto
    another device holds only this rank's shards there."""
    from alg_tpu_torch.io.jax_params import flatten_jax_tree
    from alg_tpu_torch.models.cogvideox import transformer as T

    cfg, tree, rope, batch, keys = _cog_case()
    draws = [_cog_draws(key, batch["latents"].shape) for key in keys[:steps]]
    ranks = W.Ranks(W.cogvideox_train_steps, 4, tmp_path, port_cfg(T.CogVideoXTransformerConfig, cfg), tree, rope,
                    batch, draws, dims, _train_config(dims), 2 if dims[1] > 1 else None)
    ref, p_sh = _alg_tpu_steps(dims, steps)
    res = ranks.results()
    metrics, full, _ = res[0]
    for r in res[1:]:  # every rank reports the same step
        assert r[0] == metrics
    assert all(r[2] for r in res)
    np.testing.assert_allclose(metrics[0][0], ref[0][0], rtol=1e-5)
    if steps > 1:
        np.testing.assert_allclose(metrics[1][0], ref[1][0], rtol=1e-4)
    np.testing.assert_allclose([m[1] for m in metrics], [r[1] for r in ref], rtol=1e-4)
    want = dict(flatten_jax_tree(jax.tree.map(np.asarray, p_sh)))
    assert set(want) == set(full)
    for name, value in want.items():
        np.testing.assert_allclose(full[name], value, atol=5e-5, err_msg=name)
