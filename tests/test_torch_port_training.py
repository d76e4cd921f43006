"""The port's training path on the CPU against the JAX package: the three
losses, LoRA (merged and attached), the train step (accumulation, clip,
decay, remat) and the slice as a whole (a tiny CogVideoX LoRA run whose
adapter is merged into the sampler).

Both packages start from the same numpy weights, batches and adapters. The
JAX losses draw from a PRNG key; the tests take the same draws from
``jax.random`` as ``alg_tpu/training/losses.py`` takes them (split the key,
timestep or sigma from the first half, noise from the second) and hand them
to the port as its ``draws``. The port runs on CPU tensors, so through the
plain versions of its kernels, with attention differentiated by
``FlashAttentionFunction`` (the backward kernels' arithmetic). All fp32
unless stated: loss values rtol 1e-5, gradients and parameters atol 1e-5
(other summation orders in the matmuls and softmax)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from alg_tpu import training as JT
from alg_tpu.models.cogvideox import init_cogvideox_transformer
from alg_tpu.models.hunyuan import hunyuan_rope as jax_hunyuan_rope
from alg_tpu.models.hunyuan import init_hunyuan_transformer
from alg_tpu.models.wan import init_wan_transformer, wan_rope as jax_wan_rope
from alg_tpu.training.losses import sample_flow_sigmas as jax_sample_flow_sigmas

from alg_tpu_torch.core.remat import remat_enabled
from alg_tpu_torch.io import lora as io_lora
from alg_tpu_torch.io.jax_params import flatten_jax_tree, load_jax_lora, lora_to_jax
from alg_tpu_torch.models.cogvideox.transformer import cogvideox_rope
from alg_tpu_torch.training import lora as TL
from alg_tpu_torch.training import losses as TLoss
from alg_tpu_torch.training import train as TT

from torch_port_common import (one_thread, one_torch_thread, port_module, random_tree, tiny_configs,
                               tiny_hunyuan_configs, tiny_wan_configs)

LOSS_RTOL, ATOL = 1e-5, 1e-5


def _params(module, grad=True):
    return {name: p.detach().clone().requires_grad_(grad) for name, p in module.named_parameters()}


def _tensors(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _cog_draws(key, shape):
    kt, kn = jax.random.split(key)
    t = np.asarray(jax.random.randint(kt, (shape[0],), 0, 1000))
    noise = np.asarray(jax.random.normal(kn, shape, jnp.float32))
    return {"t": torch.from_numpy(t.astype(np.int64)), "noise": torch.from_numpy(noise.copy())}


def _flow_draws(key, shape, shift):
    ks, kn = jax.random.split(key)
    sigma = np.asarray(jax_sample_flow_sigmas(ks, shape[0], shift=shift))
    noise = np.asarray(jax.random.normal(kn, shape, jnp.float32))
    return {"sigma": torch.from_numpy(sigma.copy()), "noise": torch.from_numpy(noise.copy())}


def _assert_grads_match(port_grads, jax_grads, atol=ATOL, looser=()):
    """``port_grads``: {parameter name: tensor}; ``jax_grads``: the JAX tree,
    brought to the port's names and layouts by the weights bridge. A
    parameter whose name ends with an entry of ``looser`` gets ten times the
    ``atol``."""
    ref = dict(flatten_jax_tree(jax.tree.map(np.asarray, jax_grads)))
    assert set(ref) == set(port_grads)
    for name, r in ref.items():  # fp32 sums: the error grows with the tensor's largest gradient
        scale = max(1.0, float(np.abs(r).max())) * (10.0 if name.endswith(tuple(looser)) else 1.0)
        np.testing.assert_allclose(port_grads[name].numpy(), r, atol=atol * scale, rtol=1e-4, err_msg=name)


# -- CogVideoX fixtures ---------------------------------------------------------


def _cog_setup(seed=1):
    tcfg, _, _ = tiny_configs()
    tree = random_tree(lambda k: init_cogvideox_transformer(k, tcfg), seed)
    cos, sin = cogvideox_rope(port_module("dit", tcfg, tree).cfg, 64, 64, 2)
    return tcfg, tree, cos, sin


def _cog_batch(b=2, seed=0):
    rng = np.random.RandomState(seed)
    return {"latents": rng.randn(b, 2, 4, 8, 8).astype(np.float32),
            "image_latents": rng.randn(b, 2, 4, 8, 8).astype(np.float32),
            "encoder_hidden_states": rng.randn(b, 3, 12).astype(np.float32)}


def _jax_lora_tree(tree, rank=4, seed=5, prefixes=("blocks",), bump=0.03):
    """A JAX adapter tree as numpy, with B moved off zero so that the delta is not zero."""
    loras = JT.init_lora_params(jax.random.PRNGKey(seed), tree, rank=rank, prefixes=prefixes)
    return jax.tree.map(lambda x: np.asarray(x) + np.float32(bump), loras)


# -- losses -----------------------------------------------------------------------


def test_cogvideox_vpred_loss_and_gradients():
    tcfg, tree, cos, sin = _cog_setup()
    batch, key = _cog_batch(), jax.random.PRNGKey(3)
    jl, jg = jax.value_and_grad(JT.make_cogvideox_vpred_loss(tcfg, rope_cos=cos, rope_sin=sin))(
        jax.tree.map(jnp.asarray, tree), _jnp(batch), key)
    model = port_module("dit", tcfg, tree)
    params = _params(model)
    loss = TLoss.make_cogvideox_vpred_loss(model, rope_cos=cos, rope_sin=sin)(
        params, _tensors(batch), _cog_draws(key, batch["latents"].shape))
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=LOSS_RTOL)
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    _assert_grads_match(grads, jg)


def _wan_setup():
    tcfg, _, _, _ = tiny_wan_configs()
    tree = random_tree(lambda k: init_wan_transformer(k, tcfg), 11)
    rng = np.random.RandomState(1)
    batch = {"latents": rng.randn(2, 4, 2, 8, 8).astype(np.float32),
             "condition": rng.randn(2, 8, 2, 8, 8).astype(np.float32),
             "encoder_hidden_states": rng.randn(2, 5, 8).astype(np.float32),
             "encoder_hidden_states_image": rng.randn(2, 5, 10).astype(np.float32)}
    return tcfg, tree, batch, jax_wan_rope(tcfg, 2, 8, 8)


@pytest.mark.parametrize("with_image", [True, False], ids=["image-embeds", "text-only"])
def test_wan_flow_loss_and_gradients(with_image):
    tcfg, tree, batch, (cos, sin) = _wan_setup()
    if not with_image:
        del batch["encoder_hidden_states_image"]
    key = jax.random.PRNGKey(4)
    jl, jg = jax.value_and_grad(JT.make_wan_flow_loss(tcfg, shift=5.0, rope_cos=cos, rope_sin=sin))(
        jax.tree.map(jnp.asarray, tree), _jnp(batch), key)
    model = port_module("wan_dit", tcfg, tree)
    params = _params(model)
    loss = TLoss.make_wan_flow_loss(model, shift=5.0, rope_cos=cos, rope_sin=sin)(
        params, _tensors(batch), _flow_draws(key, batch["latents"].shape, 5.0))
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=LOSS_RTOL)
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()), allow_unused=True)))
    if not with_image:  # the image branch takes no part: no gradient in the port, zeros in JAX
        unused = [n for n, g in grads.items() if g is None]
        assert unused and all("image" in n or "add_" in n or "norm_added" in n for n in unused), unused
        grads = {n: torch.zeros_like(params[n]) if g is None else g for n, g in grads.items()}
    _assert_grads_match(grads, jg)


def _hunyuan_setup(**over):
    tcfg, _, _, _ = tiny_hunyuan_configs(**over)
    tree = random_tree(lambda k: init_hunyuan_transformer(k, tcfg), 31)
    rng = np.random.RandomState(2)
    batch = {"latents": rng.randn(2, 4, 2, 8, 8).astype(np.float32),
             "image_latents": rng.randn(2, 4, 1, 8, 8).astype(np.float32),
             "encoder_hidden_states": rng.randn(2, 5, 12).astype(np.float32),
             "encoder_attention_mask": np.asarray([[1, 1, 1, 1, 1], [1, 1, 1, 0, 0]], np.int32),
             "pooled_projections": rng.randn(2, 6).astype(np.float32)}
    return tcfg, tree, batch, jax_hunyuan_rope(tcfg, 2, 8, 8)


def test_hunyuan_flow_loss_and_gradients_token_replace():
    tcfg, tree, batch, (cos, sin) = _hunyuan_setup()
    assert tcfg.image_condition_type == "token_replace"
    key = jax.random.PRNGKey(5)
    jl, jg = jax.value_and_grad(JT.make_hunyuan_flow_loss(tcfg, shift=7.0, rope_cos=cos, rope_sin=sin))(
        jax.tree.map(jnp.asarray, tree), _jnp(batch), key)
    model = port_module("hunyuan_dit", tcfg, tree)
    params = _params(model)
    loss_fn = TLoss.make_hunyuan_flow_loss(model, shift=7.0, rope_cos=cos, rope_sin=sin)
    draws = _flow_draws(key, batch["latents"].shape, 7.0)
    loss = loss_fn(params, _tensors(batch), draws)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=LOSS_RTOL)
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    # the guidance embedder's first weight multiplies sin/cos of 6000·frequency: fp32 rounds that argument
    # to about 5e-4, and the two frameworks' sin/cos then differ by as much, which the gradient repeats
    _assert_grads_match(grads, jg, looser=("guidance_embedder.linear_1.weight",))
    # frame 0 is outside the loss: its noise does not move the value
    other = dict(draws, noise=draws["noise"].clone())
    other["noise"][:, :, 0] += 1.0
    assert float(loss_fn(params, _tensors(batch), other).detach()) == float(loss.detach())


def test_cogvideox_loss_bf16_compute_keeps_fp32_masters():
    """``compute_dtype`` bf16: the forward runs in bf16, gradients come back
    in fp32 on the fp32 masters. Against the JAX package's bf16 loss rtol
    5e-2: both round every activation to bf16 (about 3 digits), at other
    places; against the port's own fp32 loss the same bound."""
    tcfg, tree, cos, sin = _cog_setup()
    batch, key = _cog_batch(), jax.random.PRNGKey(6)
    jl = JT.make_cogvideox_vpred_loss(tcfg, rope_cos=cos, rope_sin=sin, compute_dtype=jnp.bfloat16)(
        jax.tree.map(jnp.asarray, tree), _jnp(batch), key)
    model = port_module("dit", tcfg, tree)
    params, draws = _params(model), _cog_draws(key, batch["latents"].shape)
    loss = TLoss.make_cogvideox_vpred_loss(model, rope_cos=cos, rope_sin=sin, compute_dtype=torch.bfloat16)(
        params, _tensors(batch), draws)
    full = TLoss.make_cogvideox_vpred_loss(model, rope_cos=cos, rope_sin=sin)(params, _tensors(batch), draws)
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=5e-2)
    np.testing.assert_allclose(float(loss.detach()), float(full.detach()), rtol=5e-2)
    grads = torch.autograd.grad(loss, list(params.values()))
    assert all(g.dtype == torch.float32 and torch.isfinite(g).all() for g in grads)


@pytest.mark.parametrize("sampling", ["logit_normal", "uniform"])
def test_sigma_draws_and_shift(sampling):
    gen = torch.Generator().manual_seed(0)
    sig = TLoss.sample_flow_sigmas(gen, 4096, shift=5.0, sampling=sampling)
    assert sig.dtype == torch.float32 and float(sig.min()) > 0.0 and float(sig.max()) < 1.0
    u = np.linspace(0.01, 0.99, 7).astype(np.float32)
    np.testing.assert_allclose(TLoss.shift_sigmas(torch.from_numpy(u), 5.0).numpy(),
                               np.asarray(JT.shift_sigmas(jnp.asarray(u), 5.0)), rtol=1e-6)
    # shifted upward: the median of the unshifted draw is 0.5
    assert float(sig.median()) > 0.7
    with pytest.raises(ValueError):
        TLoss.sample_flow_sigmas(gen, 2, sampling="cosine")


def test_loss_draw_is_seeded_and_shaped():
    tcfg, tree, cos, sin = _cog_setup()
    loss_fn = TLoss.make_cogvideox_vpred_loss(port_module("dit", tcfg, tree), rope_cos=cos, rope_sin=sin)
    batch = _tensors(_cog_batch())
    a, b = (loss_fn.draw(batch, torch.Generator().manual_seed(7)) for _ in range(2))
    assert a["t"].dtype == torch.int64 and tuple(a["t"].shape) == (2,) and 0 <= int(a["t"].min()) < 1000
    assert a["noise"].shape == batch["latents"].shape and a["noise"].dtype == torch.float32
    assert torch.equal(a["t"], b["t"]) and torch.equal(a["noise"], b["noise"])


# -- LoRA ---------------------------------------------------------------------------


def test_init_lora_params_layout_matches_jax():
    tcfg, tree, _, _ = _cog_setup()
    base = _params(port_module("dit", tcfg, tree), grad=False)
    ref = JT.init_lora_params(jax.random.PRNGKey(0), tree, rank=4, prefixes=("blocks",))
    got = TL.init_lora_params(torch.Generator().manual_seed(0), base, rank=4, prefixes=("blocks",))
    assert set(got) == set(ref)
    for path in ref:
        assert tuple(got[path]["A"].shape) == ref[path]["A"].shape, path
        assert tuple(got[path]["B"].shape) == ref[path]["B"].shape, path
        assert not got[path]["B"].any() and got[path]["A"].dtype == torch.float32
    # A ~ N(0, 1)/r
    a = torch.cat([ab["A"].flatten() for ab in got.values()])
    assert abs(float(a.std()) - 0.25) < 0.02 and abs(float(a.mean())) < 0.02
    # without prefixes the output head's proj_out is adapted too, as in JAX
    assert set(TL.init_lora_params(torch.Generator().manual_seed(0), base, rank=2)) == set(
        JT.init_lora_params(jax.random.PRNGKey(0), tree, rank=2))
    with pytest.raises(ValueError):
        TL.init_lora_params(torch.Generator().manual_seed(0), base, targets=("nothing",))


@pytest.mark.parametrize("family", ["wan", "hunyuan"])
def test_lora_paths_of_the_other_families_match_jax(family):
    if family == "wan":
        tcfg, tree, _, _ = _wan_setup()
        kind = "wan_dit"
    else:
        tcfg, tree, _, _ = _hunyuan_setup()
        kind = "hunyuan_dit"
    prefixes, templates = TL.FAMILY_PEFT[family]
    assert (prefixes, templates) == JT.FAMILY_PEFT[family]
    base = _params(port_module(kind, tcfg, tree), grad=False)
    ref = JT.init_lora_params(jax.random.PRNGKey(0), tree, rank=2, prefixes=prefixes)
    got = TL.init_lora_params(torch.Generator().manual_seed(0), base, rank=2, prefixes=prefixes)
    assert set(got) == set(ref) and set(got) <= set(templates)
    for path in ref:
        assert tuple(got[path]["A"].shape) == ref[path]["A"].shape, path
        assert tuple(got[path]["B"].shape) == ref[path]["B"].shape, path


@pytest.mark.parametrize("attach", [False, True], ids=["merged", "attached"])
def test_lora_loss_and_adapter_gradients_match_jax(attach):
    tcfg, tree, cos, sin = _cog_setup()
    batch, key = _cog_batch(), jax.random.PRNGKey(8)
    jloras = _jax_lora_tree(tree)
    jloss = JT.make_lora_loss(JT.make_cogvideox_vpred_loss(tcfg, rope_cos=cos, rope_sin=sin),
                              jax.tree.map(jnp.asarray, tree), scale=0.7, attach=attach)
    jl, jg = jax.value_and_grad(jloss)(jax.tree.map(jnp.asarray, jloras), _jnp(batch), key)
    model = port_module("dit", tcfg, tree)
    base = _params(model, grad=False)
    loras = load_jax_lora(jloras)
    loss = TL.make_lora_loss(TLoss.make_cogvideox_vpred_loss(model, rope_cos=cos, rope_sin=sin), base, scale=0.7,
                             attach=attach)(loras, _tensors(batch), _cog_draws(key, batch["latents"].shape))
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=LOSS_RTOL)
    leaves = TT.tree_leaves(loras)
    grads = TT.tree_unflatten(loras, torch.autograd.grad(loss, leaves))
    for path, ab in jg.items():
        for name in ("A", "B"):
            np.testing.assert_allclose(grads[path][name].numpy(), np.asarray(ab[name]), atol=ATOL, rtol=1e-4,
                                       err_msg=f"{path}/{name}")
    # only the adapters take a gradient: the base is frozen and the module's own parameters stay untouched
    assert not any(p.requires_grad for p in base.values())
    assert all(p.grad is None for p in base.values()) and all(p.grad is None for p in model.parameters())


def test_attach_equals_apply_and_base_is_untouched():
    tcfg, tree, cos, sin = _cog_setup()
    model = port_module("dit", tcfg, tree)
    base = _params(model, grad=False)
    before = {n: p.clone() for n, p in base.items()}
    loras = load_jax_lora(_jax_lora_tree(tree), requires_grad=False)
    loss_fn = TLoss.make_cogvideox_vpred_loss(model, rope_cos=cos, rope_sin=sin)
    batch, draws = _tensors(_cog_batch()), _cog_draws(jax.random.PRNGKey(9), (2, 2, 4, 8, 8))
    merged = TL.make_lora_loss(loss_fn, base, scale=0.7, attach=False)(loras, batch, draws)
    attached = TL.make_lora_loss(loss_fn, base, scale=0.7, attach=True)(loras, batch, draws)
    np.testing.assert_allclose(float(merged), float(attached), rtol=1e-5)
    assert float(merged) != float(loss_fn(base, batch, draws))  # the adapters do something
    assert all(torch.equal(base[n], before[n]) for n in base)
    bound = TL.attach_lora(base, loras, 0.7)
    assert bound["blocks.1.attn.to_q.weight"] is base["blocks.1.attn.to_q.weight"]
    assert torch.equal(bound["blocks.1.attn.to_q.lora_B"], loras["blocks/attn/to_q"]["B"][1] * 0.7)
    # B = 0: the adapted model is the base model, and the module holds no adapter afterwards
    zero = {p: {"A": ab["A"], "B": torch.zeros_like(ab["B"])} for p, ab in loras.items()}
    assert float(TL.make_lora_loss(loss_fn, base, attach=True)(zero, batch, draws)) == float(
        loss_fn(base, batch, draws))
    assert model.blocks[0].attn.to_q.lora_A is None and "blocks.0.attn.to_q.lora_A" not in model.state_dict()


def test_lora_loss_base_as_call_argument_and_errors():
    tcfg, tree, cos, sin = _cog_setup()
    model = port_module("dit", tcfg, tree)
    base = _params(model, grad=False)
    loras = load_jax_lora(_jax_lora_tree(tree), requires_grad=False)
    loss_fn = TLoss.make_cogvideox_vpred_loss(model, rope_cos=cos, rope_sin=sin)
    batch, draws = _tensors(_cog_batch()), _cog_draws(jax.random.PRNGKey(10), (2, 2, 4, 8, 8))
    closed = TL.make_lora_loss(loss_fn, base, attach=True)(loras, batch, draws)
    as_arg = TL.make_lora_loss(loss_fn, None, attach=True)(loras, batch, draws, base)
    assert float(closed) == float(as_arg)
    assert TL.make_lora_loss(loss_fn, None, attach=True).draw is loss_fn.draw
    with pytest.raises(ValueError):
        TL.make_lora_loss(loss_fn, None)
    # a quantized to_q (once refused): attached, never merged
    quantized = {n: t for n, t in base.items() if n != "blocks.0.attn.to_q.weight"}
    quantized["blocks.0.attn.to_q.weight_q"] = torch.zeros(base["blocks.0.attn.to_q.weight"].shape, dtype=torch.int8)
    assert TL.has_quantized_kernels(quantized) and not TL.has_quantized_kernels(base)
    assert TL.has_quantized_kernels({"blocks.attn.to_q.kernel_q": torch.zeros(1)})
    with pytest.raises(ValueError, match="attach"):
        TL.apply_lora(quantized, loras)
    attached = TL.attach_lora(quantized, loras)
    assert torch.equal(attached["blocks.0.attn.to_q.lora_A"], loras["blocks/attn/to_q"]["A"][0])
    with pytest.raises(KeyError):
        TL.attach_lora(base, {"blocks/attn/nope": loras["blocks/attn/to_q"]})


def test_to_peft_state_equals_jax_and_merges_through_io_lora():
    tcfg, tree, _, _ = _cog_setup()
    jloras = _jax_lora_tree(tree)
    ref = JT.to_peft_state(jax.tree.map(jnp.asarray, jloras), JT.COGVIDEOX_PEFT_PATHS)
    loras = load_jax_lora(jloras)
    got = TL.to_peft_state(loras, TL.COGVIDEOX_PEFT_PATHS)
    assert set(got) == set(ref)
    for name in ref:
        np.testing.assert_array_equal(got[name], np.asarray(ref[name]), err_msg=name)
    for path, ab in lora_to_jax(loras).items():  # and back to the JAX tree
        np.testing.assert_array_equal(ab["A"], jloras[path]["A"])
    with pytest.raises(KeyError):
        TL.to_peft_state(loras, {})
    # peft export -> io.lora merge == apply_lora, and == the JAX package's merge of the same state
    base = _params(port_module("dit", tcfg, tree), grad=False)
    merged_io = io_lora.merge_lora_cogvideox(base, got, scale=0.5)
    merged_tr = TL.apply_lora(base, loras, scale=0.5)
    from alg_tpu.io.lora import merge_lora_cogvideox as jax_merge

    jmerged = dict(flatten_jax_tree(jax.tree.map(np.asarray, jax_merge(jax.tree.map(jnp.asarray, tree), ref, scale=0.5))))
    assert set(merged_io) == set(base)
    for name in base:
        np.testing.assert_allclose(merged_io[name].numpy(), merged_tr[name].detach().numpy(), atol=1e-6, err_msg=name)
        np.testing.assert_allclose(merged_io[name].numpy(), jmerged[name], atol=1e-6, err_msg=name)
    assert merged_io["proj_out.weight"] is base["proj_out.weight"]  # untouched tensors are shared
    with pytest.raises(KeyError):
        io_lora.merge_lora_cogvideox(base, {"transformer.transformer_blocks.0.attn9.to_q.lora_A.weight": got[
            "transformer.transformer_blocks.0.attn1.to_q.lora_A.weight"], "transformer.transformer_blocks.0.attn9."
            "to_q.lora_B.weight": got["transformer.transformer_blocks.0.attn1.to_q.lora_B.weight"]})


@pytest.mark.parametrize("family", ["wan", "hunyuan"])
def test_io_lora_merges_the_other_families_like_jax(family):
    from alg_tpu.io import lora as jax_io_lora

    if family == "wan":
        (tcfg, tree, _, _), kind = _wan_setup(), "wan_dit"
    else:
        (tcfg, tree, _, _), kind = _hunyuan_setup(), "hunyuan_dit"
    prefixes, templates = TL.FAMILY_PEFT[family]
    jloras = _jax_lora_tree(tree, rank=2, prefixes=prefixes)
    state = TL.to_peft_state(load_jax_lora(jloras), templates)
    base = _params(port_module(kind, tcfg, tree), grad=False)
    merged = getattr(io_lora, f"merge_lora_{family}")(base, state, scale=0.5)
    ref = getattr(jax_io_lora, f"merge_lora_{family}")(jax.tree.map(jnp.asarray, tree), state, scale=0.5)
    ref = dict(flatten_jax_tree(jax.tree.map(np.asarray, ref)))
    changed = 0
    for name in base:
        np.testing.assert_allclose(merged[name].numpy(), ref[name], atol=1e-6, err_msg=name)
        changed += not torch.equal(merged[name], base[name])
    assert changed == len(state) // 2


# -- the train step -------------------------------------------------------------------


def _jax_steps(jloss, tc, jloras, batches, keys):
    step, opt = JT.make_train_step(jloss, JT.TrainConfig(**tc))
    step = jax.jit(step)  # one compile, where op-by-op dispatch compiles every op of the step
    params = jax.tree.map(jnp.asarray, jloras)
    state, out = opt.init(params), []
    for batch, key in zip(batches, keys):
        params, state, m = step(params, state, _jnp(batch), key)
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return jax.tree.map(np.asarray, params), out


@pytest.mark.parametrize("accum", [1, 2], ids=["accum1", "accum2"])
def test_train_step_matches_jax_over_three_steps(accum):
    """Three LoRA steps with clip on (the clip binds: grad_norm > 0.05) and
    weight decay > 0 from the same adapters: loss rtol 1e-5, grad_norm rtol
    1e-4, adapters atol 1e-5."""
    tcfg, tree, cos, sin = _cog_setup()
    tc = dict(learning_rate=1e-2, weight_decay=0.1, grad_clip=0.05, accum_steps=accum, eps=1e-6)
    jloras = _jax_lora_tree(tree)
    batches = [_cog_batch(b=2 * accum, seed=s) for s in range(3)]
    keys = [jax.random.fold_in(jax.random.PRNGKey(11), i) for i in range(3)]
    jloss = JT.make_lora_loss(JT.make_cogvideox_vpred_loss(tcfg, rope_cos=cos, rope_sin=sin),
                              jax.tree.map(jnp.asarray, tree), attach=True)
    jparams, jmetrics = _jax_steps(jloss, tc, jloras, batches, keys)

    model = port_module("dit", tcfg, tree)
    loss = TL.make_lora_loss(TLoss.make_cogvideox_vpred_loss(model, rope_cos=cos, rope_sin=sin),
                             _params(model, grad=False), attach=True)
    step, opt = TT.make_train_step(loss, TT.TrainConfig(**tc))
    loras = load_jax_lora(jloras)
    state = opt.init(loras)
    micro_shape = (2,) + batches[0]["latents"].shape[1:]
    for i, (batch, key) in enumerate(zip(batches, keys)):
        if accum == 1:
            draws = _cog_draws(key, micro_shape)
        else:  # the JAX step splits its key into one per micro-batch
            draws = [_cog_draws(k, micro_shape) for k in jax.random.split(key, accum)]
        loras, state, m = step(loras, state, _tensors(batch), draws)
        np.testing.assert_allclose(float(m["loss"]), jmetrics[i][0], rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(m["grad_norm"]), jmetrics[i][1], rtol=1e-4)
        assert float(m["grad_norm"]) > tc["grad_clip"]
    assert int(state["count"]) == 3
    for path, ab in jparams.items():
        for name in ("A", "B"):
            np.testing.assert_allclose(loras[path][name].detach().numpy(), ab[name], atol=ATOL, err_msg=f"{path}/{name}")


def test_full_finetune_step_matches_jax_without_clip():
    """Every DiT parameter trained for two steps, clip off, decay on."""
    tcfg, tree, cos, sin = _cog_setup()
    tc = dict(learning_rate=1e-3, weight_decay=0.05, grad_clip=0.0, eps=1e-3)
    batches, keys = [_cog_batch(seed=s) for s in range(2)], [jax.random.PRNGKey(20), jax.random.PRNGKey(21)]
    jparams, jmetrics = _jax_steps(JT.make_cogvideox_vpred_loss(tcfg, rope_cos=cos, rope_sin=sin), tc, tree, batches, keys)
    model = port_module("dit", tcfg, tree)
    step, opt = TT.make_train_step(TLoss.make_cogvideox_vpred_loss(model, rope_cos=cos, rope_sin=sin), TT.TrainConfig(**tc))
    params = _params(model)
    state = opt.init(params)
    for i, (batch, key) in enumerate(zip(batches, keys)):
        with one_torch_thread():
            params, state, m = step(params, state, _tensors(batch), _cog_draws(key, batch["latents"].shape))
        np.testing.assert_allclose(float(m["loss"]), jmetrics[i][0], rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(m["grad_norm"]), jmetrics[i][1], rtol=1e-4)
    ref = dict(flatten_jax_tree(jparams))
    for name, p in params.items():
        np.testing.assert_allclose(p.detach().numpy(), ref[name], atol=ATOL, err_msg=name)


@pytest.mark.parametrize("family", ["cogvideox", "wan", "hunyuan"])
def test_remat_is_bit_identical_and_scoped(family):
    if family == "cogvideox":
        tcfg, tree, cos, sin = _cog_setup()
        model, batch = port_module("dit", tcfg, tree), _cog_batch()
        loss_fn = TLoss.make_cogvideox_vpred_loss(model, rope_cos=cos, rope_sin=sin)
    elif family == "wan":
        tcfg, tree, batch, (cos, sin) = _wan_setup()
        model = port_module("wan_dit", tcfg, tree)
        loss_fn = TLoss.make_wan_flow_loss(model, rope_cos=cos, rope_sin=sin)
    else:
        tcfg, tree, batch, (cos, sin) = _hunyuan_setup()
        model = port_module("hunyuan_dit", tcfg, tree)
        loss_fn = TLoss.make_hunyuan_flow_loss(model, rope_cos=cos, rope_sin=sin)
    prefixes, _ = TL.FAMILY_PEFT[family]
    base = _params(model, grad=False)
    lora_loss = TL.make_lora_loss(loss_fn, base, attach=True)
    batch = _tensors(batch)
    draws = loss_fn.draw(batch, torch.Generator().manual_seed(3))
    results = []
    for remat in (False, True):
        loras = TL.init_lora_params(torch.Generator().manual_seed(1), base, rank=2, prefixes=prefixes)
        loras = TT.tree_map(lambda t: (t + 0.02).requires_grad_(), loras)
        seen = []
        model.register_forward_pre_hook(lambda *_: seen.append(remat_enabled()))
        step, opt = TT.make_train_step(lora_loss, TT.TrainConfig(learning_rate=1e-2, remat=remat))
        loras, _, m = step(loras, opt.init(loras), batch, draws)
        model._forward_pre_hooks.clear()
        assert seen == [remat] and not remat_enabled()
        results.append((float(m["loss"]), float(m["grad_norm"]), TT.tree_leaves(loras)))
    assert results[0][:2] == results[1][:2]
    assert all(torch.equal(a, b) for a, b in zip(results[0][2], results[1][2]))


def test_train_step_draws_from_a_generator_and_checks_its_inputs():
    tcfg, tree, cos, sin = _cog_setup()
    model = port_module("dit", tcfg, tree)
    loss_fn = TLoss.make_cogvideox_vpred_loss(model, rope_cos=cos, rope_sin=sin)
    lora_loss = TL.make_lora_loss(loss_fn, _params(model, grad=False), attach=True)
    step, opt = TT.make_train_step(lora_loss, TT.TrainConfig(learning_rate=1e-2, accum_steps=2))
    batch = _tensors(_cog_batch(b=4))

    def run(seed):
        loras = load_jax_lora(_jax_lora_tree(tree))
        _, _, m = step(loras, opt.init(loras), batch, torch.Generator().manual_seed(seed))
        return float(m["loss"])

    assert run(1) == run(1) and run(1) != run(2)
    loras = load_jax_lora(_jax_lora_tree(tree))
    with pytest.raises(ValueError):
        step(loras, opt.init(loras), _tensors(_cog_batch(b=3)), torch.Generator().manual_seed(0))
    with pytest.raises(ValueError):  # one dict of draws cannot serve two micro-batches
        step(loras, opt.init(loras), batch, _cog_draws(jax.random.PRNGKey(0), (2, 2, 4, 8, 8)))
    frozen = load_jax_lora(_jax_lora_tree(tree), requires_grad=False)
    with pytest.raises(ValueError):
        step(frozen, opt.init(frozen), batch, torch.Generator().manual_seed(0))


# -- the slice as a whole ---------------------------------------------------------------


def test_tiny_lora_run_then_merged_adapter_samples_like_jax():
    """A tiny CogVideoX LoRA run of 4 steps in both packages from the same
    adapters (attached, remat on in the port), then each package merges its
    trained adapter into its own pipeline through its peft export and
    ``io.lora``, and two sampler steps are compared: latents atol 2e-3, the
    bound of the port's pipeline tests."""
    from alg_tpu.io.lora import merge_lora_cogvideox as jax_merge
    from torch_port_common import build_pair

    jpipe, tpipe = build_pair()
    tcfg, tree = jpipe.transformer_cfg, jpipe.transformer_params
    model = tpipe.transformer
    cos, sin = cogvideox_rope(model.cfg, 64, 64, 2)
    tc = dict(learning_rate=5e-3, weight_decay=0.01, grad_clip=1.0)
    jloras = jax.tree.map(np.asarray, JT.init_lora_params(jax.random.PRNGKey(2), tree, rank=4, prefixes=("blocks",)))
    batches = [_cog_batch(seed=10 + s) for s in range(4)]
    keys = [jax.random.fold_in(jax.random.PRNGKey(12), i) for i in range(4)]
    jloss = JT.make_lora_loss(JT.make_cogvideox_vpred_loss(tcfg, rope_cos=cos, rope_sin=sin),
                              jax.tree.map(jnp.asarray, tree), scale=2.0, attach=True)
    jtrained, jmetrics = _jax_steps(jloss, tc, jloras, batches, keys)

    base = _params(model, grad=False)
    loss = TL.make_lora_loss(TLoss.make_cogvideox_vpred_loss(model, rope_cos=cos, rope_sin=sin), base, scale=2.0,
                             attach=True)
    step, opt = TT.make_train_step(loss, TT.TrainConfig(remat=True, **tc))
    loras = load_jax_lora(jloras)
    state = opt.init(loras)
    for i, (batch, key) in enumerate(zip(batches, keys)):
        loras, state, m = step(loras, state, _tensors(batch), _cog_draws(key, batch["latents"].shape))
        np.testing.assert_allclose(float(m["loss"]), jmetrics[i][0], rtol=LOSS_RTOL)
    for path, ab in jtrained.items():
        np.testing.assert_allclose(loras[path]["B"].detach().numpy(), ab["B"], atol=ATOL, err_msg=path)
        assert np.abs(ab["B"]).max() > 0

    jpipe.transformer_params = jax_merge(jax.tree.map(jnp.asarray, tree),
                                         JT.to_peft_state(jtrained, JT.COGVIDEOX_PEFT_PATHS), scale=2.0)
    merged = io_lora.merge_lora_cogvideox(base, TL.to_peft_state(loras, TL.COGVIDEOX_PEFT_PATHS), scale=2.0)
    before = model.blocks[0].attn.to_q.weight.detach().clone()
    model.load_state_dict(merged)
    assert not torch.equal(model.blocks[0].attn.to_q.weight, before)
    image = np.random.RandomState(0).uniform(-1, 1, (1, 3, 32, 32)).astype(np.float32)
    kw = dict(image=image, prompt="a fox", negative_prompt="", height=32, width=32, num_frames=5,
              num_inference_steps=2, guidance_scale=6.0, seed=0, max_sequence_length=4, output_type="latent")
    ref = np.asarray(jpipe(**kw))
    out = tpipe(**kw)
    np.testing.assert_allclose(out, ref, atol=2e-3, rtol=0)
