"""QLoRA in the port (``training/lora.py`` over ``QuantizedLinear`` bases,
``train_cli --quantize``) against the JAX package on the CPU, fp32:

* the adapters over a quantized base: the same paths and shapes as
  ``alg_tpu``'s ``init_lora_params`` (an int4 weight's IN counted twice);
  attached, never merged; ``has_quantized_kernels`` on both packages' names;
* three QLoRA steps of each family (CogVideoX w8, Wan w4, HunyuanVideo w8
  with its modulation linears) against ``alg_tpu``'s ``make_lora_loss``
  over the same quantized tree, each quantized linear of the port fed the
  activation ``alg_tpu``'s got (``torch_port_common.QuantTeacher``; a code
  that rounds the other way at a tie would otherwise move the loss by more
  than the bound): loss rtol 1e-5, adapters atol 1e-5 (AdamW eps 1e-4, as
  phase E2 on the card), and the base takes no gradient;
* ``train_cli.run --quantize`` over a checkpoint directory and with
  ``--random_init``'s block-by-block build: the base is quantized (the
  modulation linears too for HunyuanVideo's random build), the adapters
  train, the base does not move; and ``--quantize`` without ``--mode lora``
  is ``alg_tpu``'s parser error."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from alg_tpu import training as JT
from alg_tpu.ops import quant as JQ

from alg_tpu_torch import train_cli
from alg_tpu_torch.io.jax_params import load_jax_lora
from alg_tpu_torch.models.layers import QuantizedLinear
from alg_tpu_torch.ops import quant as Q
from alg_tpu_torch.training import lora as TL
from alg_tpu_torch.training import losses as TLoss
from alg_tpu_torch.training import train as TT

from torch_port_common import QuantTeacher, one_thread, quant_dit

LOSS_RTOL, ATOL = 1e-5, 1e-5
QLORA = {"cogvideox": ("w8", False), "wan": ("w4", False), "hunyuan": ("w8", True)}  # mode, modulation


def _batch(family, cfg, seed):
    rng = np.random.RandomState(seed)

    def randn(*shape):
        return rng.randn(*shape).astype(np.float32)

    if family == "cogvideox":
        return {"latents": randn(2, 2, 4, 8, 8), "image_latents": randn(2, 2, 4, 8, 8),
                "encoder_hidden_states": randn(2, 3, cfg.text_embed_dim)}
    if family == "wan":
        return {"latents": randn(2, 4, 2, 8, 8), "condition": randn(2, 8, 2, 8, 8),
                "encoder_hidden_states": randn(2, 5, cfg.text_dim),
                "encoder_hidden_states_image": randn(2, 5, cfg.image_dim)}
    return {"latents": randn(2, 4, 2, 8, 8), "image_latents": randn(2, 4, 1, 8, 8),
            "encoder_hidden_states": randn(2, 5, cfg.text_embed_dim),
            "encoder_attention_mask": np.asarray([[1, 1, 1, 1, 1], [1, 1, 1, 0, 0]], np.int32),
            "pooled_projections": randn(2, cfg.pooled_projection_dim)}


def _draws(family, key, shape):
    """The draws ``alg_tpu``'s loss takes from ``key``, for the port's loss."""
    if family == "cogvideox":
        kt, kn = jax.random.split(key)
        return {"t": torch.from_numpy(np.asarray(jax.random.randint(kt, (shape[0],), 0, 1000)).astype(np.int64)),
                "noise": torch.from_numpy(np.asarray(jax.random.normal(kn, shape, jnp.float32)).copy())}
    from alg_tpu.training.losses import sample_flow_sigmas

    ks, kn = jax.random.split(key)
    shift = 5.0 if family == "wan" else 7.0
    return {"sigma": torch.from_numpy(np.asarray(sample_flow_sigmas(ks, shape[0], shift=shift)).copy()),
            "noise": torch.from_numpy(np.asarray(jax.random.normal(kn, shape, jnp.float32)).copy())}


def _losses(family, cfg, model):
    """(``alg_tpu``'s loss, the port's loss) of the family over the batch's latent geometry (2, 8, 8)."""
    if family == "cogvideox":
        from alg_tpu_torch.models.cogvideox.transformer import cogvideox_rope

        cos, sin = cogvideox_rope(model.cfg, 64, 64, 2)
        return (JT.make_cogvideox_vpred_loss(cfg, rope_cos=cos, rope_sin=sin),
                TLoss.make_cogvideox_vpred_loss(model, rope_cos=cos, rope_sin=sin))
    if family == "wan":
        from alg_tpu.models.wan import wan_rope

        cos, sin = wan_rope(cfg, 2, 8, 8)
        return (JT.make_wan_flow_loss(cfg, shift=5.0, rope_cos=cos, rope_sin=sin),
                TLoss.make_wan_flow_loss(model, shift=5.0, rope_cos=cos, rope_sin=sin))
    from alg_tpu.models.hunyuan import hunyuan_rope

    cos, sin = hunyuan_rope(cfg, 2, 8, 8)
    return (JT.make_hunyuan_flow_loss(cfg, shift=7.0, rope_cos=cos, rope_sin=sin),
            TLoss.make_hunyuan_flow_loss(model, shift=7.0, rope_cos=cos, rope_sin=sin))


def _quantized(family):
    """(JAX config, the quantized numpy tree, the port's DiT loaded from it)."""
    mode, modulation = QLORA[family]
    cfg, tree, make_port = quant_dit(family)
    qtree = jax.tree.map(np.asarray, JQ.quantize_transformer_params(tree, modulation=modulation, mode=mode))
    return cfg, qtree, make_port(qtree)


@pytest.mark.parametrize("family", ["cogvideox", "wan", "hunyuan"])
def test_adapters_over_a_quantized_base_match_jax_layout(family):
    """``init_lora_params`` over ``lora_base`` of a quantized DiT adapts the linears ``alg_tpu``'s adapts over
    the quantized tree, at the same shapes; the adapters attach and a merge raises."""
    cfg, qtree, model = _quantized(family)
    prefixes = TL.FAMILY_PEFT[family][0]
    base = TL.lora_base(model)
    assert TL.has_quantized_kernels(base) and TL.has_quantized_kernels({"blocks.attn.to_q.kernel_q4": None})
    assert not TL.has_quantized_kernels(dict(model.named_parameters()))
    want = JT.init_lora_params(jax.random.PRNGKey(0), qtree, rank=4, prefixes=prefixes)
    got = TL.init_lora_params(torch.Generator().manual_seed(0), base, rank=4, prefixes=prefixes)
    assert {p: {k: tuple(v.shape) for k, v in ab.items()} for p, ab in got.items()} == \
        {p: {k: tuple(v.shape) for k, v in ab.items()} for p, ab in want.items()}
    attached = TL.attach_lora(base, got)
    assert any(name.endswith(".lora_A") and name[:-len(".lora_A")] + ".weight_q" in base for name in attached)
    with pytest.raises(ValueError, match="attach"):
        TL.apply_lora(base, got)


@pytest.mark.parametrize("family", ["cogvideox", "wan", "hunyuan"])
def test_qlora_steps_match_jax(family, monkeypatch):
    """Three steps of AdamW with clip and decay over the frozen quantized base, from the same adapters (B off
    zero): loss rtol 1e-5, grad_norm rtol 1e-4, adapters atol 1e-5; the base takes no gradient and does not
    move. AdamW's eps is phase E2's 1e-4: with 1e-6 an adapter element whose gradient is near zero turns the
    fp32 summation noise of its gradient into a step of the learning rate's size: on the CPU at these widths the
    unquantized LoRA step's adapters differed from ``alg_tpu``'s by 2.7e-5 to 3.1e-4 so."""
    cfg, qtree, model = _quantized(family)
    jloss_fn, tloss_fn = _losses(family, cfg, model)
    prefixes = TL.FAMILY_PEFT[family][0]
    jloras = jax.tree.map(lambda x: np.asarray(x) + np.float32(0.03),
                          JT.init_lora_params(jax.random.PRNGKey(5), qtree, rank=4, prefixes=prefixes))
    tc = dict(learning_rate=1e-2, weight_decay=0.1, grad_clip=0.05, eps=1e-4)
    batches = [_batch(family, cfg, s) for s in range(3)]
    keys = [jax.random.fold_in(jax.random.PRNGKey(11), i) for i in range(3)]

    teacher = QuantTeacher(monkeypatch)
    # the base as a call argument, as alg_tpu's train_cli passes it (a closed-over tree compiles in as constants)
    assert JT.has_quantized_kernels(qtree)
    jloss = JT.make_lora_loss(jloss_fn, None, attach=True)
    jstep, jopt = JT.make_train_step(jloss, JT.TrainConfig(**tc))
    jstep = jax.jit(jstep)
    jbase, jparams = jax.tree.map(jnp.asarray, qtree), jax.tree.map(jnp.asarray, jloras)
    jstate, jlosses = jopt.init(jparams), []
    for batch, key in zip(batches, keys):
        jparams, jstate, m = jstep(jparams, jstate, {k: jnp.asarray(v) for k, v in batch.items()}, key, jbase)
        jlosses.append((float(m["loss"]), float(m["grad_norm"])))

    base = TL.lora_base(model)
    before = {n: t.clone() for n, t in base.items()}
    loss = TL.make_lora_loss(tloss_fn, base, attach=None)
    step, opt = TT.make_train_step(loss, TT.TrainConfig(**tc))
    loras = load_jax_lora(jloras)
    state = opt.init(loras)
    for i, (batch, key) in enumerate(zip(batches, keys)):
        with teacher.feeding():
            loras, state, m = step(loras, state, {k: torch.from_numpy(v) for k, v in batch.items()},
                                   _draws(family, key, batch["latents"].shape))
        np.testing.assert_allclose(float(m["loss"]), jlosses[i][0], rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(m["grad_norm"]), jlosses[i][1], rtol=1e-4)
    teacher.check()
    for path, ab in jax.tree.map(np.asarray, jparams).items():
        for name in ("A", "B"):
            np.testing.assert_allclose(loras[path][name].detach().numpy(), ab[name], atol=ATOL, err_msg=f"{path}/{name}")
    assert all(torch.equal(t, before[n]) and t.grad is None for n, t in base.items())
    assert any(isinstance(m, QuantizedLinear) and m.mode == QLORA[family][0] for m in model.modules())


# -- train_cli ------------------------------------------------------------------------


def _args(tmp_path, *extra):
    return train_cli.make_parser().parse_args([
        "--config", "unused.yaml", "--device", "cpu", "--output", str(tmp_path / "out.npz"), "--lr", "1e-2",
        "--log_every", "100", "--rank", "2", *extra])


@pytest.fixture(scope="module")
def quant_ckpts(tmp_path_factory):
    from alg_tpu_torch.io import hf_checkpoint as H

    root = tmp_path_factory.mktemp("qlora_ckpts")
    cog = {**H.TINY_COGVIDEOX, "transformer": {**H.TINY_COGVIDEOX["transformer"], "num_attention_heads": 2,
                                                "attention_head_dim": 64, "time_embed_dim": 128}}
    hy = {**H.TINY_HUNYUAN, "transformer": {**H.TINY_HUNYUAN["transformer"], "attention_head_dim": 64,
                                             "rope_axes_dim": [16, 24, 24]}}
    H.write_cogvideox(str(root / "QuantCogVideoX"), cog, dtype=torch.float32)
    H.write_hunyuan(str(root / "QuantHunyuanVideo"), hy, dtype=torch.float32)
    return {"cogvideox": str(root / "QuantCogVideoX"), "hunyuan": str(root / "QuantHunyuanVideo")}


@pytest.mark.parametrize("family,mode", [("cogvideox", "w4"), ("hunyuan", "w8")])
def test_train_cli_quantize_over_a_checkpoint(family, mode, quant_ckpts, tmp_path):
    """``train_cli.run --quantize`` over a checkpoint directory: the DiT loads with its block linears quantized
    (no modulation linear), two LoRA steps move every adapter, the peft export is written, and the base does not
    move; the loaded module is ``load_transformer(quantize=...)``'s bit for bit."""
    from alg_tpu_torch.io import model_zoo

    config = {"model": {"path": quant_ckpts[family], "dtype": "float32"},
              "generation": {"height": 32, "width": 32, "num_frames": 5, "max_sequence_length": 8}}
    seen = []
    load = model_zoo.load_transformer

    def keep(*a, **kw):
        seen.append(load(*a, **kw))
        return seen[-1]

    model_zoo.load_transformer = keep
    try:
        out = train_cli.run(config, _args(tmp_path, "--synthetic", "2", "--steps", "2", "--quantize", mode))
    finally:
        model_zoo.load_transformer = load
    dit = seen[0]
    quantized = [n for n, m in dit.named_modules() if isinstance(m, QuantizedLinear)]
    assert quantized and not any("norm" in n for n in quantized)
    assert out["steps"] == 2 and np.isfinite(out["losses"]).all()
    assert all(bool(ab["B"].abs().max() > 0) for ab in out["trainable"].values())
    assert os.path.getsize(tmp_path / "out.npz") > 0
    again = load(quant_ckpts[family], family, dtype=torch.float32, quantize=mode, device="cpu").state_dict()
    assert all(torch.equal(t, again[n]) for n, t in dit.state_dict().items())


def test_random_init_quantizes_block_by_block(monkeypatch):
    """``random_init_transformer(..., quantize=)`` builds each block and quantizes it before the next: the
    modules are those ``quantize_transformer_`` makes of the same config (HunyuanVideo's modulation linears
    quantized too), and no bf16 block stack exists whole on the way."""
    from alg_tpu_torch.models.hunyuan import transformer as HT

    small = HT.HunyuanVideoTransformerConfig(in_channels=4, out_channels=4, num_attention_heads=2,
                                             attention_head_dim=64, num_layers=2, num_single_layers=2,
                                             num_refiner_layers=1, mlp_ratio=2.5, text_embed_dim=16,
                                             pooled_projection_dim=8, rope_axes_dim=(16, 24, 24))
    monkeypatch.setattr(HT, "HunyuanVideoTransformerConfig", lambda: small)
    built = []
    quantize = Q._quantize_linears_

    def watch(container, mode, modulation):  # what exists in bf16 when a block is quantized
        built.append(sum(isinstance(m, torch.nn.Linear) for m in container.modules()))
        return quantize(container, mode, modulation)

    monkeypatch.setattr(Q, "_quantize_linears_", watch)
    model = train_cli.random_init_transformer("hunyuan", torch.bfloat16, torch.device("cpu"), 0, "w4")
    assert len(built) == small.num_layers + small.num_single_layers  # once a block
    want = Q.quantize_transformer_(HT.HunyuanVideoTransformer(small, dtype=torch.bfloat16), "w4", modulation=True)
    kinds = {n: (type(m).__name__, getattr(m, "mode", None)) for n, m in model.named_modules()}
    assert kinds == {n: (type(m).__name__, getattr(m, "mode", None)) for n, m in want.named_modules()}
    assert any("norm" in n and k[0] == "QuantizedLinear" for n, k in kinds.items())
    assert all(p.device.type == "cpu" and p.dtype in (torch.bfloat16,) for p in model.parameters())


def test_quantize_requires_lora_mode(tmp_path):
    """``alg_tpu/train_cli.py``'s parser error."""
    with pytest.raises(SystemExit):
        train_cli.run({"model": {"path": "THUDM/CogVideoX-5b-I2V"}},
                      _args(tmp_path, "--synthetic", "1", "--quantize", "w8", "--mode", "full"))
