"""Training objectives for the three DiT families (counterpart of
``alg_tpu/training/losses.py``).

* CogVideoX trains with v-prediction under its SNR-shifted, zero-terminal-SNR
  DDIM schedule: ``x_t = √ā·x₀ + √(1−ā)·ε``, target ``v = √ā·ε − √(1−ā)·x₀``.
* Wan and HunyuanVideo train with flow matching: ``x_t = (1−σ)·x₀ + σ·ε``,
  target ``ε − x₀``, with their samplers' timestep shift
  (``σ' = s·σ / (1 + (s−1)·σ)``) and logit-normal or uniform σ.

Batches are dicts of latent-space tensors; model-input assembly mirrors the
pipelines (CogVideoX: channel concat with the image latents on axis 2 of
``[B, F, C, H, W]``; Wan: channel concat with the 20-channel condition on axis
1; Hunyuan token_replace: the clean image latent as frame 0, which is left
out of the loss).

Where the JAX package's losses take a PRNG key and draw inside, these are
split in two, since the two frameworks cannot draw the same numbers: each
``make_*`` returns ``loss(params, batch, draws)`` with an attribute
``loss.draw(batch, generator) -> draws`` that takes the timestep or σ and the
noise from an explicit ``torch.Generator``. ``params`` maps the DiT's
parameter names (``module.named_parameters()``, plus what
``training.lora.attach_lora`` adds) to tensors; the module itself only lends
its structure, through ``torch.func.functional_call``. ``compute_dtype``
casts floating parameters and model inputs at the loss boundary (fp32
masters, bf16 compute); target and MSE stay fp32.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn


def shift_sigmas(sigmas: torch.Tensor, shift: float) -> torch.Tensor:
    """The samplers' timestep shift: ``σ' = s·σ / (1 + (s−1)·σ)``."""
    return shift * sigmas / (1.0 + (shift - 1.0) * sigmas)


def sample_flow_sigmas(generator: torch.Generator, batch_size: int, shift: float = 1.0,
                       sampling: str = "logit_normal", logit_mean: float = 0.0,
                       logit_std: float = 1.0) -> torch.Tensor:
    """Per-sample σ in (0, 1), fp32 on the generator's device: logit-normal
    (default) or uniform, then shifted like the inference schedule."""
    dev = generator.device
    if sampling == "logit_normal":
        u = torch.sigmoid(torch.randn(batch_size, generator=generator, device=dev) * logit_std + logit_mean)
    elif sampling == "uniform":
        u = torch.rand(batch_size, generator=generator, device=dev) * (1.0 - 2e-5) + 1e-5
    else:
        raise ValueError(f"unknown sigma sampling {sampling!r}")
    return shift_sigmas(u, shift)


def _bcast(x: torch.Tensor, ndim: int) -> torch.Tensor:
    return x.reshape(x.shape + (1,) * (ndim - x.dim()))


def _cast_floats(tree, dtype):
    """Cast the floating tensors of a dict (or one tensor, or None); ``dtype`` None passes through."""
    if dtype is None or tree is None:
        return tree
    if isinstance(tree, dict):
        return {k: _cast_floats(v, dtype) for k, v in tree.items()}
    return tree.to(dtype) if tree.is_floating_point() else tree


def _table(arr, device) -> Optional[torch.Tensor]:
    return None if arr is None else torch.as_tensor(arr, dtype=torch.float32, device=device)


def _noise(generator, x0):
    return torch.randn(x0.shape, generator=generator, device=generator.device).to(x0.device)


def make_cogvideox_vpred_loss(model: nn.Module, alphas_cumprod: Optional[np.ndarray] = None,
                              rope_cos: Optional[np.ndarray] = None, rope_sin: Optional[np.ndarray] = None,
                              num_train_timesteps: int = 1000, compute_dtype: Optional[torch.dtype] = None):
    """``loss(params, batch, draws)`` for CogVideoX v-prediction.

    batch: ``latents`` [B, F, C, H, W] (clean x₀), ``image_latents`` (same
    shape), ``encoder_hidden_states`` [B, S, text_dim]. draws: ``t`` int64
    [B] in [0, num_train_timesteps), ``noise`` fp32 like ``latents``."""
    from alg_tpu_torch.schedulers.ddim_cogvideox import CogVideoXDDIMConfig, make_alphas_cumprod

    if alphas_cumprod is None:
        alphas_cumprod = make_alphas_cumprod(CogVideoXDDIMConfig())
    ac_host = torch.as_tensor(np.asarray(alphas_cumprod), dtype=torch.float32)

    def loss_fn(params, batch, draws):
        x0, cond, embeds = batch["latents"], batch["image_latents"], batch["encoder_hidden_states"]
        t, noise = draws["t"], draws["noise"]
        ac = ac_host.to(x0.device)[t]
        x0f = x0.float()
        sa, sb = _bcast(torch.sqrt(ac), x0.dim()), _bcast(torch.sqrt(1.0 - ac), x0.dim())
        xt = sa * x0f + sb * noise
        target = sa * noise - sb * x0f
        cd = compute_dtype or x0.dtype
        model_in = torch.cat([xt.to(cd), cond.to(cd)], dim=2)
        pred = torch.func.functional_call(model, _cast_floats(params, compute_dtype), (
            model_in, _cast_floats(embeds, compute_dtype), t.float(), _table(rope_cos, x0.device),
            _table(rope_sin, x0.device)))
        return torch.mean((pred.float() - target) ** 2)

    def draw(batch, generator):
        x0 = batch["latents"]
        t = torch.randint(0, num_train_timesteps, (x0.shape[0],), generator=generator, device=generator.device)
        return {"t": t.to(x0.device), "noise": _noise(generator, x0)}

    loss_fn.draw = draw
    return loss_fn


def _flow_draw(shift, sampling):
    def draw(batch, generator):
        x0 = batch["latents"]
        sigma = sample_flow_sigmas(generator, x0.shape[0], shift=shift, sampling=sampling)
        return {"sigma": sigma.to(x0.device), "noise": _noise(generator, x0)}

    return draw


def make_wan_flow_loss(model: nn.Module, shift: float = 5.0, sampling: str = "logit_normal",
                       rope_cos: Optional[np.ndarray] = None, rope_sin: Optional[np.ndarray] = None,
                       compute_dtype: Optional[torch.dtype] = None):
    """``loss(params, batch, draws)`` for Wan flow matching.

    batch: ``latents`` [B, C, F, h, w], ``condition`` [B, 20, F, h, w],
    ``encoder_hidden_states`` [B, 512, text_dim], optional
    ``encoder_hidden_states_image`` [B, 257, image_dim]. draws: ``sigma``
    fp32 [B], ``noise`` fp32 like ``latents``."""

    def loss_fn(params, batch, draws):
        x0, cond, text = batch["latents"], batch["condition"], batch["encoder_hidden_states"]
        img = batch.get("encoder_hidden_states_image")
        sigma, noise = draws["sigma"], draws["noise"]
        x0f = x0.float()
        s = _bcast(sigma, x0.dim())
        xt = (1.0 - s) * x0f + s * noise
        target = noise - x0f
        cd = compute_dtype or x0.dtype
        model_in = torch.cat([xt.to(cd), cond.to(cd)], dim=1)
        pred = torch.func.functional_call(model, _cast_floats(params, compute_dtype), (
            model_in, sigma * 1000.0, _cast_floats(text, compute_dtype), _cast_floats(img, compute_dtype),
            _table(rope_cos, x0.device), _table(rope_sin, x0.device)))
        return torch.mean((pred.float() - target) ** 2)

    loss_fn.draw = _flow_draw(shift, sampling)
    return loss_fn


def make_hunyuan_flow_loss(model: nn.Module, shift: float = 7.0, sampling: str = "logit_normal",
                           guidance_scale: float = 6.0, rope_cos: Optional[np.ndarray] = None,
                           rope_sin: Optional[np.ndarray] = None, compute_dtype: Optional[torch.dtype] = None):
    """``loss(params, batch, draws)`` for HunyuanVideo flow matching.

    batch: ``latents`` [B, C, F, h, w], ``image_latents`` [B, C, 1, h, w],
    ``encoder_hidden_states`` and ``encoder_attention_mask`` (Llava),
    ``pooled_projections`` (CLIP). The guidance-embed model's guidance input
    is the constant ``guidance_scale·1000``. With token_replace conditioning
    frame 0 of the model input is the clean image latent and frame 0 is left
    out of the loss (the sampler pins it again at every step)."""
    cfg = model.cfg
    token_replace = cfg.image_condition_type == "token_replace"

    def loss_fn(params, batch, draws):
        x0, image_latents = batch["latents"], batch["image_latents"]
        text, mask, pooled = batch["encoder_hidden_states"], batch.get("encoder_attention_mask"), \
            batch["pooled_projections"]
        sigma, noise = draws["sigma"], draws["noise"]
        x0f = x0.float()
        s = _bcast(sigma, x0.dim())
        cd = compute_dtype or x0.dtype
        xt = ((1.0 - s) * x0f + s * noise).to(cd)
        target = noise - x0f
        model_in = torch.cat([image_latents.to(cd), xt[:, :, 1:]], dim=2) if token_replace else xt
        guidance = None
        if cfg.guidance_embeds:
            guidance = torch.full((x0.shape[0],), guidance_scale * 1000.0, dtype=torch.float32, device=x0.device)
        pred = torch.func.functional_call(model, _cast_floats(params, compute_dtype), (
            model_in, sigma * 1000.0, _cast_floats(text, compute_dtype), mask, _cast_floats(pooled, compute_dtype)),
            dict(guidance=guidance, rope_cos=_table(rope_cos, x0.device), rope_sin=_table(rope_sin, x0.device)))
        err = (pred.float() - target) ** 2
        if token_replace:
            err = err[:, :, 1:]  # frame 0 carries no learning signal
        return torch.mean(err)

    loss_fn.draw = _flow_draw(shift, sampling)
    return loss_fn
