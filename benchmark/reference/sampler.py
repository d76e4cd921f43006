"""One denoise step of the CogVideoX I2V sampler with ALG, in plain float32 PyTorch.

- The condition (diffusers ``CogVideoXImageToVideoPipeline.prepare_latents``):
  the VAE posterior sample ``mean + exp(logvar / 2)·eps`` of the conditioning
  frame, times the VAE's scaling factor (divided by it under
  ``invert_scale_latents``), zero-padded to the latent frame count, which
  CogVideoX-1.5 first rounds up to a whole temporal patch.
- ALG (``lp_utils``): the step's strength from the interval schedule, the
  ``down_up`` filter's resize factor ``1 - (1 - f)·strength``, an antialiased
  bilinear resize of each latent frame to ``round(size·f)`` and back.
- CFG: 3 passes ``[uncond(clean), uncond(filtered), text(filtered)]`` combined
  as ``uncond_init + g·(text - uncond)`` where the strength is nonzero,
  else 2 passes ``[uncond(filtered), text(filtered)]``.
- DDIM (``CogVideoXDDIMScheduler``, eta 0, v-prediction): SNR-shifted,
  zero-terminal-SNR ``alphas_cumprod``, trailing timesteps,
  ``prev = a_t·x + b_t·x0`` with ``x0 = sqrt(ā_t)·x - sqrt(1 - ā_t)·v``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import dit, vae


def alphas_cumprod(sched: dict) -> np.ndarray:
    t = sched["num_train_timesteps"]
    betas = np.linspace(sched["beta_start"] ** 0.5, sched["beta_end"] ** 0.5, t, dtype=np.float64) ** 2
    ac = np.cumprod(1.0 - betas)
    s = sched["snr_shift_scale"]
    ac = ac / (s + (1.0 - s) * ac)
    if sched["rescale_betas_zero_snr"]:
        root = np.sqrt(ac)
        r0, rt = root[0], root[-1]
        ac = ((root - rt) * (r0 / (r0 - rt))) ** 2
    return ac


def ddim_coefficients(sched: dict, num_steps: int, i: int):
    """(timestep, a_t, b_t, sqrt(ā_t), sqrt(1 - ā_t)) of step ``i`` (trailing spacing, eta 0)."""
    if sched["timestep_spacing"] != "trailing" or sched["prediction_type"] != "v_prediction":
        raise ValueError("the reference implements trailing timesteps and v-prediction only")
    t_train = sched["num_train_timesteps"]
    ts = np.round(np.arange(t_train, 0, -t_train / num_steps)).astype(np.int64) - 1
    ac = alphas_cumprod(sched)
    t = int(ts[i])
    prev = t - t_train // num_steps
    a_now = ac[t]
    a_prev = ac[prev] if prev >= 0 else (1.0 if sched["set_alpha_to_one"] else ac[0])
    a_t = np.sqrt((1.0 - a_prev) / (1.0 - a_now))
    b_t = np.sqrt(a_prev) - np.sqrt(a_now) * a_t
    return t, float(a_t), float(b_t), float(np.sqrt(a_now)), float(np.sqrt(1.0 - a_now))


def lp_strength(i: int, num_steps: int, alg: dict) -> float:
    if not alg.get("use_low_pass_guidance", False):
        return 0.0
    if alg["lp_strength_schedule_type"] != "interval" or alg["lp_filter_type"] != "down_up":
        raise ValueError("the reference implements the interval schedule and the down_up filter only")
    step_norm = i / max(num_steps - 1, 1)
    inside = alg["schedule_interval_start_time"] <= step_norm <= alg["schedule_interval_end_time"]
    return 1.0 if inside else 0.0


def down_up(latents: torch.Tensor, factor: float) -> torch.Tensor:
    """Each frame of ``[B, F, C, h, w]`` resized to ``max(1, round(size·factor))`` and back
    (bilinear, ``align_corners=False``, ``antialias=True``); the identity at factor 1."""
    if factor == 1.0:
        return latents
    b, f, c, h, w = latents.shape
    x = latents.reshape(b * f, c, h, w)
    small = (max(1, round(h * factor)), max(1, round(w * factor)))
    x = F.interpolate(x, size=small, mode="bilinear", align_corners=False, antialias=True)
    x = F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False, antialias=True)
    return x.reshape(b, f, c, h, w)


def latent_frames(num_frames: int, vae_cfg: dict, dit_cfg: dict) -> int:
    n = (num_frames - 1) // vae_cfg["temporal_compression_ratio"] + 1
    pt = dit_cfg.get("patch_size_t")
    return n + (pt - n % pt) % pt if pt else n


@torch.no_grad()
def image_latents(vae_w, vae_cfg: dict, image: torch.Tensor, eps: torch.Tensor, frames: int) -> torch.Tensor:
    """``image`` ``[1, 3, H, W]``, ``eps`` ``[1, C, 1, h, w]`` -> the condition ``[1, frames, C, h, w]``."""
    mean, logvar = vae.encode(vae_w, vae_cfg, image[:, :, None])
    z = mean + torch.exp(0.5 * logvar.clamp(-30.0, 20.0)) * eps.float()
    z = z / vae_cfg["scaling_factor"] if vae_cfg.get("invert_scale_latents") else z * vae_cfg["scaling_factor"]
    z = z.permute(0, 2, 1, 3, 4)
    return torch.cat([z, z.new_zeros((1, frames - z.shape[1]) + tuple(z.shape[2:]))], dim=1)


@torch.no_grad()
def step(dit_w, dit_cfg: dict, sched: dict, traffic: dict, i: int, x: torch.Tensor, cond_clean: torch.Tensor,
         negative: torch.Tensor, prompt: torch.Tensor, lowp: bool = False):
    """Step ``i`` from latents ``x`` ``[1, F, C, h, w]``: returns (the next latents, the guided model
    output ``v``, the factor ``b_t·sqrt(1 - ā_t)`` by which ``v`` enters the update, the list of
    the CFG passes' DiT outputs in the order above). ``lowp``: the DiT's products in float8 (the
    control, ``dit.fp8``)."""
    n = traffic["num_inference_steps"]
    alg = traffic.get("alg", {})
    g = float(traffic["guidance_scale"])
    strength = lp_strength(i, n, alg)
    factor = 1.0 - (1.0 - alg.get("lp_resize_factor", 1.0)) * strength
    cond = down_up(cond_clean, factor)
    t, a_t, b_t, sa, sb = ddim_coefficients(sched, n, i)
    ofs = 2.0 if dit_cfg.get("ofs_embed_dim") is not None else None

    def model(c, text):
        return dit.forward(dit_w, dit_cfg, torch.cat([x, c], dim=2), text, t, ofs, lowp=lowp)

    if strength != 0.0:
        passes = [model(cond_clean, negative), model(cond, negative), model(cond, prompt)]
        v = passes[0] + g * (passes[2] - passes[1])
    else:
        passes = [model(cond, negative), model(cond, prompt)]
        v = passes[0] + g * (passes[1] - passes[0])
    x0 = sa * x - sb * v
    return a_t * x + b_t * x0, v, b_t * sb, passes
