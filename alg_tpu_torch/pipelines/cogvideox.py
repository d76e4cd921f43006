"""CogVideoX-I2V sampler with adaptive low-pass guidance (counterpart of
``alg_tpu/pipelines/cogvideox.py``).

Same semantics as the reference ``CogVideoXImageToVideoPipeline``: T5 prompt
encoding without a mask, VAE encode of the conditioning frame with a
torch-ordered posterior draw, zero-padded image latents, and a Python loop
over the denoise steps. CFG runs 3 passes on steps where ALG is active
(``[uncond(clean image), uncond(filtered), text(filtered)]``) and 2 passes
on the others, conditioning on the low-pass-filtered image latents; the
filter is one separable operator pair per step from the run's plan. DDIM
steps at η = 0. The decoded video is assembled from overlapping VAE tiles.

Draw order follows the reference: the VAE posterior noise (``[B, C, F, h,
w]``), then the initial latents, from one CPU ``torch.Generator``.

Not ported yet (queued in ROADMAP.md): DPM, η > 0, dynamic CFG, pixel-space
ALG, ``patch_size_t``/ofs (CogVideoX-1.5), the step cache, checkpoints and
step observers.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from alg_tpu_torch.alg.matrices import apply_filter_matrices
from alg_tpu_torch.alg.schedule import LPConfig, LPPlan, build_lp_plan
from alg_tpu_torch.core.rng import NoiseSource
from alg_tpu_torch.models.cogvideox.transformer import CogVideoXTransformer, cogvideox_rope
from alg_tpu_torch.models.cogvideox.vae import CogVideoXVAE
from alg_tpu_torch.models.t5 import T5Encoder
from alg_tpu_torch.models.vae_tiling import auto_tile_encode, tiled_decode, tiled_encode
from alg_tpu_torch.pipelines import processing
from alg_tpu_torch.schedulers.ddim_cogvideox import CogVideoXDDIMConfig, CogVideoXDDIMPlan, ddim_step, make_ddim_plan


@dataclasses.dataclass
class CogVideoXPipeline:
    """Modules on ``device`` plus the tokenizer hook.

    ``tokenize``: ``(prompts, max_len) -> int [B, max_len]`` token ids (the
    T5 tokenizer with max-length padding and truncation), injected so the
    pipeline needs no tokenizer files. ``dtype`` is the DiT's activation
    dtype; the VAE runs in the dtype of its own weights."""

    transformer: CogVideoXTransformer
    vae: CogVideoXVAE
    t5: Optional[T5Encoder] = None
    tokenize: Optional[Callable] = None
    scheduler_cfg: CogVideoXDDIMConfig = dataclasses.field(default_factory=CogVideoXDDIMConfig)
    dtype: torch.dtype = torch.float32
    device: Union[str, torch.device] = "cpu"

    @property
    def vae_dtype(self) -> torch.dtype:
        return next(self.vae.parameters()).dtype

    # -- encoders ------------------------------------------------------------

    @torch.no_grad()
    def encode_prompt(self, prompt: Union[str, Sequence[str]], max_sequence_length: int = 226) -> torch.Tensor:
        """T5 encode without an attention mask -> ``[B, S, d_model]`` in ``dtype``."""
        if self.tokenize is None or self.t5 is None:
            raise ValueError("No tokenizer or T5 encoder; pass prompt_embeds instead")
        prompts = [prompt] if isinstance(prompt, str) else list(prompt)
        ids = torch.as_tensor(np.asarray(self.tokenize(prompts, max_sequence_length)), dtype=torch.long)
        return self.t5(ids.to(self.device)).to(self.dtype)

    @torch.no_grad()
    def vae_encode_sample(self, image_bfchw: np.ndarray, noise: NoiseSource) -> torch.Tensor:
        """VAE-encode ``[B, F, C, H, W]`` pixels and draw the posterior sample
        with torch-ordered noise; returns latents ``[B, F', C, h, w]`` fp32."""
        x = torch.as_tensor(image_bfchw, dtype=self.vae_dtype).to(self.device).permute(0, 1, 3, 4, 2)
        if auto_tile_encode(x.shape[1], x.shape[2], x.shape[3]):
            mean, logvar = tiled_encode(self.vae.encode, x, self.vae.cfg.spatial_scale)
        else:
            mean, logvar = self.vae.encode(x)
        mean, logvar = mean.float(), logvar.float()
        b, f, h, w, c = mean.shape
        eps = noise.randn((b, c, f, h, w)).to(self.device).permute(0, 2, 3, 4, 1)
        z = mean + torch.exp(0.5 * logvar.clamp(-30.0, 20.0)) * eps
        return z.permute(0, 1, 4, 2, 3)

    @torch.no_grad()
    def decode_latents(self, latents: torch.Tensor) -> torch.Tensor:
        """``[B, F, C, h, w]`` -> ``[B, F_pix, C, H, W]`` fp32 in [-1, 1],
        through overlapping tiles once the latent exceeds 48 x 48."""
        z = (latents.float() / self.vae.cfg.scaling_factor).permute(0, 1, 3, 4, 2).to(self.vae_dtype)
        if z.shape[2] * z.shape[3] > 48 * 48:
            frames = tiled_decode(self.vae.decode, z, self.vae.cfg.spatial_scale)
        else:
            frames = self.vae.decode(z)
        return frames.permute(0, 1, 4, 2, 3).float()

    # -- main entry ----------------------------------------------------------

    @torch.no_grad()
    def __call__(
        self,
        image=None,
        prompt: Optional[Union[str, Sequence[str]]] = None,
        negative_prompt: Optional[Union[str, Sequence[str]]] = None,
        height: Optional[int] = None,
        width: Optional[int] = None,
        num_frames: Optional[int] = None,
        num_inference_steps: int = 50,
        guidance_scale: float = 6.0,
        seed: int = 42,
        noise_source: Optional[NoiseSource] = None,
        latents: Optional[np.ndarray] = None,
        prompt_embeds: Optional[torch.Tensor] = None,
        negative_prompt_embeds: Optional[torch.Tensor] = None,
        max_sequence_length: int = 226,
        output_type: str = "np",
        use_low_pass_guidance: bool = False,
        lp_filter_type: str = "none",
        lp_filter_in_latent: bool = True,
        lp_blur_sigma: float = 3.0,
        lp_blur_kernel_size=0.1,
        lp_resize_factor: float = 0.25,
        lp_strength_schedule_type: str = "none",
        schedule_blur_kernel_size: bool = False,
        schedule_interval_start_time: float = 0.0,
        schedule_interval_end_time: float = 1.0,
        schedule_linear_start_weight: float = 1.0,
        schedule_linear_end_weight: float = 0.0,
        schedule_linear_end_time: float = 1.0,
        schedule_exp_decay_rate: float = 5.0,
    ):
        """Generate a video; returns ``np`` frames ``[B, F, H, W, 3]`` in
        [0, 1] or the final ``latent`` ``[B, F, C, h, w]``."""
        tcfg, vcfg = self.transformer.cfg, self.vae.cfg
        scale_s = vcfg.spatial_scale
        height = height or tcfg.sample_height * scale_s
        width = width or tcfg.sample_width * scale_s
        num_frames = num_frames or 49
        if height % 8 != 0 or width % 8 != 0:
            raise ValueError(f"height and width must be divisible by 8 but are {height} and {width}.")
        if image is None:
            raise ValueError("Provide an input image (I2V pipelines condition on it).")
        if prompt is None and prompt_embeds is None:
            raise ValueError("Provide prompt or prompt_embeds.")
        if output_type not in ("np", "latent"):
            raise ValueError(f"Unsupported output_type {output_type!r} (the port returns 'np' or 'latent')")
        do_cfg = guidance_scale > 1.0
        if use_low_pass_guidance and do_cfg and not lp_filter_in_latent:
            raise NotImplementedError("pixel-space ALG (lp_filter_in_latent=False) is not ported yet")
        noise = noise_source or NoiseSource(seed=seed)

        # prompt embeds, negative first in the CFG batch
        if prompt_embeds is None:
            prompt_embeds = self.encode_prompt(prompt, max_sequence_length)
        if do_cfg and negative_prompt_embeds is None:
            neg = negative_prompt if negative_prompt is not None else ""
            negative_prompt_embeds = self.encode_prompt(
                [neg] * prompt_embeds.shape[0] if isinstance(neg, str) else neg, max_sequence_length)
        batch_size = prompt_embeds.shape[0]
        latent_frames = (num_frames - 1) // vcfg.temporal_compression_ratio + 1

        # image -> VAE posterior sample, scaled, zero-padded to latent_frames
        if not isinstance(image, np.ndarray):
            image = processing.preprocess_image(image, height, width)
        image_vae_in = np.asarray(image, np.float32)
        if image_vae_in.ndim == 4:
            image_vae_in = image_vae_in[:, None]  # [B, 1, C, H, W]
        if image_vae_in.shape[0] < batch_size:
            image_vae_in = np.repeat(image_vae_in, batch_size, axis=0)
        image_latents = vcfg.scaling_factor * self.vae_encode_sample(image_vae_in, noise)
        b, f_img, c_lat, h_lat, w_lat = image_latents.shape
        pad = image_latents.new_zeros((b, latent_frames - f_img, c_lat, h_lat, w_lat))
        image_latents = torch.cat([image_latents, pad], dim=1)

        # initial noise, drawn after the posterior noise
        if latents is None:
            latents0 = noise.randn((batch_size, latent_frames, c_lat, h_lat, w_lat))
        else:
            latents0 = torch.as_tensor(np.asarray(latents, np.float32))
        latents0 = latents0.to(self.device)

        sched_plan = make_ddim_plan(self.scheduler_cfg, num_inference_steps)
        lp_cfg = LPConfig(
            use_low_pass_guidance=use_low_pass_guidance and do_cfg,
            lp_filter_type=lp_filter_type,
            lp_filter_in_latent=lp_filter_in_latent,
            lp_blur_sigma=lp_blur_sigma,
            lp_blur_kernel_size=lp_blur_kernel_size,
            lp_resize_factor=lp_resize_factor,
            lp_strength_schedule_type=lp_strength_schedule_type,
            schedule_blur_kernel_size=schedule_blur_kernel_size,
            schedule_interval_start_time=schedule_interval_start_time,
            schedule_interval_end_time=schedule_interval_end_time,
            schedule_linear_start_weight=schedule_linear_start_weight,
            schedule_linear_end_weight=schedule_linear_end_weight,
            schedule_linear_end_time=schedule_linear_end_time,
            schedule_exp_decay_rate=schedule_exp_decay_rate,
        )
        lp_plan = build_lp_plan(lp_cfg, num_inference_steps, h_lat, w_lat, exp_shortcut=True)

        cos, sin = cogvideox_rope(tcfg, height, width, latent_frames)
        latents_out = self._sample(
            latents0, image_latents, prompt_embeds, negative_prompt_embeds, sched_plan, lp_plan,
            float(np.float32(guidance_scale)), torch.from_numpy(cos).to(self.device),
            torch.from_numpy(sin).to(self.device), do_cfg,
        )
        if output_type == "latent":
            return latents_out.cpu().numpy()
        video = self.decode_latents(latents_out)
        return processing.postprocess_video(video.cpu().numpy())

    # -- sampler -------------------------------------------------------------

    def _dit(self, latent_in, cond_in, embeds, t: int, rope_cos, rope_sin) -> torch.Tensor:
        x = torch.cat([latent_in, cond_in], dim=2).to(self.dtype)
        timestep = torch.full((x.shape[0],), float(t), dtype=torch.float32, device=x.device)
        return self.transformer(x, embeds, timestep, rope_cos, rope_sin).float()

    def _sample(self, latents0, image_latents, prompt_embeds, negative_prompt_embeds,
                sched_plan: CogVideoXDDIMPlan, lp_plan: LPPlan, g: float, rope_cos, rope_sin,
                do_cfg: bool) -> torch.Tensor:
        alg = lp_plan.active
        if do_cfg:
            embeds2 = torch.cat([negative_prompt_embeds, prompt_embeds])
            embeds3 = torch.cat([negative_prompt_embeds, negative_prompt_embeds, prompt_embeds]) if alg else None
        else:
            embeds2, embeds3 = prompt_embeds, None
        if alg:
            m_h = torch.from_numpy(lp_plan.m_h).to(self.device)
            m_w = torch.from_numpy(lp_plan.m_w).to(self.device)

        latents = latents0
        for seg in lp_plan.segments:
            three_pass = seg.three_pass and do_cfg and alg
            for i in range(seg.start, seg.stop):
                t = int(sched_plan.timesteps[i])
                cond = image_latents
                if alg:
                    j = int(lp_plan.m_idx[i])
                    cond = apply_filter_matrices(image_latents, m_h[j], m_w[j])
                if not do_cfg:
                    noise_pred = self._dit(latents, cond, embeds2, t, rope_cos, rope_sin)
                elif three_pass:
                    pred = self._dit(torch.cat([latents] * 3), torch.cat([image_latents, cond, cond]),
                                     embeds3, t, rope_cos, rope_sin)
                    uncond_init, uncond, text = pred.chunk(3)
                    noise_pred = uncond_init + g * (text - uncond)
                else:
                    pred = self._dit(torch.cat([latents] * 2), torch.cat([cond, cond]), embeds2, t,
                                     rope_cos, rope_sin)
                    uncond, text = pred.chunk(2)
                    noise_pred = uncond + g * (text - uncond)
                latents = ddim_step(sched_plan, i, noise_pred, latents)
        return latents
