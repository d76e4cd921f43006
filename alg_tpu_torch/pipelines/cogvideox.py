"""CogVideoX-I2V sampler with adaptive low-pass guidance (counterpart of
``alg_tpu/pipelines/cogvideox.py``).

Same semantics as the reference ``CogVideoXImageToVideoPipeline``: T5 prompt
encoding without a mask, VAE encode of the conditioning frame with a
torch-ordered posterior draw, zero-padded image latents, and a Python loop
over the denoise steps. CFG runs 3 passes on steps where ALG is active
(``[uncond(clean image), uncond(filtered), text(filtered)]``) and 2 passes
on the others, conditioning on the low-pass-filtered image latents (the
2-pass steps too: the reference's modulated filter, identity at strength 0);
the filter is one separable operator pair per step from the run's plan.
With ``lp_filter_in_latent=False`` (pixel-space ALG) each step filters the
preprocessed RGB frame instead and VAE-encodes it again, with that step's
own posterior draw. DDIM (η = 0 or stochastic, custom ``timesteps``) or the
SDE-DPM++ scheduler (``scheduler="dpm"``); optional dynamic CFG. The decoded
video is assembled from overlapping VAE tiles.

Draw order follows the reference, from one CPU ``torch.Generator``: the VAE
posterior noise (``[B, C, F, h, w]``), the initial latents, the per-step
pixel-space posterior noise (``[B, C, 1, h, w]`` each), then the per-step
scheduler noise (DPM, or DDIM at η > 0). Each stack is drawn whole before
the loop: a resumed run redraws it and finds the same values.

Run control (``pipelines/denoise.py``): ``interrupt``, a ``step_observer``
that may replace the latents, snapshots through ``checkpoint=`` and the
opt-in step cache (``cache_interval > 1``: steps it skips launch no DiT).

CogVideoX-1.5 (a DiT with ``patch_size_t``): the latent frames are padded up
to a multiple of ``patch_size_t`` (the noise, the image latents and every
snapshot hold the padded count), the DiT gets ``ofs = 2.0``, and the padded
frames are dropped before the decode, so the video has the frames asked for.
A VAE with ``invert_scale_latents`` divides the image latents by its scaling
factor instead of multiplying. A DiT without RoPE gets no tables.

Under a recording profiler (``utils/profiling.py``) a call is a
``pipeline.request`` span (family, batch rows, frames, height, width,
steps) whose ``pipeline.prepare`` part holds the frame's ``vae.encode``;
a step's prediction holds ``alg.filter``, ``dit.forward`` (its passes and
text and video tokens) and ``cfg.combine``; the decode is ``vae.decode``.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable, Optional, Sequence, Union

import numpy as np
import torch

from alg_tpu_torch.alg.matrices import apply_filter_matrices
from alg_tpu_torch.alg.schedule import LPPlan, lp_config, request_plan
from alg_tpu_torch.core.rng import NoiseSource
from alg_tpu_torch.io.runstate import as_checkpoint, run_fingerprint
from alg_tpu_torch.models.cogvideox.transformer import CogVideoXTransformer, cogvideox_rope
from alg_tpu_torch.models.cogvideox.vae import CogVideoXVAE
from alg_tpu_torch.models.t5 import T5Encoder
from alg_tpu_torch.models.vae_tiling import auto_tile_encode, tiled_encode, vae_decode
from alg_tpu_torch.ops.attention import pipeline_mesh_scope
from alg_tpu_torch.pipelines import processing
from alg_tpu_torch.pipelines.denoise import Guidance, check_cache_interval, denoise_loop
from alg_tpu_torch.schedulers.ddim_cogvideox import CogVideoXDDIMConfig, ddim_step, make_ddim_plan
from alg_tpu_torch.schedulers.dpm_cogvideox import dpm_step, make_dpm_plan
from alg_tpu_torch.utils import profiling
from alg_tpu_torch.utils.profiling import span


@dataclasses.dataclass
class CogVideoXPipeline:
    """Modules on ``device`` plus the tokenizer hook.

    ``tokenize``: ``(prompts, max_len) -> int [B, max_len]`` token ids (the
    T5 tokenizer with max-length padding and truncation), injected so the
    pipeline needs no tokenizer files. ``scheduler``: ``"ddim"`` or
    ``"dpm"``. ``dtype`` is the DiT's activation dtype; the VAE runs in the
    dtype of its own weights. ``vae_encode_tiling``: True or False forces
    tiled or whole VAE encoding; None tiles only clips large enough to be a
    memory risk (``models/vae_tiling.auto_tile_encode``), so never the one
    conditioning frame. ``interrupt``: set it (from a ``step_observer`` or
    another thread) to stop the run after the current step; each call
    resets it."""

    transformer: CogVideoXTransformer
    vae: CogVideoXVAE
    t5: Optional[T5Encoder] = None
    tokenize: Optional[Callable] = None
    scheduler: str = "ddim"
    scheduler_cfg: CogVideoXDDIMConfig = dataclasses.field(default_factory=CogVideoXDDIMConfig)
    dtype: torch.dtype = torch.float32
    device: Union[str, torch.device] = "cuda"
    vae_encode_tiling: Optional[bool] = None
    # the DiT's device mesh (set by serving.shard_pipeline over a DiT from
    # sharding.partition.shard_transformer) and the sequence-parallel mode on its sp axis
    attn_mesh: Any = dataclasses.field(default=None, compare=False)
    sp_mode: str = "gather"
    interrupt: bool = dataclasses.field(default=False, compare=False)
    fusing_transformer: bool = dataclasses.field(default=False, compare=False)

    @property
    def vae_dtype(self) -> torch.dtype:
        return next(self.vae.parameters()).dtype

    def fuse_qkv_projections(self) -> None:
        """The reference pipeline's public QKV fusion switch, which scripts
        written against that pipeline call, kept as a flag that changes
        nothing: q, k and v stay three linears, as in ``alg_tpu``."""
        self.fusing_transformer = True

    def unfuse_qkv_projections(self) -> None:
        """Clear the flag; warns, as the reference does, when it was not set."""
        if not self.fusing_transformer:
            logging.getLogger(__name__).warning(
                "The Transformer was not initially fused for QKV projections. Doing nothing.")
        else:
            self.fusing_transformer = False

    def _scale_latents(self, z: torch.Tensor) -> torch.Tensor:
        """Encoded latents into the DiT's range: times the scaling factor, or
        divided by it under ``invert_scale_latents`` (CogVideoX-1.5)."""
        vcfg = self.vae.cfg
        return z / vcfg.scaling_factor if vcfg.invert_scale_latents else z * vcfg.scaling_factor

    # -- encoders ------------------------------------------------------------

    @torch.no_grad()
    def encode_prompt(self, prompt: Union[str, Sequence[str]], max_sequence_length: int = 226) -> torch.Tensor:
        """T5 encode without an attention mask -> ``[B, S, d_model]`` in ``dtype``."""
        if self.tokenize is None or self.t5 is None:
            raise ValueError("No tokenizer or T5 encoder; pass prompt_embeds instead")
        prompts = [prompt] if isinstance(prompt, str) else list(prompt)
        ids = torch.as_tensor(np.asarray(self.tokenize(prompts, max_sequence_length)), dtype=torch.long)
        return self.t5(ids.to(self.device)).to(self.dtype)

    def _encode_moments(self, x_bfchw: torch.Tensor):
        """VAE-encode ``[B, F, C, H, W]`` pixels on the device -> fp32 (mean,
        logvar), each ``[B, F', h, w, C]``."""
        x = x_bfchw.to(self.vae_dtype).permute(0, 1, 3, 4, 2)
        if auto_tile_encode(x.shape[1], x.shape[2], x.shape[3], self.vae_encode_tiling):
            mean, logvar = tiled_encode(self.vae.encode, x, self.vae.cfg.spatial_scale)
        else:
            mean, logvar = self.vae.encode(x)
        return mean.float(), logvar.float()

    @staticmethod
    def _posterior_sample(mean: torch.Tensor, logvar: torch.Tensor, eps_bcfhw: torch.Tensor) -> torch.Tensor:
        """``mean + std·eps`` with the noise drawn in torch's ``[B, C, F, h, w]``
        order; returns ``[B, F, C, h, w]``."""
        z = mean + torch.exp(0.5 * logvar.clamp(-30.0, 20.0)) * eps_bcfhw.to(mean.device).permute(0, 2, 3, 4, 1)
        return z.permute(0, 1, 4, 2, 3)

    @torch.no_grad()
    def vae_encode_sample(self, image_bfchw: np.ndarray, noise: NoiseSource) -> torch.Tensor:
        """VAE-encode ``[B, F, C, H, W]`` pixels and draw the posterior sample
        with torch-ordered noise; returns latents ``[B, F', C, h, w]`` fp32."""
        with span("vae.encode", frames=image_bfchw.shape[1], h=image_bfchw.shape[3], w=image_bfchw.shape[4]):
            mean, logvar = self._encode_moments(torch.as_tensor(image_bfchw, dtype=torch.float32).to(self.device))
            b, f, h, w, c = mean.shape
            return self._posterior_sample(mean, logvar, noise.randn((b, c, f, h, w)))

    @torch.no_grad()
    def decode_latents(self, latents: torch.Tensor, vae_tiling: Optional[bool] = None, mesh=None) -> torch.Tensor:
        """``[B, F, C, h, w]`` -> ``[B, F_pix, C, H, W]`` fp32 in [-1, 1]
        (divided by the scaling factor, with or without
        ``invert_scale_latents``, as the reference decodes). ``vae_tiling``:
        True or False forces overlapping tiles or one whole decode; None
        tiles once the latent exceeds 48 x 48. ``mesh`` (by default the
        pipeline's ``attn_mesh``) spreads the tiles over its ranks."""
        z = (latents.float() / self.vae.cfg.scaling_factor).permute(0, 1, 3, 4, 2).to(self.vae_dtype)
        frames = vae_decode(self.vae, z, vae_tiling, self.attn_mesh if mesh is None else mesh)
        return frames.permute(0, 1, 4, 2, 3).float()

    # -- main entry ----------------------------------------------------------

    @torch.no_grad()
    @profiling.request_span("cogvideox")
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
        use_dynamic_cfg: bool = False,
        eta: float = 0.0,
        seed: int = 42,
        noise_source: Optional[NoiseSource] = None,
        latents: Optional[np.ndarray] = None,
        prompt_embeds: Optional[torch.Tensor] = None,
        negative_prompt_embeds: Optional[torch.Tensor] = None,
        timesteps=None,
        max_sequence_length: int = 226,
        output_type: str = "np",
        attention_kwargs: Optional[dict] = None,
        step_observer: Optional[Callable] = None,
        checkpoint=None,
        checkpoint_every: int = 8,
        cache_interval: int = 1,
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
        [0, 1], ``pil`` frame lists or the final ``latent`` ``[B, F, C, h, w]``.

        ``checkpoint``: a path (or ``io.runstate.RunCheckpoint``) where the
        loop's carry is saved every ``checkpoint_every`` steps; a snapshot
        of a call with the same arguments resumes there. ``cache_interval``
        > 1: a DiT forward only on every ``cache_interval``-th step, the last
        step and the ALG steps, the previous prediction reused between (an
        approximation; 1 is exact)."""
        self.interrupt = False
        processing.validate_attention_kwargs(attention_kwargs)
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
        if output_type not in ("np", "pil", "latent"):
            raise ValueError(f"Unknown output_type {output_type!r}")
        if self.scheduler not in ("ddim", "dpm"):
            raise ValueError(f"Unknown scheduler {self.scheduler!r}")
        cache_interval = check_cache_interval(cache_interval)
        do_cfg = guidance_scale > 1.0
        noise = noise_source or NoiseSource(seed=seed)
        lp_cfg = lp_config(locals())
        checkpoint = as_checkpoint(checkpoint, run_fingerprint(
            "cogvideox", prompt=prompt, negative_prompt=negative_prompt, seed=seed, height=height, width=width,
            num_frames=num_frames, num_inference_steps=num_inference_steps, guidance_scale=guidance_scale,
            use_dynamic_cfg=use_dynamic_cfg, eta=eta, timesteps=timesteps, scheduler=self.scheduler,
            **({"cache_interval": cache_interval} if cache_interval != 1 else {}), alg=dataclasses.astuple(lp_cfg)),
            checkpoint_every)

        # prompt embeds, negative first in the CFG batch
        if prompt_embeds is None:
            prompt_embeds = self.encode_prompt(prompt, max_sequence_length)
        if do_cfg and negative_prompt_embeds is None:
            neg = negative_prompt if negative_prompt is not None else ""
            negative_prompt_embeds = self.encode_prompt(
                [neg] * prompt_embeds.shape[0] if isinstance(neg, str) else neg, max_sequence_length)
        batch_size = prompt_embeds.shape[0]
        latent_frames = (num_frames - 1) // vcfg.temporal_compression_ratio + 1
        # 1.5: pad the latent frames up to whole temporal patches; the padding is dropped before the decode
        patch_size_t = tcfg.patch_size_t
        additional_frames = 0
        if patch_size_t is not None and latent_frames % patch_size_t != 0:
            additional_frames = patch_size_t - latent_frames % patch_size_t
            latent_frames += additional_frames

        # image -> VAE posterior sample, scaled, zero-padded to latent_frames
        if not isinstance(image, np.ndarray):
            image = processing.preprocess_image(image, height, width)
        image_vae_in = np.asarray(image, np.float32)
        if image_vae_in.ndim == 4:
            image_vae_in = image_vae_in[:, None]  # [B, 1, C, H, W]
        if image_vae_in.shape[0] < batch_size:
            image_vae_in = np.repeat(image_vae_in, batch_size, axis=0)
        image_latents = self._scale_latents(self.vae_encode_sample(image_vae_in, noise))
        b, f_img, c_lat, h_lat, w_lat = image_latents.shape
        pad = image_latents.new_zeros((b, latent_frames - f_img, c_lat, h_lat, w_lat))
        # the reference then front-pads the image latents to whole temporal patches: a no-op here, since
        # latent_frames already is a multiple of patch_size_t (the pixel-ALG condition likewise)
        image_latents = torch.cat([image_latents, pad], dim=1)

        # initial noise, drawn after the posterior noise
        if latents is None:
            latents0 = noise.randn((batch_size, latent_frames, c_lat, h_lat, w_lat))
        else:
            latents0 = torch.as_tensor(np.asarray(latents, np.float32))
        latents0 = latents0.to(self.device)

        if self.scheduler == "dpm":
            sched_plan = make_dpm_plan(self.scheduler_cfg, num_inference_steps, timesteps)
        else:
            sched_plan = make_ddim_plan(self.scheduler_cfg, num_inference_steps, timesteps, eta=eta)
        num_inference_steps = len(sched_plan.timesteps)
        lp_plan = request_plan(lp_cfg, num_inference_steps, (h_lat, w_lat), (height, width), do_cfg, exp_shortcut=True)

        # pixel-space ALG: one posterior draw a step, drawn after the initial latents
        pixel_image = pixel_noise = None
        if lp_plan.active and not lp_filter_in_latent:
            pixel_image = torch.from_numpy(image_vae_in).to(self.device)  # [B, 1, C, H, W]
            pixel_noise = torch.stack([noise.randn((batch_size, c_lat, 1, h_lat, w_lat))
                                       for _ in range(num_inference_steps)])

        # the guidance scale of each step: dynamic CFG's cosine ramp over the timesteps, or constant
        ts = sched_plan.timesteps
        if do_cfg and use_dynamic_cfg:
            ramp = (num_inference_steps - ts) / num_inference_steps
            g = 1 + guidance_scale * ((1 - np.cos(np.pi * ramp**5.0)) / 2)
        else:
            g = np.full(num_inference_steps, guidance_scale)
        g_table = g.astype(np.float32)

        # the scheduler's own noise, one draw a step: DPM always, DDIM at eta > 0
        step_noise = None
        if self.scheduler == "dpm" or eta > 0.0:
            step_noise = torch.stack([noise.randn(latents0.shape) for _ in range(num_inference_steps)])

        rope_cos = rope_sin = ofs = None
        if tcfg.use_rotary_positional_embeddings:
            rope_cos, rope_sin = (torch.from_numpy(a).to(self.device)
                                  for a in cogvideox_rope(tcfg, height, width, latents0.shape[1]))
        if tcfg.ofs_embed_dim is not None:
            ofs = torch.full((1,), 2.0, dtype=torch.float32, device=self.device)
        profiling.annotate(profiling.REQUEST, rows=batch_size, frames=num_frames, height=height, width=width,
                           steps=num_inference_steps)
        latents_out = self._sample(
            latents0, image_latents, prompt_embeds, negative_prompt_embeds, sched_plan, lp_plan, g_table,
            rope_cos, rope_sin, do_cfg, step_noise=step_noise, pixel_image=pixel_image, pixel_noise=pixel_noise,
            step_observer=step_observer, checkpoint=checkpoint, cache_interval=cache_interval, ofs=ofs)
        if output_type == "latent":  # the padded latent frames too, as alg_tpu returns them
            return latents_out.cpu().numpy()
        video = self.decode_latents(latents_out[:, additional_frames:])
        return processing.postprocess_video(video.cpu().numpy(), output_type)

    # -- sampler -------------------------------------------------------------

    def _dit(self, latent_in, cond_in, embeds, t: int, rope_cos, rope_sin, ofs=None) -> torch.Tensor:
        x = torch.cat([latent_in, cond_in], dim=2).to(self.dtype)
        timestep = torch.full((x.shape[0],), float(t), dtype=torch.float32, device=x.device)
        b, f, _, h, w = x.shape
        p, pt = self.transformer.cfg.patch_size, self.transformer.cfg.patch_size_t or 1
        with pipeline_mesh_scope(self):
            with span("dit.forward", passes=b, s_text=embeds.shape[1], s_video=f // pt * (h // p) * (w // p)):
                out = self.transformer(x, embeds, timestep, rope_cos, rope_sin, ofs=ofs)
            return out.float()

    def _pixel_condition(self, pixel_image, m_h, m_w, eps, latent_frames: int) -> torch.Tensor:
        """Pixel-space ALG's condition for one step: the RGB frame filtered at
        (H, W), VAE-encoded, the posterior sampled with the step's ``eps``,
        scaled, zero-padded to ``latent_frames``."""
        rgb = apply_filter_matrices(pixel_image, m_h, m_w)
        z = self._scale_latents(self._posterior_sample(*self._encode_moments(rgb), eps))
        return torch.cat([z, z.new_zeros((z.shape[0], latent_frames - z.shape[1]) + tuple(z.shape[2:]))], dim=1)

    def _sample(self, latents0, image_latents, prompt_embeds, negative_prompt_embeds, sched_plan, lp_plan: LPPlan,
                g_table: np.ndarray, rope_cos, rope_sin, do_cfg: bool, step_noise=None, pixel_image=None,
                pixel_noise=None, step_observer=None, checkpoint=None, cache_interval: int = 1,
                ofs=None) -> torch.Tensor:
        """The denoise loop. ``step_noise``/``pixel_noise``: CPU stacks ``[T,
        ...]`` of the scheduler's and the pixel posterior's draws; ``rope_cos``
        / ``rope_sin`` None for a DiT without RoPE; ``ofs`` the 1.5 DiT's
        ofs value."""
        alg = lp_plan.active
        use_dpm = self.scheduler == "dpm"
        guide = Guidance(lp_plan, self.device, do_cfg, do_cfg and alg)
        embeds = {n: guide.stack((negative_prompt_embeds, negative_prompt_embeds, prompt_embeds), n)
                  for n in guide.counts}
        latent_frames = image_latents.shape[1]

        def predict(i, latents):
            t, g, n = int(sched_plan.timesteps[i]), float(g_table[i]), int(guide.passes[i])
            cond = image_latents  # every ALG step filters, the 2-pass ones too
            if alg:
                cond = (guide.filter(i, apply_filter_matrices, image_latents) if pixel_image is None else
                        guide.filter(i, self._pixel_condition, pixel_image, pixel_noise[i], latent_frames))
            pred = self._dit(guide.stack((latents,) * 3, n), guide.stack((image_latents, cond, cond), n), embeds[n],
                             t, rope_cos, rope_sin, ofs)
            return guide.combine(pred, g, n)

        def update(i, carry, noise_pred):
            latents, old_pred = carry
            if use_dpm:
                return dpm_step(sched_plan, i, noise_pred, latents, old_pred, step_noise[i].to(self.device))
            eps = step_noise[i].to(self.device) if sched_plan.eta > 0.0 else None
            return ddim_step(sched_plan, i, noise_pred, latents, noise=eps), old_pred

        num_steps = len(sched_plan.timesteps)
        return denoise_loop(self, num_steps, (latents0, torch.zeros_like(latents0)), predict, update,
                            compute=guide.compute(num_steps, cache_interval), checkpoint=checkpoint,
                            step_observer=step_observer)
