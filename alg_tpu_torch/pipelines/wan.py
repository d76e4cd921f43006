"""Wan2.1-I2V sampler with adaptive low-pass guidance (counterpart of
``alg_tpu/pipelines/wan.py``).

Same semantics as the reference ``WanImageToVideoPipeline``:

  * layout ``[B, C, F, h, w]``; frames coerced to 4k+1;
  * conditioning = ``[mask (4 ch) ⧺ latent_cond (16 ch)]`` built from the
    first frame (and an optional ``last_image``) with the mode of the VAE
    posterior and the per-channel ``latents_mean``/``latents_std``
    normalisation;
  * latent-space ALG filters the whole 20-channel condition, mask channels
    included (a quirk of the reference, kept);
  * a step is 3-pass where the ALG strength is nonzero, with no shortcut for
    the exponential schedule: ``[uncond(clean), uncond(filtered),
    text(filtered)]`` combined as ``uncond_init + g·(text − uncond)``; the
    other steps are 2-pass on the *clean* condition;
  * UMT5 text encoding with the tokenizer's mask and the embeddings zeroed
    past each prompt's length; CLIP-vision penultimate hidden states as the
    image embeddings;
  * UniPC steps over fp32 latents in a Python loop, then de-normalise and
    VAE decode, tiled above 48×48 latents.

``guidance_scale <= 1`` runs a single pass. Pixel-space ALG
(``lp_filter_in_latent=False``) rebuilds the latent half of the condition on
each 3-pass step: the RGB frame filtered at (H, W), ``num_frames - 1`` zero
frames after it, a VAE encode through overlapping tiles one at a time
(clips past ~8 frames of 480p), a posterior sample with that step's noise,
the ``latents_mean``/``latents_std`` normalisation; the 4 mask channels are
the clean condition's. As in ``alg_tpu``, that rebuild leaves a
``last_image`` out of the video it encodes (the mask still marks it), where
the reference encodes it filtered too: kept for parity (ROADMAP.md C, R10).

Draws, from one CPU ``torch.Generator``: the initial latents, then (pixel
mode) one posterior draw a step ``[B, z, F', h, w]``, all before the loop.
Run control (``pipelines/denoise.py``): ``interrupt``, a ``step_observer``
that may replace the latents, snapshots through ``checkpoint=`` (the UniPC
history is part of the carry) and the opt-in step cache.

Not ported yet (queued in ROADMAP.md): sharded attention.

Under a recording profiler (``utils/profiling.py``) a call is a
``pipeline.request`` span (family, batch rows, frames, height, width,
steps) whose ``pipeline.prepare`` part holds the condition's ``vae.encode``;
a step's prediction holds ``alg.filter``, ``dit.forward`` (its passes and
text and video tokens) and ``cfg.combine``; the decode is ``vae.decode``.
"""

from __future__ import annotations

import dataclasses
import html
import re
from typing import Any, Callable, Optional, Sequence, Union

import numpy as np
import torch

from alg_tpu_torch.alg.matrices import apply_filter_matrices
from alg_tpu_torch.alg.schedule import LPPlan, lp_config, request_plan
from alg_tpu_torch.core.rng import NoiseSource
from alg_tpu_torch.io.runstate import as_checkpoint, run_fingerprint
from alg_tpu_torch.models.clip import CLIPVisionModel, clip_preprocess
from alg_tpu_torch.models.t5 import T5Encoder
from alg_tpu_torch.models.vae_tiling import auto_tile_encode, tiled_encode, vae_decode
from alg_tpu_torch.models.wan.transformer import WanTransformer, wan_rope
from alg_tpu_torch.models.wan.vae import WanVAE
from alg_tpu_torch.ops.attention import pipeline_mesh_scope
from alg_tpu_torch.pipelines import processing
from alg_tpu_torch.pipelines.denoise import Guidance, check_cache_interval, denoise_loop
from alg_tpu_torch.schedulers.unipc import UniPCConfig, UniPCPlan, make_unipc_plan, unipc_init_state, unipc_step
from alg_tpu_torch.utils import profiling
from alg_tpu_torch.utils.profiling import span


def prompt_clean(text: str) -> str:
    """``ftfy.fix_text`` (where ftfy is installed), html unescape, whitespace
    collapse: the reference's prompt cleaning."""
    try:
        import ftfy

        text = ftfy.fix_text(text)
    except ImportError:
        pass
    text = html.unescape(html.unescape(text))
    return re.sub(r"\s+", " ", text).strip()


@dataclasses.dataclass
class WanPipeline:
    """Modules on ``device`` plus the tokenizer hook.

    ``tokenize``: ``(prompts, max_len) -> (ids, mask)``, int ``[B, max_len]``
    each (the UMT5 tokenizer with max-length padding and truncation; ``mask``
    is 1 over each prompt's tokens), injected so the pipeline needs no
    tokenizer files. ``dtype`` is the DiT's activation dtype; the VAE and
    the encoders run in the dtype of their own weights.

    ``vae_encode_tiling``: True or False forces tiled or whole encoding of
    the condition video; None tiles only clips large enough to be a memory
    risk (``models/vae_tiling.auto_tile_encode``).

    ``guidance_microbatch``: 0 runs a step's CFG/ALG passes as one batched
    DiT forward; N > 0 runs them one after another in micro-batches of N
    samples, which lowers the peak activation memory.

    ``interrupt``: set it (from a ``step_observer`` or another thread) to
    stop the run after the current step; each call resets it."""

    transformer: WanTransformer
    vae: WanVAE
    t5: Optional[T5Encoder] = None
    clip: Optional[CLIPVisionModel] = None
    tokenize: Optional[Callable] = None
    scheduler_cfg: UniPCConfig = dataclasses.field(default_factory=lambda: UniPCConfig(flow_shift=5.0))
    dtype: torch.dtype = torch.float32
    device: Union[str, torch.device] = "cuda"
    vae_encode_tiling: Optional[bool] = None
    guidance_microbatch: int = 0
    # the DiT's device mesh (set by serving.shard_pipeline over a DiT from
    # sharding.partition.shard_transformer) and the sequence-parallel mode on its sp axis
    attn_mesh: Any = dataclasses.field(default=None, compare=False)
    sp_mode: str = "gather"
    interrupt: bool = dataclasses.field(default=False, compare=False)

    @property
    def vae_dtype(self) -> torch.dtype:
        return next(self.vae.parameters()).dtype

    # -- encoders ------------------------------------------------------------

    @torch.no_grad()
    def encode_prompt(self, prompt: Union[str, Sequence[str]], max_sequence_length: int = 512) -> torch.Tensor:
        """UMT5 encode with the mask; each sample zeroed past its length."""
        if self.tokenize is None or self.t5 is None:
            raise ValueError("No tokenizer or UMT5 encoder; pass prompt_embeds instead")
        prompts = [prompt] if isinstance(prompt, str) else list(prompt)
        ids, mask = self.tokenize([prompt_clean(p) for p in prompts], max_sequence_length)
        ids = torch.as_tensor(np.asarray(ids), dtype=torch.long).to(self.device)
        mask = torch.as_tensor(np.asarray(mask), dtype=torch.long).to(self.device)
        embeds = self.t5(ids, mask)
        keep = torch.arange(ids.shape[1], device=ids.device)[None, :] < mask.sum(dim=1)[:, None]
        return embeds.masked_fill(~keep[..., None], 0.0).to(self.dtype)

    @torch.no_grad()
    def encode_image(self, image) -> torch.Tensor:
        """CLIP-vision penultimate hidden states ``[B, 257, image_dim]``."""
        if self.clip is None:
            raise ValueError("No CLIP vision encoder; pass image_embeds instead")
        pixels = torch.from_numpy(clip_preprocess(image, self.clip.cfg.image_size))
        clip_dtype = next(self.clip.parameters()).dtype
        return self.clip(pixels.to(self.device, clip_dtype))[-2].to(self.dtype)

    # -- main entry ----------------------------------------------------------

    @torch.no_grad()
    @profiling.request_span("wan")
    def __call__(
        self,
        image=None,
        prompt: Optional[Union[str, Sequence[str]]] = None,
        negative_prompt: Optional[Union[str, Sequence[str]]] = None,
        height: int = 480,
        width: int = 832,
        num_frames: int = 81,
        num_inference_steps: int = 50,
        guidance_scale: float = 5.0,
        seed: int = 42,
        noise_source: Optional[NoiseSource] = None,
        latents: Optional[np.ndarray] = None,
        prompt_embeds: Optional[torch.Tensor] = None,
        negative_prompt_embeds: Optional[torch.Tensor] = None,
        image_embeds: Optional[torch.Tensor] = None,
        last_image=None,
        max_sequence_length: int = 512,
        output_type: str = "np",
        attention_kwargs: Optional[dict] = None,
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
        step_observer: Optional[Callable] = None,
        checkpoint=None,
        checkpoint_every: int = 8,
        cache_interval: int = 1,
    ):
        """Generate a video; returns ``np`` frames ``[B, F, H, W, 3]`` in
        [0, 1], ``pil`` frame lists or the final ``latent`` ``[B, C, F, h,
        w]``. ``checkpoint``, ``checkpoint_every``, ``cache_interval``: as
        in :meth:`CogVideoXPipeline.__call__`."""
        self.interrupt = False
        cache_interval = check_cache_interval(cache_interval)
        lp_cfg = lp_config(locals())
        checkpoint = as_checkpoint(checkpoint, run_fingerprint(
            "wan", prompt=prompt, negative_prompt=negative_prompt, seed=seed, height=height, width=width,
            num_frames=num_frames, num_inference_steps=num_inference_steps, guidance_scale=guidance_scale,
            has_last_image=last_image is not None,
            **({"cache_interval": cache_interval} if cache_interval != 1 else {}), alg=dataclasses.astuple(lp_cfg)),
            checkpoint_every)
        processing.validate_attention_kwargs(attention_kwargs)
        if height % 16 != 0 or width % 16 != 0:
            raise ValueError(f"height and width must be divisible by 16 but are {height} and {width}.")
        if prompt is None and prompt_embeds is None:
            raise ValueError("Provide prompt or prompt_embeds.")
        if prompt is not None and prompt_embeds is not None:
            raise ValueError("Cannot forward both prompt and prompt_embeds.")
        if prompt is not None and not isinstance(prompt, (str, list, tuple)):
            raise ValueError(f"prompt must be str or list but is {type(prompt)}")
        # the image is needed even with image_embeds given: the 20-channel
        # mask + latent condition is VAE-encoded from its pixels
        if image is None:
            raise ValueError("Provide image (image_embeds only replaces the CLIP-vision embeds).")
        if negative_prompt is not None and not isinstance(negative_prompt, (str, list, tuple)):
            raise ValueError(f"negative_prompt must be str or list but is {type(negative_prompt)}")
        if output_type not in ("np", "pil", "latent"):
            raise ValueError(f"Unknown output_type {output_type!r}")
        do_cfg = guidance_scale > 1.0
        noise = noise_source or NoiseSource(seed=seed)
        vcfg = self.vae.cfg

        # frames coerced to 4k + 1
        tscale = vcfg.temporal_scale
        if num_frames % tscale != 1:
            num_frames = num_frames // tscale * tscale + 1
        num_frames = max(num_frames, 1)
        f_lat = (num_frames - 1) // tscale + 1
        h_lat, w_lat = height // vcfg.spatial_scale, width // vcfg.spatial_scale

        # text and image encoders
        if prompt_embeds is None:
            prompt_embeds = self.encode_prompt(prompt, max_sequence_length)
        if do_cfg and negative_prompt_embeds is None:
            neg = negative_prompt if negative_prompt is not None else ""
            negative_prompt_embeds = self.encode_prompt(
                [neg] * prompt_embeds.shape[0] if isinstance(neg, str) else neg, max_sequence_length)
        batch_size = prompt_embeds.shape[0]
        if image_embeds is None:
            image_embeds = self.encode_image(image)

        # initial noise [B, z, F_lat, h, w] fp32
        if latents is None:
            latents0 = noise.randn((batch_size, vcfg.z_dim, f_lat, h_lat, w_lat))
        else:
            latents0 = torch.as_tensor(np.asarray(latents, np.float32))
        latents0 = latents0.to(self.device)

        # condition: [mask (4) ⧺ normalised latent_cond (16)]
        if not isinstance(image, np.ndarray):
            image = processing.preprocess_image(image, height, width)
        if last_image is not None and not isinstance(last_image, np.ndarray):
            last_image = processing.preprocess_image(last_image, height, width)
        condition = self._build_condition(np.asarray(image, np.float32), batch_size, num_frames, last_image)

        sched_plan = make_unipc_plan(self.scheduler_cfg, num_inference_steps)
        # Wan has no 2-pass shortcut for the exponential schedule
        lp_plan = request_plan(lp_cfg, num_inference_steps, (h_lat, w_lat), (height, width), do_cfg)

        # pixel-space ALG: one posterior draw a step, drawn after the initial latents
        pixel_image = pixel_noise = None
        if lp_plan.active and not lp_filter_in_latent:
            pixel_image = torch.from_numpy(np.asarray(image, np.float32)).to(self.device)[:, None]  # [B, 1, C, H, W]
            pixel_noise = torch.stack([noise.randn((batch_size, vcfg.z_dim, f_lat, h_lat, w_lat))
                                       for _ in range(num_inference_steps)])

        profiling.annotate(profiling.REQUEST, rows=batch_size, frames=num_frames, height=height, width=width,
                           steps=num_inference_steps)
        latents_out = self._sample(latents0, condition, prompt_embeds, negative_prompt_embeds, image_embeds,
                                   sched_plan, lp_plan, float(np.float32(guidance_scale)), do_cfg, num_frames,
                                   pixel_image=pixel_image, pixel_noise=pixel_noise, step_observer=step_observer,
                                   checkpoint=checkpoint, cache_interval=cache_interval)
        if output_type == "latent":
            return latents_out.cpu().numpy()
        video = self.decode_latents(latents_out)  # [B, C, F, H, W]
        return processing.postprocess_video(video.permute(0, 2, 1, 3, 4).cpu().numpy(), output_type)

    # -- condition construction ------------------------------------------------

    def _mask_block(self, batch_size: int, num_frames: int, h_lat: int, w_lat: int, has_last: bool) -> np.ndarray:
        """``[B, 4, F_lat, h, w]``: ones on the conditioned pixel frames, the
        first frame repeated 4 times, frames folded into channels by 4."""
        t = self.vae.cfg.temporal_scale
        mask = np.ones((batch_size, 1, num_frames, h_lat, w_lat), np.float32)
        if has_last:
            mask[:, :, 1:-1] = 0.0
        else:
            mask[:, :, 1:] = 0.0
        mask = np.concatenate([np.repeat(mask[:, :, 0:1], t, axis=2), mask[:, :, 1:]], axis=2)  # [B, 1, F+3, h, w]
        return mask.reshape(batch_size, -1, t, h_lat, w_lat).transpose(0, 2, 1, 3, 4)

    def _encode_video_condition(self, video_bfchw: torch.Tensor, eps_bcfhw: Optional[torch.Tensor] = None):
        """The mode of the VAE posterior (or, given ``eps``, a sample with it,
        drawn in torch's ``[B, z, F', h, w]`` order), normalised by
        ``latents_mean``/``std`` -> ``[B, z, F', h, w]`` fp32. The full-length
        condition video (first frame, then zeros) is the largest encode of a
        run, so it goes through overlapping spatial tiles, one at a time,
        unless it is small."""
        vcfg = self.vae.cfg
        x = video_bfchw.permute(0, 1, 3, 4, 2).to(self.vae_dtype)  # BFHWC
        encode = self.vae.encode if eps_bcfhw is not None else (lambda xt: self.vae.encode(xt)[:1])
        if auto_tile_encode(x.shape[1], x.shape[2], x.shape[3], self.vae_encode_tiling):
            moments = tiled_encode(encode, x, vcfg.spatial_scale)
        else:
            moments = encode(x)
        mean = moments[0].float()
        if eps_bcfhw is not None:
            std = torch.exp(0.5 * moments[1].float().clamp(-30.0, 20.0))
            mean = mean + std * eps_bcfhw.to(mean.device).permute(0, 2, 3, 4, 1)
        z = mean.permute(0, 4, 1, 2, 3)
        lm = torch.tensor(vcfg.latents_mean, dtype=torch.float32, device=z.device).view(1, -1, 1, 1, 1)
        ls = torch.tensor(vcfg.latents_std, dtype=torch.float32, device=z.device).view(1, -1, 1, 1, 1)
        return (z - lm) / ls

    def _build_condition(self, image: np.ndarray, batch_size: int, num_frames: int,
                         last_image: Optional[np.ndarray]) -> torch.Tensor:
        img = torch.from_numpy(image).to(self.device)[:, None]  # [B, 1, C, H, W]
        frames = [img]
        n_zero = num_frames - (1 if last_image is None else 2)
        frames.append(img.new_zeros((img.shape[0], n_zero) + tuple(img.shape[2:])))
        if last_image is not None:
            frames.append(torch.from_numpy(np.asarray(last_image, np.float32)).to(self.device)[:, None])
        video = torch.cat(frames, dim=1)
        with span("vae.encode", frames=video.shape[1], h=video.shape[3], w=video.shape[4]):
            latent_cond = self._encode_video_condition(video)
        if latent_cond.shape[0] < batch_size:
            latent_cond = latent_cond.repeat_interleave(batch_size, dim=0)
        h_lat, w_lat = latent_cond.shape[3:]
        mask = self._mask_block(batch_size, num_frames, h_lat, w_lat, last_image is not None)
        return torch.cat([torch.from_numpy(mask).to(self.device), latent_cond], dim=1)  # [B, 20, F', h, w]

    # -- sampler ---------------------------------------------------------------

    def _dit(self, latent_in, cond_in, embeds, img_embeds, t: float, rope_cos, rope_sin) -> torch.Tensor:
        x = torch.cat([latent_in, cond_in], dim=1).to(self.dtype)

        pt, ph, pw = self.transformer.cfg.patch_size
        s_video = x.shape[2] // pt * (x.shape[3] // ph) * (x.shape[4] // pw)

        def fwd(xb, eb, ib):
            ts = torch.full((xb.shape[0],), t, dtype=torch.float32, device=xb.device)
            eb, ib = eb.to(self.dtype), None if ib is None else ib.to(self.dtype)
            with span("dit.forward", passes=xb.shape[0], s_text=eb.shape[1], s_video=s_video):
                out = self.transformer(xb, ts, eb, ib, rope_cos, rope_sin)
            return out.float()

        n, mb = x.shape[0], int(self.guidance_microbatch or 0)
        with pipeline_mesh_scope(self):
            if 0 < mb < n and n % mb == 0:
                return torch.cat([fwd(x[i:i + mb], embeds[i:i + mb],
                                      None if img_embeds is None else img_embeds[i:i + mb]) for i in range(0, n, mb)])
            return fwd(x, embeds, img_embeds)

    def _pixel_condition(self, pixel_image, m_h, m_w, eps, num_frames: int, mask) -> torch.Tensor:
        """Pixel-space ALG's condition for one step: the RGB frame filtered at
        (H, W) with ``num_frames - 1`` zero frames after it, encoded and
        sampled with the step's ``eps``, normalised, behind the clean
        condition's 4 ``mask`` channels."""
        rgb = apply_filter_matrices(pixel_image, m_h, m_w)  # [B, 1, C, H, W]
        video = torch.cat([rgb, rgb.new_zeros((rgb.shape[0], num_frames - 1) + tuple(rgb.shape[2:]))], dim=1)
        return torch.cat([mask, self._encode_video_condition(video, eps)], dim=1)

    def _sample(self, latents0, condition, prompt_embeds, negative_prompt_embeds, image_embeds,
                sched_plan: UniPCPlan, lp_plan: LPPlan, g: float, do_cfg: bool, num_frames: int, pixel_image=None,
                pixel_noise=None, step_observer=None, checkpoint=None, cache_interval: int = 1) -> torch.Tensor:
        """The denoise loop. ``pixel_noise``: the CPU stack ``[T, ...]`` of
        the pixel posterior's draws."""
        f_lat, h_lat, w_lat = latents0.shape[2:]
        rope_cos, rope_sin = (torch.from_numpy(a).to(self.device)
                              for a in wan_rope(self.transformer.cfg, f_lat, h_lat, w_lat))
        guide = Guidance(lp_plan, self.device, do_cfg, do_cfg and lp_plan.active)
        embeds = {n: guide.stack((negative_prompt_embeds, negative_prompt_embeds, prompt_embeds), n)
                  for n in guide.counts}

        def predict(i, latents):
            t, n = float(sched_plan.timesteps[i]), int(guide.passes[i])
            cond = condition  # only 3-pass steps filter; the others take the clean condition
            if n == 3:
                cond = (guide.filter(i, apply_filter_matrices, condition) if pixel_image is None else
                        guide.filter(i, self._pixel_condition, pixel_image, pixel_noise[i], num_frames,
                                     condition[:, :4]))
            pred = self._dit(guide.stack((latents,) * 3, n), guide.stack((condition, cond, cond), n), embeds[n],
                             None if image_embeds is None else guide.stack((image_embeds,) * 3, n), t, rope_cos,
                             rope_sin)
            return guide.combine(pred, g, n)

        def update(i, carry, noise_pred):
            return unipc_step(sched_plan, i, noise_pred, *carry)

        num_steps = len(sched_plan.timesteps)
        return denoise_loop(self, num_steps, (latents0, unipc_init_state(sched_plan, latents0)), predict, update,
                            compute=guide.compute(num_steps, cache_interval), checkpoint=checkpoint,
                            step_observer=step_observer)

    @torch.no_grad()
    def decode_latents(self, latents: torch.Tensor, vae_tiling: Optional[bool] = None, mesh=None) -> torch.Tensor:
        """De-normalise and VAE decode: ``[B, z, F', h, w]`` -> ``[B, C, F, H,
        W]`` fp32 in [-1, 1]. ``vae_tiling``: True or False forces
        overlapping tiles or one whole decode; None tiles once the latent
        exceeds 48 x 48. ``mesh`` (by default the pipeline's ``attn_mesh``)
        spreads the tiles over its ranks."""
        vcfg = self.vae.cfg
        lm = torch.tensor(vcfg.latents_mean, dtype=torch.float32, device=latents.device).view(1, -1, 1, 1, 1)
        ls = torch.tensor(vcfg.latents_std, dtype=torch.float32, device=latents.device).view(1, -1, 1, 1, 1)
        z = (latents.float() * ls + lm).permute(0, 2, 3, 4, 1).to(self.vae_dtype)  # BFHWC
        frames = vae_decode(self.vae, z, vae_tiling, self.attn_mesh if mesh is None else mesh)
        return frames.permute(0, 4, 1, 2, 3).float()
