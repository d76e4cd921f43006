"""HunyuanVideo-I2V sampler with adaptive low-pass guidance (counterpart of
``alg_tpu/pipelines/hunyuan.py``).

Same semantics as the reference ``HunyuanVideoImageToVideoPipeline``
(token_replace variant, the shipped model):

  * conditioning is *temporal*: the model input is ``cat([cond_frame,
    latents[:, :, 1:]], dim=2)``, the first latent frame replaced by the
    (possibly low-pass filtered) image latent; the scheduler steps frames 1+
    only and frame 0 is re-pinned to the clean image latent after each step;
  * HunyuanVideo is CFG-distilled: ``guidance_scale`` feeds the guidance
    embedding (``g·1000``). True CFG (2- and 3-pass steps, the negative
    prompt encoded against a black image) runs only when ``true_cfg_scale >
    1``. The shipped ALG config is single-pass: the filtered first-frame
    latent simply replaces the clean one;
  * ``i2v_stable``: initial latents = noise·0.999 + image latent·0.001,
    broadcast over the frames;
  * prompt path: Llava-Llama3 over the chat template with the image, the
    crop bookkeeping and the image-embedding interleave, plus the CLIP
    pooled text;
  * flow-match Euler over explicit sigmas ``linspace(1, 0, steps + 1)[:-1]``,
    a Python loop over the steps.

``image_condition_type="latent_concat"`` runs the channel-concat variant
(``[latents ⧺ condition latents ⧺ mask]``, a full scheduler step, the first
latent frame or the first 4 pixel frames dropped from the output). The only
noise drawn is the initial latents, from one CPU ``torch.Generator``.

Pixel-space ALG (``lp_filter_in_latent=False``) filters the preprocessed RGB
frame at (H, W) and takes the mode of its VAE posterior on each step that
uses the filtered condition (``alg_tpu``'s repair of the reference, whose
pixel branch fails on a PIL image); under ``latent_concat`` it is zero-padded
to the latent frames. Run control (``pipelines/denoise.py``): ``interrupt``,
a ``step_observer`` that may replace the latents, snapshots through
``checkpoint=`` and the opt-in step cache.

Not ported yet (queued in ROADMAP.md): sharded attention.

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
from alg_tpu_torch.models.clip import CLIPTextModel, clip_preprocess
from alg_tpu_torch.models.hunyuan.transformer import HunyuanVideoTransformer, hunyuan_rope
from alg_tpu_torch.models.hunyuan.vae import HunyuanVAE
from alg_tpu_torch.models.llama import LlavaModel
from alg_tpu_torch.models.vae_tiling import auto_tile_encode, tiled_encode, vae_decode
from alg_tpu_torch.ops.attention import pipeline_mesh_scope
from alg_tpu_torch.pipelines import processing
from alg_tpu_torch.pipelines.denoise import Guidance, check_cache_interval, denoise_loop
from alg_tpu_torch.schedulers.flow_match_euler import (FlowMatchEulerConfig, FlowMatchEulerPlan,
                                                       flow_match_euler_step, make_flow_match_euler_plan)
from alg_tpu_torch.utils import profiling
from alg_tpu_torch.utils.profiling import span

DEFAULT_PROMPT_TEMPLATE = {
    "template": (
        "<|start_header_id|>system<|end_header_id|>\n\n<image>\nDescribe the video by detailing the following aspects according to the reference image: "
        "1. The main content and theme of the video."
        "2. The color, shape, size, texture, quantity, text, and spatial relationships of the objects."
        "3. Actions, events, behaviors temporal relationships, physical movement changes of the objects."
        "4. background environment, light, style and atmosphere."
        "5. camera angles, movements, and transitions used in the video:<|eot_id|>\n\n"
        "<|start_header_id|>user<|end_header_id|>\n\n{}<|eot_id|>"
        "<|start_header_id|>assistant<|end_header_id|>\n\n"
    ),
    "crop_start": 103,
    "image_emb_start": 5,
    "image_emb_end": 581,
    "image_emb_len": 576,
    "double_return_token_id": 271,
}


@dataclasses.dataclass
class HunyuanVideoPipeline:
    """Modules on ``device`` plus the tokenizer and image-processor hooks.

    ``tokenize_llama``: ``(texts, max_len) -> (ids, mask)``, int ``[B,
    max_len]`` each (the Llava tokenizer with max-length padding and
    truncation); ``tokenize_clip``: ``(texts, max_len) -> ids``. Both are
    injected so the pipeline needs no tokenizer files. ``image_processor``:
    ``(image, size) -> [1, 3, size, size]`` fp32 CLIP pixel values;
    :func:`alg_tpu_torch.models.clip.clip_preprocess` (which needs PIL)
    unless given. ``dtype`` is the DiT's activation dtype; the VAE and the
    encoders run in the dtype of their own weights.

    ``vae_encode_tiling``: True or False forces tiled or whole encoding of
    the image; None tiles only multi-frame clips large enough to be a memory
    risk (``models/vae_tiling.auto_tile_encode``), so never the one frame.

    ``interrupt``: set it (from a ``step_observer`` or another thread) to
    stop the run after the current step; each call resets it."""

    transformer: HunyuanVideoTransformer
    vae: HunyuanVAE
    llava: Optional[LlavaModel] = None
    clip: Optional[CLIPTextModel] = None
    tokenize_llama: Optional[Callable] = None
    tokenize_clip: Optional[Callable] = None
    image_processor: Optional[Callable] = None
    scheduler_cfg: FlowMatchEulerConfig = dataclasses.field(
        default_factory=lambda: FlowMatchEulerConfig(shift=7.0, invert_sigmas=False))
    dtype: torch.dtype = torch.float32
    device: Union[str, torch.device] = "cuda"
    vae_encode_tiling: Optional[bool] = None
    # the DiT's device mesh (set by serving.shard_pipeline over a DiT from
    # sharding.partition.shard_transformer) and the sequence-parallel mode on its sp axis
    attn_mesh: Any = dataclasses.field(default=None, compare=False)
    sp_mode: str = "gather"
    interrupt: bool = dataclasses.field(default=False, compare=False)

    @property
    def vae_dtype(self) -> torch.dtype:
        return next(self.vae.parameters()).dtype

    # -- prompt encoding -----------------------------------------------------

    @torch.no_grad()
    def _get_llama_prompt_embeds(self, image, prompt, template, max_sequence_length=256, image_embed_interleave=2):
        """The template with the image through Llava (``hidden_states[-3]``),
        the template and assistant spans cropped away, the image embeddings
        interleaved and put in front. Index bookkeeping in numpy on the host."""
        if self.tokenize_llama is None or self.llava is None:
            raise ValueError("No Llava tokenizer or encoder; pass prompt_embeds instead")
        prompts = [template["template"].format(p) for p in ([prompt] if isinstance(prompt, str) else prompt)]
        crop_start = template["crop_start"]
        image_emb_len = template["image_emb_len"]
        image_emb_start = template["image_emb_start"]
        image_emb_end = template["image_emb_end"]
        double_return = template["double_return_token_id"]
        max_len = max_sequence_length + crop_start

        ids, mask = (np.asarray(a) for a in self.tokenize_llama(prompts, max_len))  # [B, max_len]
        cfg = self.llava.cfg
        pixels = np.asarray((self.image_processor or clip_preprocess)(image, cfg.vision.image_size), np.float32)

        # expand the <image> token to image_emb_len positions: the other
        # tokens scatter to cumsum positions (each image token widens the row
        # by image_emb_len - 1), then the image block is written over
        # [image_emb_start:image_emb_end] wherever the <image> token sat
        b = ids.shape[0]
        special = ids == cfg.image_token_index
        max_expanded = max_len + int(special.sum(-1).max()) * (image_emb_len - 1)
        new_pos = np.cumsum(special * (image_emb_len - 1) + 1, axis=-1) - 1
        expanded = np.full((b, max_expanded), cfg.pad_token_id, np.int64)
        bi_idx, tok_idx = np.where(~special)
        expanded[bi_idx, new_pos[bi_idx, tok_idx]] = ids[bi_idx, tok_idx]
        expanded[:, image_emb_start:image_emb_end] = cfg.image_token_index
        exp_mask = (expanded != cfg.pad_token_id).astype(np.int64)
        # masked position ids are filled with 1, not 0
        position_ids = np.where(exp_mask == 1, np.cumsum(exp_mask, axis=-1) - 1, 1)

        llava_dtype = next(self.llava.parameters()).dtype
        hidden = self.llava(
            torch.from_numpy(expanded).to(self.device),
            torch.from_numpy(np.repeat(pixels, b, 0)).to(self.device, llava_dtype),
            torch.from_numpy(exp_mask).to(self.device),
            torch.from_numpy(position_ids).to(self.device),
        )[-3].float().cpu().numpy()

        # crop bookkeeping
        text_crop_start = crop_start - 1 + image_emb_len
        # truncated-prompt quirk: with exactly 3 double-return tokens in the
        # whole batch (the template's 4th, after the assistant header, was
        # truncated away; only possible at B = 1) the crop lands at the end
        total_drt = int((ids == double_return).sum())
        embeds_list, mask_list, img_list = [], [], []
        for bi in range(b):
            drt = np.where(ids[bi] == double_return)[0]
            if total_drt == 3 and b == 1:
                last = ids.shape[1]
            else:
                # each row's last occurrence; a row without one crops at the end
                last = drt[-1] if len(drt) else ids.shape[1]
            a_start = last - 1 + image_emb_len - 4
            a_end = last - 1 + image_emb_len
            m_start, m_end = last - 4, last
            embeds_list.append(np.concatenate([hidden[bi, text_crop_start:a_start], hidden[bi, a_end:]]))
            mask_list.append(np.concatenate([mask[bi, crop_start:m_start], mask[bi, m_end:]]))
            img_list.append(hidden[bi, image_emb_start:image_emb_end])
        embeds = np.stack(embeds_list)
        masks = np.stack(mask_list)
        img = np.stack(img_list)
        if 0 < image_embed_interleave < 6:
            img = img[:, ::image_embed_interleave]
        prompt_embeds = np.concatenate([img, embeds], axis=1)
        prompt_mask = np.concatenate([np.ones(img.shape[:2], masks.dtype), masks], axis=1)
        return (torch.from_numpy(prompt_embeds).to(self.device, self.dtype),
                torch.from_numpy(prompt_mask.astype(np.int32)).to(self.device))

    @torch.no_grad()
    def encode_prompt(self, image, prompt, prompt_2=None, template=DEFAULT_PROMPT_TEMPLATE,
                      max_sequence_length=256, image_embed_interleave=2):
        """(Llava prompt embeds ``[B, S, text_embed_dim]``, CLIP pooled
        ``[B, pooled_dim]``, int32 prompt mask ``[B, S]``)."""
        embeds, mask = self._get_llama_prompt_embeds(image, prompt, template, max_sequence_length,
                                                     image_embed_interleave)
        if self.tokenize_clip is None or self.clip is None:
            raise ValueError("No CLIP tokenizer or text encoder; pass pooled_prompt_embeds instead")
        # the reference's length of 77 is CLIP's position table; clamped for smaller models
        clip_len = min(77, self.clip.cfg.max_position_embeddings)
        text_2 = prompt_2 or prompt
        ids = np.asarray(self.tokenize_clip([text_2] if isinstance(text_2, str) else text_2, clip_len))
        pooled = self.clip(torch.from_numpy(ids.astype(np.int64)).to(self.device))[1].to(self.dtype)
        return embeds, pooled, mask

    # -- main entry ----------------------------------------------------------

    @torch.no_grad()
    @profiling.request_span("hunyuan")
    def __call__(
        self,
        image=None,
        prompt: Optional[Union[str, Sequence[str]]] = None,
        prompt_2=None,
        negative_prompt: Optional[str] = None,
        height: int = 720,
        width: int = 1280,
        num_frames: int = 129,
        num_inference_steps: int = 50,
        guidance_scale: float = 6.0,
        true_cfg_scale: float = 1.0,
        i2v_stable: bool = True,
        seed: int = 42,
        noise_source: Optional[NoiseSource] = None,
        latents: Optional[np.ndarray] = None,
        sigmas: Optional[Sequence[float]] = None,
        prompt_embeds: Optional[torch.Tensor] = None,
        pooled_prompt_embeds: Optional[torch.Tensor] = None,
        prompt_attention_mask: Optional[torch.Tensor] = None,
        negative_prompt_embeds: Optional[torch.Tensor] = None,
        negative_pooled_prompt_embeds: Optional[torch.Tensor] = None,
        negative_prompt_attention_mask: Optional[torch.Tensor] = None,
        prompt_template=DEFAULT_PROMPT_TEMPLATE,
        max_sequence_length: int = 256,
        image_embed_interleave: int = 2,
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
        lp_on_noisy_latent: bool = False,
        enable_lp_img_embeds: bool = False,
        image_condition_type: str = "token_replace",
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
            "hunyuan", prompt=prompt, prompt_2=prompt_2, negative_prompt=negative_prompt, seed=seed, height=height,
            width=width, num_frames=num_frames, num_inference_steps=num_inference_steps,
            guidance_scale=guidance_scale, true_cfg_scale=true_cfg_scale, i2v_stable=i2v_stable,
            sigmas=None if sigmas is None else tuple(sigmas), image_condition_type=image_condition_type,
            **({"cache_interval": cache_interval} if cache_interval != 1 else {}),
            lp_on_noisy_latent=lp_on_noisy_latent, alg=dataclasses.astuple(lp_cfg)), checkpoint_every)
        processing.validate_attention_kwargs(attention_kwargs)
        assert not enable_lp_img_embeds, (
            "Low-pass filter on image embeds is not supported in HunyuanVideo pipeline."
        )
        if image_condition_type not in ("token_replace", "latent_concat"):
            raise ValueError(f"Unknown image_condition_type: {image_condition_type!r}")
        if height % 16 != 0 or width % 16 != 0:
            raise ValueError(f"height and width must be divisible by 16 but are {height} and {width}.")
        if output_type not in ("np", "pil", "latent"):
            raise ValueError(f"Unknown output_type {output_type!r}")
        if true_cfg_scale > 1.0 and guidance_scale > 1.0:
            logging.getLogger(__name__).warning(
                "Both true_cfg_scale > 1 and guidance_scale > 1: distilled guidance and true CFG are active "
                "at the same time (the reference warns the same).")
        do_true_cfg = true_cfg_scale > 1.0
        noise = noise_source or NoiseSource(seed=seed)
        vcfg, tcfg = self.vae.cfg, self.transformer.cfg

        f_lat = (num_frames - 1) // vcfg.temporal_compression_ratio + 1
        h_lat, w_lat = height // vcfg.spatial_scale, width // vcfg.spatial_scale
        zc = vcfg.latent_channels

        # image preprocess and the mode of the VAE posterior
        if image is not None and not isinstance(image, np.ndarray):
            image_tensor = processing.preprocess_image(image, height, width)
        else:
            image_tensor = np.asarray(image, np.float32)
        with span("vae.encode", frames=1, h=image_tensor.shape[2], w=image_tensor.shape[3]):  # -> [B, z, 1, h, w]
            image_latents = self._encode_mode(torch.from_numpy(image_tensor).to(self.device)[:, None])

        # prompt embeds
        if prompt_embeds is None:
            prompt_embeds, pooled_prompt_embeds, prompt_attention_mask = self.encode_prompt(
                image, prompt, prompt_2, template=prompt_template, max_sequence_length=max_sequence_length,
                image_embed_interleave=image_embed_interleave)
        batch_size = prompt_embeds.shape[0]
        if do_true_cfg and negative_prompt_embeds is None:
            # a black image of the run's size (what PIL's Image.new("RGB", (width, height), 0) holds)
            black = np.zeros((height, width, 3), np.uint8)
            negative_prompt_embeds, negative_pooled_prompt_embeds, negative_prompt_attention_mask = \
                self.encode_prompt(black, negative_prompt or "", None, template=prompt_template,
                                   max_sequence_length=max_sequence_length,
                                   image_embed_interleave=image_embed_interleave)
        if image_latents.shape[0] < batch_size:
            image_latents = image_latents.repeat_interleave(batch_size, dim=0)

        # initial latents
        if latents is None:
            latents0 = noise.randn((batch_size, zc, f_lat, h_lat, w_lat))
        else:
            latents0 = torch.as_tensor(np.asarray(latents, np.float32))
        latents0 = latents0.to(self.device)
        if i2v_stable:
            latents0 = latents0 * 0.999 + image_latents.expand_as(latents0) * (1 - 0.999)

        cond_mask = None
        if image_condition_type == "latent_concat":
            # condition = the image latent on frame 0 and zeros after; the mask marks the conditioned frame
            zpad = image_latents.new_zeros((batch_size, zc, f_lat - 1, h_lat, w_lat))
            image_latents = torch.cat([image_latents, zpad], dim=2)
            cond_mask = image_latents.new_zeros((batch_size, 1, f_lat, h_lat, w_lat))
            cond_mask[:, :, 0] = 1.0
            if tcfg.in_channels != 2 * zc + 1:
                raise ValueError(f"latent_concat needs a transformer with in_channels {2 * zc + 1} (2·z+1), "
                                 f"got {tcfg.in_channels}")

        # plans
        sig = np.linspace(1.0, 0.0, num_inference_steps + 1)[:-1] if sigmas is None else np.asarray(sigmas)
        sched_plan = make_flow_match_euler_plan(self.scheduler_cfg, sigmas=sig)
        # the single-pass branch works without true CFG
        lp_plan = request_plan(lp_cfg, num_inference_steps, (h_lat, w_lat), (height, width))
        # pixel-space ALG encodes the preprocessed tensor (the mode: no draws)
        pixel_image = None
        if lp_plan.active and not lp_filter_in_latent:
            pixel_image = torch.from_numpy(image_tensor).to(self.device)[:, None]  # [B, 1, C, H, W]
        guidance = None
        if tcfg.guidance_embeds:
            guidance = torch.full((1,), guidance_scale * 1000.0, dtype=torch.float32, device=self.device)

        profiling.annotate(profiling.REQUEST, rows=batch_size, frames=num_frames, height=height, width=width,
                           steps=num_inference_steps)
        latents_out = self._sample(
            latents0, image_latents, prompt_embeds, pooled_prompt_embeds, prompt_attention_mask,
            negative_prompt_embeds, negative_pooled_prompt_embeds, negative_prompt_attention_mask,
            sched_plan, lp_plan, true_cfg_scale, do_true_cfg, guidance, lp_on_noisy_latent,
            image_condition_type, cond_mask, pixel_image=pixel_image, step_observer=step_observer,
            checkpoint=checkpoint, cache_interval=cache_interval)

        latent_concat = image_condition_type == "latent_concat"
        if output_type == "latent":
            return (latents_out[:, :, 1:] if latent_concat else latents_out).cpu().numpy()
        video = self.decode_latents(latents_out)  # [B, C, F, H, W]
        if latent_concat:
            video = video[:, :, 4:]
        return processing.postprocess_video(video.permute(0, 2, 1, 3, 4).cpu().numpy(), output_type)

    # -- sampler ---------------------------------------------------------------

    def _dit(self, lat_in, embeds, mask, pooled, t: float, guidance, rope_cos, rope_sin) -> torch.Tensor:
        n, _, f, h, w = lat_in.shape
        ts = torch.full((n,), t, dtype=torch.float32, device=lat_in.device)
        p, pt = self.transformer.cfg.patch_size, self.transformer.cfg.patch_size_t
        lat_in, embeds, pooled = lat_in.to(self.dtype), embeds.to(self.dtype), pooled.to(self.dtype)
        with pipeline_mesh_scope(self):
            with span("dit.forward", passes=n, s_text=embeds.shape[1], s_video=f // pt * (h // p) * (w // p)):
                out = self.transformer(lat_in, ts, embeds, mask, pooled,
                                       None if guidance is None else guidance.expand(n), rope_cos, rope_sin)
            return out.float()

    def _encode_mode(self, x_bfchw: torch.Tensor) -> torch.Tensor:
        """The mode of the VAE posterior of ``[B, F, C, H, W]`` pixels on the
        device, scaled -> ``[B, z, F', h, w]`` fp32."""
        vcfg = self.vae.cfg
        x = x_bfchw.to(self.vae_dtype).permute(0, 1, 3, 4, 2)  # BFHWC
        if auto_tile_encode(x.shape[1], x.shape[2], x.shape[3], self.vae_encode_tiling):
            (mean,) = tiled_encode(lambda xt: self.vae.encode(xt)[:1], x, vcfg.spatial_scale)
        else:
            mean = self.vae.encode(x)[0]
        return mean.float().permute(0, 4, 1, 2, 3) * vcfg.scaling_factor

    def _pixel_condition(self, pixel_image, m_h, m_w, latent_frames: int) -> torch.Tensor:
        """Pixel-space ALG's condition for one step: the RGB frame filtered at
        (H, W), the mode of its VAE posterior, scaled; zero-padded to
        ``latent_frames`` (``latent_concat``)."""
        z = self._encode_mode(apply_filter_matrices(pixel_image, m_h, m_w))
        pad = z.new_zeros(tuple(z.shape[:2]) + (latent_frames - z.shape[2],) + tuple(z.shape[3:]))
        return torch.cat([z, pad], dim=2)

    def _sample(self, latents0, image_latents, prompt_embeds, pooled, prompt_mask, neg_embeds, neg_pooled,
                neg_mask, sched_plan: FlowMatchEulerPlan, lp_plan: LPPlan, true_cfg_scale: float,
                do_true_cfg: bool, guidance, lp_on_noisy_latent: bool, image_condition_type: str,
                cond_mask, pixel_image=None, step_observer=None, checkpoint=None,
                cache_interval: int = 1) -> torch.Tensor:
        """The denoise loop."""
        alg = lp_plan.active
        latent_concat = image_condition_type == "latent_concat"
        batch = latents0.shape[0]
        f_lat, h_lat, w_lat = latents0.shape[2:]
        rope_cos, rope_sin = (torch.from_numpy(a).to(self.device)
                              for a in hunyuan_rope(self.transformer.cfg, f_lat, h_lat, w_lat))
        il = image_latents
        # 3-pass steps only under true CFG with ALG, and never with lp_on_noisy_latent
        guide = Guidance(lp_plan, self.device, do_true_cfg, do_true_cfg and alg and not lp_on_noisy_latent)
        text = {n: tuple(guide.stack((neg, neg, pos), n) for neg, pos in
                         ((neg_embeds, prompt_embeds), (neg_mask, prompt_mask), (neg_pooled, pooled)))
                for n in guide.counts}

        def assemble(lat_in, img_cond):
            """token_replace: the condition latent replaces frame 0.
            latent_concat: channels = [latents ⧺ condition ⧺ mask]."""
            if latent_concat:
                return torch.cat([lat_in, img_cond, cond_mask.repeat(lat_in.shape[0] // batch, 1, 1, 1, 1)], dim=1)
            return torch.cat([img_cond, lat_in[:, :, 1:]], dim=2)

        def predict(i, latents):
            t, n = float(sched_plan.timesteps[i]), int(guide.passes[i])
            cond = il
            # 2-pass steps (strength 0, lp_on_noisy_latent, or no ALG) take the clean condition; a single
            # pass's ALG replaces it
            if alg and n != 2:
                cond = (guide.filter(i, apply_filter_matrices, il) if pixel_image is None else
                        guide.filter(i, self._pixel_condition, pixel_image, il.shape[2]))
            pred = self._dit(assemble(guide.stack((latents,) * 3, n), guide.stack((il, cond, cond), n)), *text[n], t,
                             guidance, rope_cos, rope_sin)
            return guide.combine(pred, true_cfg_scale, n)

        def update(i, carry, noise_pred):
            (latents,) = carry
            if latent_concat:  # a full scheduler step, frame 0 not re-pinned
                latents = flow_match_euler_step(sched_plan, i, noise_pred, latents)
            else:  # token_replace: step frames 1+ and re-pin frame 0
                rest = flow_match_euler_step(sched_plan, i, noise_pred[:, :, 1:], latents[:, :, 1:])
                latents = torch.cat([il, rest], dim=2)
            return (latents.float(),)

        num_steps = len(sched_plan.timesteps)
        return denoise_loop(self, num_steps, (latents0,), predict, update,
                            compute=guide.compute(num_steps, cache_interval), checkpoint=checkpoint,
                            step_observer=step_observer)

    @torch.no_grad()
    def decode_latents(self, latents: torch.Tensor, vae_tiling: Optional[bool] = None, mesh=None) -> torch.Tensor:
        """Divide by the scaling factor and VAE decode: ``[B, z, F', h, w]``
        -> ``[B, C, F, H, W]`` fp32 in [-1, 1], through overlapping tiles
        once the latent exceeds 48 x 48, spread over the ranks of ``mesh``
        (by default the pipeline's ``attn_mesh``)."""
        z = (latents.float() / self.vae.cfg.scaling_factor).permute(0, 2, 3, 4, 1).to(self.vae_dtype)  # BFHWC
        frames = vae_decode(self.vae, z, vae_tiling, self.attn_mesh if mesh is None else mesh)
        return frames.permute(0, 4, 1, 2, 3).float()
