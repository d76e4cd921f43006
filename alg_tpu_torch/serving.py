"""Batched multi-prompt serving (counterpart of ``alg_tpu/serving.py``;
BASELINE config #5) for the three families.

N requests run through one pipeline call: their prompts are encoded as a
batch (HunyuanVideo's per request, since Llava sees each request's image),
their images are stacked along the batch, and each request draws its noise
from its own ``NoiseSource(seed)``, so that a request served in a batch gets
the draws it would get alone. The CFG batch of a step rides in one DiT
forward, so a batch of N launches the kernels as often as one request does.

Per-family differences are isolated in ``_ENCODERS``:
  * CogVideoX: T5 text only;
  * Wan: UMT5 text and CLIP-vision embeds of each request's image;
  * HunyuanVideo: Llava (image, prompt) and the CLIP pooled text, per
    request, and the negative prompt against a black image under true CFG.

Images are PIL images, RGB uint8 ``[H, W, 3]`` arrays (preprocessed at their
own size, as ``cli.run`` does, so no PIL is needed) or float ``[1, 3, H, W]``
arrays already preprocessed to [-1, 1] (``alg_tpu``'s meaning of an array).

As in ``alg_tpu``, CogVideoX and Wan prompts are encoded at
``encode_prompt``'s default length (226 and 512 tokens), whatever the
config's ``max_sequence_length`` says, where HunyuanVideo honours it
(ROADMAP.md C, R13).

Over a device mesh (:func:`shard_pipeline`, ``serve_batch(mesh=...)``) the
DiT holds this rank's tensor-parallel shards, its attention splits the
tokens over sp in ``sp_mode``, and the requests split over dp: each dp group
serves its contiguous share and the videos are gathered back, so every rank
returns the whole batch. Each request's seed drives its own noise stream,
so the dp split changes no draw.
"""

from __future__ import annotations

import dataclasses
import types
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from alg_tpu_torch.core.rng import NoiseSource


@dataclasses.dataclass
class BatchRequest:
    prompt: str
    image: Any  # PIL image, RGB uint8 [H, W, 3] array, or preprocessed float [1, 3, H, W] array
    negative_prompt: Optional[str] = None
    seed: int = 42
    # FLF2V (Wan only): condition the last frame too. All requests in a batch must agree on its presence (the
    # mask and condition layout differs).
    last_image: Any = None


def _to_pipeline_image(img, height: int, width: int) -> np.ndarray:
    """One request's image as the pipelines take it: fp32 ``[1, 3, H, W]`` in [-1, 1]."""
    from alg_tpu_torch.pipelines import processing

    if not isinstance(img, np.ndarray):
        return processing.preprocess_image(img, height, width)
    if img.dtype == np.uint8:  # an RGB array at its own size, as cli.run takes it
        return processing.preprocess_image(img, *img.shape[:2])
    return np.asarray(img, np.float32)  # already preprocessed


def hunyuan_size(resolution: str, image):
    """HunyuanVideo's (height, width) bucket at ``resolution`` for ``image``'s
    aspect ratio: a PIL image's size, or an array's height and width."""
    from alg_tpu_torch.alg.hunyuan_size import get_hunyuan_video_size

    if isinstance(image, np.ndarray):
        h, w = image.shape[:2] if image.dtype == np.uint8 else image.shape[-2:]
        image = types.SimpleNamespace(size=(w, h))
    return get_hunyuan_video_size(resolution, image)


def _preprocess_images(requests, height, width, attr: str = "image") -> np.ndarray:
    return np.concatenate([_to_pipeline_image(getattr(r, attr), height, width) for r in requests], axis=0)


def _encode_cogvideox(pipeline, requests, gen_kwargs):
    prompts = [r.prompt for r in requests]
    negatives = [r.negative_prompt or "" for r in requests]
    return {
        "prompt_embeds": pipeline.encode_prompt(prompts),
        "negative_prompt_embeds": pipeline.encode_prompt(negatives),
    }


def _encode_wan(pipeline, requests, gen_kwargs):
    prompts = [r.prompt for r in requests]
    negatives = [r.negative_prompt or "" for r in requests]
    out = {
        "prompt_embeds": pipeline.encode_prompt(prompts),
        "negative_prompt_embeds": pipeline.encode_prompt(negatives),
    }
    if pipeline.clip is not None:
        out["image_embeds"] = torch.cat([pipeline.encode_image(r.image) for r in requests], dim=0)
    return out


def _encode_hunyuan(pipeline, requests, gen_kwargs):
    # Llava's prompt embeds depend on each request's image (the template embeds its image tokens): encode per
    # request, then batch. The config's template and length apply, as in the pipeline's own call.
    enc_kwargs = {}
    if gen_kwargs.get("prompt_template") is not None:
        enc_kwargs["template"] = gen_kwargs["prompt_template"]
    if gen_kwargs.get("max_sequence_length") is not None:
        enc_kwargs["max_sequence_length"] = gen_kwargs["max_sequence_length"]
    if gen_kwargs.get("image_embed_interleave") is not None:
        enc_kwargs["image_embed_interleave"] = gen_kwargs["image_embed_interleave"]

    def encode_all(pairs):
        embeds, pooled, masks = zip(*(pipeline.encode_prompt(image, prompt, **enc_kwargs) for image, prompt in pairs))
        return torch.cat(embeds, dim=0), torch.cat(pooled, dim=0), torch.cat(masks, dim=0)

    out = dict(zip(("prompt_embeds", "pooled_prompt_embeds", "prompt_attention_mask"),
                   encode_all((r.image, r.prompt) for r in requests)))
    if gen_kwargs.get("true_cfg_scale", 1.0) > 1.0:
        # a black image of the run's size (what PIL's Image.new("RGB", (width, height), 0) holds)
        black = np.zeros((gen_kwargs.get("height", 720), gen_kwargs.get("width", 1280), 3), np.uint8)
        out.update(zip(("negative_prompt_embeds", "negative_pooled_prompt_embeds", "negative_prompt_attention_mask"),
                       encode_all((black, r.negative_prompt or "") for r in requests)))
    return out


_ENCODERS = {
    "CogVideoXPipeline": _encode_cogvideox,
    "WanPipeline": _encode_wan,
    "HunyuanVideoPipeline": _encode_hunyuan,
}

_DEFAULT_HW = {
    "CogVideoXPipeline": (480, 720),
    "WanPipeline": (480, 832),
    "HunyuanVideoPipeline": (720, 1280),
}


class _BatchNoise:
    """Draws per request from independent streams, stacked along the batch."""

    def __init__(self, seeds: Sequence[int]):
        self.sources = [NoiseSource(seed=s) for s in seeds]

    def randn(self, shape) -> torch.Tensor:
        n = len(self.sources)
        if shape[0] != n:
            # every pipeline draw leads with the batch; a silent fallback to one stream would correlate samples
            raise ValueError(f"batched serving expected a batch-leading draw of {n}, got shape {tuple(shape)}")
        return torch.stack([s.randn(shape[1:]) for s in self.sources])


def serve_batch(pipeline, requests: Sequence[BatchRequest], mesh=None, sp_mode: Optional[str] = None,
                **gen_kwargs) -> List[Any]:
    """Run a batch of I2V requests through one pipeline call; returns what
    the pipeline returns for the batch (``np`` frames ``[N, F, H, W, 3]``
    unless ``output_type`` says otherwise), in the order of ``requests``.

    Each request's seed drives its own noise stream; prompts are encoded as
    a batch. ``gen_kwargs`` are the pipeline's keywords (a config's
    ``pipeline_kwargs``).

    ``mesh`` arms the pipeline with :func:`shard_pipeline` (unless it is
    armed with that mesh and mode already); a pipeline armed before serves
    on its own mesh. ``sp_mode`` ("gather", "ring" or "ulysses") defaults
    to None, which keeps the pipeline's mode, so a ring- or Ulysses-armed
    pipeline is never put back to gathered keys. Under a mesh the batch
    must divide by dp."""
    family = type(pipeline).__name__
    if family not in _ENCODERS:
        raise ValueError(f"Unsupported pipeline type for serving: {family}")
    if mesh is not None:
        want_mode = pipeline.sp_mode if sp_mode is None else sp_mode
        if pipeline.attn_mesh is not mesh or pipeline.sp_mode != want_mode:
            pipeline = shard_pipeline(pipeline, mesh, sp_mode=want_mode)
    mesh = pipeline.attn_mesh
    if mesh is not None and mesh.size("dp") > 1:
        dp, r = mesh.size("dp"), mesh.local_rank("dp")
        if len(requests) % dp:
            raise ValueError(f"{len(requests)} requests do not lay out on dp={dp}; the batch size must be "
                             "divisible by dp")
        share = len(requests) // dp
        return _gather_batch(_serve(pipeline, family, requests[r * share:(r + 1) * share], gen_kwargs), mesh)
    return _serve(pipeline, family, requests, gen_kwargs)


def _serve(pipeline, family: str, requests, gen_kwargs: dict):
    """One pipeline call over ``requests`` on this rank (its dp share under a mesh)."""
    n = len(requests)
    def_h, def_w = _DEFAULT_HW[family]
    height = gen_kwargs.get("height") or def_h
    width = gen_kwargs.get("width") or def_w
    images = _preprocess_images(requests, height, width)

    n_last = sum(r.last_image is not None for r in requests)
    if n_last:
        if family != "WanPipeline":
            raise ValueError("last_image (FLF2V) is only supported by the Wan pipeline")
        if n_last != n:
            raise ValueError("last_image must be set on ALL requests in a batch or on none "
                             "(the mask/condition layout differs)")
        gen_kwargs["last_image"] = _preprocess_images(requests, height, width, attr="last_image")

    encoded = _ENCODERS[family](pipeline, requests, gen_kwargs)
    return pipeline(image=images, noise_source=_BatchNoise([r.seed for r in requests]), **encoded, **gen_kwargs)


def _gather_batch(out, mesh):
    """Every dp group's share of the batch, in dp order, on every rank."""
    from alg_tpu_torch.sharding.collectives import gather_objects

    parts = gather_objects(out.cpu() if isinstance(out, torch.Tensor) else out, mesh.group("dp"))
    if isinstance(out, torch.Tensor):
        return torch.cat(parts).to(out.device)
    if isinstance(out, np.ndarray):
        return np.concatenate(parts)
    return [item for part in parts for item in part]


def shard_pipeline(pipeline, mesh, sp_mode: str = "gather"):
    """A copy of ``pipeline`` whose DiT holds this rank's shards over
    ``mesh`` (``sharding.partition.shard_transformer``; the family's specs)
    and whose DiT calls run under the mesh with ``sp_mode`` on its sp axis:
    ``"gather"`` (keys and values all-gathered), ``"ring"`` (ring
    attention over the flash kernel's LSE) or ``"ulysses"`` (all-to-all
    head exchange; needs the local heads to divide by sp, else gathered).
    The encoders and the VAE stay whole on every rank; the tiled decode
    spreads its tiles over the ranks that hold the same latents. A pipeline
    already armed with ``mesh`` only changes its mode; one armed with
    another mesh raises."""
    from alg_tpu_torch.ops.attention import SEQ_MODES
    from alg_tpu_torch.sharding.partition import shard_transformer

    if sp_mode not in SEQ_MODES:
        raise ValueError(f"sp_mode {sp_mode!r} (want one of {SEQ_MODES})")
    if pipeline.attn_mesh is mesh:
        return dataclasses.replace(pipeline, sp_mode=sp_mode)
    if pipeline.attn_mesh is not None:
        raise ValueError("the pipeline is sharded over another mesh; shard the unsharded pipeline")
    return dataclasses.replace(pipeline, transformer=shard_transformer(pipeline.transformer, mesh), attn_mesh=mesh,
                               sp_mode=sp_mode)
