"""Latent precompute for fine-tuning (counterpart of ``alg_tpu/prepare_cli.py``;
``alg-tpu-torch-prepare``): prepare -> ``alg-tpu-torch-train --data`` ->
``alg-tpu-torch --lora``.

Training runs over precomputed latents (frozen VAE and text encoders,
``training/losses.py``); this tool writes them. It reads a JSONL manifest of
(video, prompt) pairs, runs each clip through the encode paths the
pipelines use (the mode of the VAE posterior with the family's scaling or
normalisation, tiled automatically for long clips; the text and image
encoders with their quirks: UMT5 trimmed and re-padded, the Llava template
crop, CLIP vision's penultimate states) and writes one
``example_{i:05d}.npz`` per example with exactly the loss's batch keys:

* cogvideox: ``latents [F', C, h, w]`` (the scaled mode of the clip),
  ``image_latents [F', C, h, w]`` (the first frame's, zero past latent
  frame 0), ``encoder_hidden_states [S, text_dim]`` (T5, no mask);
* wan: ``latents [z, F', h, w]`` (normalised by ``latents_mean``/``std``),
  ``condition [20, F', h, w]`` (the mask block and the first-frame
  condition latent; with ``--flf2v`` or the manifest key ``"flf2v"`` the
  last frame too), ``encoder_hidden_states [S, text_dim]`` (UMT5) and,
  when the DiT takes one, ``encoder_hidden_states_image [257, image_dim]``
  (CLIP vision);
* hunyuan: ``latents [z, F', h, w]`` (scaled), ``image_latents [z, 1, h,
  w]``, ``encoder_hidden_states`` and the int32 ``encoder_attention_mask``
  (the Llava path), ``pooled_projections`` (CLIP text).

Arrays are float32, as the JAX package writes them. A clip is a directory of
frame images (sorted), a ``.npy``/``.npz`` array ``[F, H, W, 3]`` (uint8, or
float in [0, 1] or [-1, 1]) or one image (a 1-frame clip); frame counts are
cut to the families' ``4k + 1``. Frames not at the generated size are
resized with PIL (lanczos); an array at that size needs no PIL. Manifest
line: ``{"video": <path>, "prompt": <str>}``::

    python -m alg_tpu_torch.prepare_cli --config configs/wan_alg.yaml \\
        --model_cache_dir /path/to/checkpoints --manifest clips.jsonl --output_dir latents/

Everything runs on ``--device`` (``cuda`` unless asked otherwise). :func:`run`
is the body, callable with an already parsed config.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import types

import numpy as np
import torch

logger = logging.getLogger(__name__)

_IMG_EXT = (".png", ".jpg", ".jpeg", ".bmp", ".webp")
_MAX_SEQ = {"cogvideox": 226, "wan": 512, "hunyuan": 256}


def load_frames(path: str):
    """Clip -> a list of PIL images (a frames directory or one image) or the
    array ``[F, H, W, 3]`` of a ``.npy``/``.npz`` file."""
    if os.path.isdir(path):
        from PIL import Image

        names = sorted(n for n in os.listdir(path) if n.lower().endswith(_IMG_EXT))
        if not names:
            raise FileNotFoundError(f"no frame images under {path}")
        return [Image.open(os.path.join(path, n)) for n in names]
    if path.lower().endswith((".npy", ".npz")):
        arr = np.load(path)
        if hasattr(arr, "files"):  # npz: "frames" or the first array
            key = "frames" if "frames" in arr.files else arr.files[0]
            arr = arr[key]
        if arr.ndim != 4 or arr.shape[-1] != 3:
            raise ValueError(f"{path}: expected [F, H, W, 3], got {arr.shape}")
        return arr
    if path.lower().endswith(_IMG_EXT):
        from PIL import Image

        logger.warning("%s is a single image; writing a 1-frame clip", path)
        return [Image.open(path)]
    raise ValueError(f"unsupported clip input {path!r} (frames dir, .npy/.npz, or image)")


def frames_to_tensor(frames, height: int, width: int) -> np.ndarray:
    """-> fp32 ``[F, 3, H, W]`` in [-1, 1] through the pipelines' preprocessing.

    An array above 1.5 is taken as uint8 range (/255), one without negatives
    as [0, 1] (x2 - 1). An array not at ``height`` x ``width`` goes to uint8
    frames and through PIL for the lanczos resize."""
    if isinstance(frames, np.ndarray):
        arr = frames.astype(np.float32)
        if arr.max() > 1.5:
            arr = arr / 255.0
        if arr.min() >= 0.0:
            arr = arr * 2.0 - 1.0
        if arr.shape[1:3] == (height, width):
            return arr.transpose(0, 3, 1, 2)
        try:
            from PIL import Image
        except ImportError as e:
            raise ImportError(f"frames of {arr.shape[1]}x{arr.shape[2]} must be resized to {height}x{width}, which "
                              "needs PIL (Pillow); or pass frames at the generated size") from e
        frames = [Image.fromarray(((f + 1.0) * 127.5).clip(0, 255).astype(np.uint8)) for f in arr]
    return np.concatenate([frames_to_tensor_one(f, height, width) for f in frames], axis=0)


def frames_to_tensor_one(frame, height: int, width: int) -> np.ndarray:
    from alg_tpu_torch.pipelines.processing import preprocess_image

    return preprocess_image(frame, height, width)


def coerce_frames(frames_fchw: np.ndarray) -> np.ndarray:
    """Cut to the ``4k + 1`` frame rule all three families share."""
    f = frames_fchw.shape[0]
    keep = (f - 1) // 4 * 4 + 1
    if keep != f:
        logger.warning("clip has %d frames; truncating to %d (4k+1 rule)", f, keep)
    return frames_fchw[:keep]


class _ZeroNoise:
    """A noise source of zeros: the posterior draw is then its mode
    (deterministic latents, the usual precompute choice)."""

    def randn(self, shape) -> torch.Tensor:
        return torch.zeros(tuple(shape), dtype=torch.float32)


def _np(t: torch.Tensor, dtype=np.float32) -> np.ndarray:
    return t.detach().float().cpu().numpy().astype(dtype)


@torch.no_grad()
def encode_cogvideox(pipe, frames: np.ndarray, prompt: str, max_seq: int) -> dict:
    def enc(clip_bfchw):  # the mode, [B, F', C, h, w], scaled (divided under invert_scale_latents)
        return pipe._scale_latents(pipe.vae_encode_sample(clip_bfchw, _ZeroNoise()))

    z = enc(frames[None])
    zi = enc(frames[:1][None])
    zi = torch.cat([zi, zi.new_zeros((1, z.shape[1] - 1) + tuple(zi.shape[2:]))], dim=1)
    embeds = pipe.encode_prompt([prompt], max_seq)
    return {"latents": _np(z[0]), "image_latents": _np(zi[0]), "encoder_hidden_states": _np(embeds[0])}


@torch.no_grad()
def encode_wan(pipe, frames: np.ndarray, prompt: str, max_seq: int, flf2v: bool = False) -> dict:
    f = frames.shape[0]
    latents = pipe._encode_video_condition(torch.from_numpy(frames[None]).to(pipe.device))  # the mode, normalised
    # FLF2V: the condition holds the first AND the last frame, which trains the first-last-frame-to-video objective
    condition = pipe._build_condition(frames[:1], 1, f, frames[-1:] if flf2v else None)
    out = {"latents": _np(latents[0]), "condition": _np(condition[0]),
           "encoder_hidden_states": _np(pipe.encode_prompt([prompt], max_seq)[0])}
    if pipe.transformer.cfg.image_dim is not None:
        out["encoder_hidden_states_image"] = _np(pipe.encode_image(frames[:1])[0])
    return out


@torch.no_grad()
def encode_hunyuan(pipe, frames: np.ndarray, prompt: str, max_seq: int) -> dict:
    z = pipe._encode_mode(torch.from_numpy(frames[None]).to(pipe.device))  # scaled mode, [B, z, F', h, w]
    zi = pipe._encode_mode(torch.from_numpy(frames[:1][None]).to(pipe.device))
    embeds, pooled, mask = pipe.encode_prompt(frames[:1], prompt, max_sequence_length=max_seq)
    return {"latents": _np(z[0]), "image_latents": _np(zi[0]), "encoder_hidden_states": _np(embeds[0]),
            "encoder_attention_mask": _np(mask[0], np.int32), "pooled_projections": _np(pooled[0])}


_ENCODERS = {"cogvideox": encode_cogvideox, "wan": encode_wan, "hunyuan": encode_hunyuan}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="alg_tpu_torch latent precompute for fine-tuning")
    p.add_argument("--config", type=str, required=True, help="run-style YAML (model and generation sections)")
    p.add_argument("--model_cache_dir", type=str, default=None)
    p.add_argument("--manifest", type=str, default=None, help='JSONL: {"video": path, "prompt": str} per line')
    p.add_argument("--video", type=str, default=None, help="one clip (instead of --manifest)")
    p.add_argument("--prompt", type=str, default=None, help="the prompt of --video")
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--limit", type=int, default=0, help="stop after N examples (0 = all)")
    p.add_argument("--flf2v", action="store_true",
                   help='Wan: condition on the first AND the last frame; the manifest key "flf2v" sets it per clip')
    p.add_argument("--device", type=str, default="cuda", help="torch device to run on (cuda unless asked)")
    return p


def run(args, config=None) -> list:
    """Encode the clips ``args`` (a :func:`build_parser` namespace) names and
    write one ``.npz`` each; returns the paths written. ``config``: the
    parsed YAML mapping, read from ``args.config`` when None."""
    from alg_tpu_torch.cli import load_pipeline
    from alg_tpu_torch.core.config import load_run_config, run_config_from_dict

    cfg = run_config_from_dict(config) if config is not None else load_run_config(args.config)
    family = cfg.family
    if args.manifest:
        with open(args.manifest) as fh:
            items = [json.loads(line) for line in fh if line.strip()]
    elif args.video and args.prompt is not None:
        items = [{"video": args.video, "prompt": args.prompt}]
    else:
        raise ValueError("pass --manifest, or --video with --prompt")
    if args.limit:
        items = items[:args.limit]

    pipe = load_pipeline(cfg, args.model_cache_dir, device=args.device)
    encode = _ENCODERS[family]
    gen = cfg.generation
    height, width = int(gen.get("height") or 480), int(gen.get("width") or 720)
    max_seq = int(gen.get("max_sequence_length") or _MAX_SEQ[family])
    resolution = (cfg.video or {}).get("resolution") if family == "hunyuan" else None

    os.makedirs(args.output_dir, exist_ok=True)
    written = []
    for i, item in enumerate(items):
        frames = load_frames(item["video"])
        if resolution and i == 0:
            # the reference's bucketing, from the FIRST clip's first frame: every clip of a dataset shares it
            from alg_tpu_torch.alg.hunyuan_size import get_hunyuan_video_size

            first = frames[0]
            if isinstance(first, np.ndarray):
                first = types.SimpleNamespace(size=(first.shape[1], first.shape[0]))
            height, width = get_hunyuan_video_size(resolution, first)
            logger.info("Hunyuan bucket: %dx%d", height, width)
        tensor = coerce_frames(frames_to_tensor(frames, height, width))
        extra = {"flf2v": bool(item.get("flf2v", args.flf2v))} if family == "wan" else {}
        example = encode(pipe, np.ascontiguousarray(tensor, np.float32), item["prompt"], max_seq, **extra)
        out_path = os.path.join(args.output_dir, f"example_{i:05d}.npz")
        np.savez(out_path, **example)
        written.append(out_path)
        shapes = {k: tuple(v.shape) for k, v in example.items()}
        logger.info("[%d/%d] %s -> %s %s", i + 1, len(items), item["video"], out_path, shapes)
    logger.info("Wrote %d examples to %s", len(items), args.output_dir)
    return written


def main(argv=None) -> list:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s - %(levelname)s - %(message)s", stream=sys.stdout)
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
