"""Sampling entry point (counterpart of ``alg_tpu/cli.py``).

The reference ``run.py``'s surface: the same flags and defaults, the same
YAML schema and merge (``{**generation, **alg}`` with None dropped), the
fixed seed 42, the model family by a substring of ``model.path``, Wan's
``flow_shift`` keyed on a string compare against the config's height (so
always 5.0 with the shipped configs, as in the reference), HunyuanVideo's
height and width bucketed from the input image when the config names a
``video.resolution``, and H.264 at crf 18 when ffmpeg is present::

    python -m alg_tpu_torch.cli --config configs/cogvideox_alg.yaml \\
        --model_cache_dir /path/to/checkpoints --image_path image.jpg --prompt "..."

(``alg-tpu-torch`` is the same as a console script.) The checkpoint is a
local HF-layout directory (``io/model_zoo.py``); nothing is downloaded.
Everything runs on ``--device`` (``cuda`` unless asked otherwise);
``--random_init`` draws every tensor from a seed at the checkpoint's shapes
instead of reading it, for smoke runs. ``--lora`` merges a peft-layout
adapter (``.npz`` or ``.safetensors``) into the DiT, ``--quantize w8|w4``
makes the DiT's big block linears W8A8 / W4A8 at load (``ops/quant.py``;
not together with ``--lora``), ``--int8_attn`` routes
DiT self-attention through the int8 kernel, ``--guidance_microbatch``
splits Wan's guidance passes and ``--checkpoint_path`` snapshots the denoise
loop (``io/runstate.py``): the same command run again after an interruption
resumes it.

:func:`run` is the body: it also takes an already parsed config (the YAML
file's mapping) and an RGB uint8 image array, for machines without PyYAML
or PIL, and returns the path written.
"""

from __future__ import annotations

import argparse
import logging
import sys

import numpy as np

logger = logging.getLogger(__name__)


def load_pipeline(cfg, model_cache_dir=None, quantize=None, lora=None, lora_scale=1.0, device="cuda",
                  random_init=False, timings=None):
    """The family's pipeline from its checkpoint directory on ``device``,
    with its DiT's block linears quantized (``quantize``: "w8" | "w4") or a
    peft-layout adapter (``lora``: ``.npz`` or ``.safetensors``) merged into
    the DiT at ``lora_scale``. ``timings``: see
    :func:`alg_tpu_torch.io.model_zoo.load_cogvideox_pipeline`."""
    from alg_tpu_torch.io import model_zoo

    if lora is not None and quantize is not None:
        raise ValueError(
            "--lora with --quantize is unsupported: adapters must merge into "
            "the float kernels before quantization. Merge offline "
            "(alg_tpu_torch.io.lora), save the tree, then quantize that checkpoint."
        )
    model_dir = model_zoo.resolve_model_dir(cfg.model_path, model_cache_dir)
    family = cfg.family
    common = dict(dtype=cfg.model_dtype, quantize=quantize, device=device, random_init=random_init, timings=timings)
    if family == "cogvideox":
        pipe = model_zoo.load_cogvideox_pipeline(model_dir, **common)
    elif family == "wan":
        # the reference's quirk: a string compare against the config's int height, so 5.0 with shipped configs
        flow_shift = 3.0 if cfg.generation.get("height") == "480" else 5.0
        pipe = model_zoo.load_wan_pipeline(model_dir, flow_shift=flow_shift, **common)
    elif family == "hunyuan":
        pipe = model_zoo.load_hunyuan_pipeline(model_dir, flow_shift=cfg.flow_shift,
                                               invert_sigmas=bool(cfg.flow_reverse), **common)
    else:  # pragma: no cover
        raise ValueError(family)

    if lora is not None:
        import torch

        from alg_tpu_torch.io import lora as io_lora

        merge = {"cogvideox": io_lora.merge_lora_cogvideox, "wan": io_lora.merge_lora_wan,
                 "hunyuan": io_lora.merge_lora_hunyuan}[family]
        if lora.endswith(".safetensors"):  # a diffusers-published adapter file, the same peft names
            from alg_tpu_torch.io.safetensors import load_file

            state = load_file(lora)
        else:
            state = dict(np.load(lora))
        dit = pipe.transformer
        with torch.no_grad():
            dit.load_state_dict(merge(dit.state_dict(), state, scale=lora_scale))
        logger.info("Merged %d LoRA tensors from %s (scale %g)", len(state), lora, lora_scale)
    return pipe


def run(args, config=None, image=None) -> str:
    """Generate the video ``args`` (a :func:`build_parser` namespace) asks
    for and write it; returns the path written (``write_video`` may change
    the extension). ``config``: the parsed YAML mapping, read from
    ``args.config`` when None. ``image``: an RGB uint8 ``[H, W, 3]`` array
    at the generated size, or a PIL image; ``args.image_path`` opened with
    PIL when None."""
    from alg_tpu_torch.core.config import load_run_config, run_config_from_dict
    from alg_tpu_torch.io.video import write_video
    from alg_tpu_torch.ops.attention import get_attention_int8, set_attention_int8

    cfg = run_config_from_dict(config) if config is not None else load_run_config(args.config)
    logger.info("Using device: %s", args.device)
    family = cfg.family
    int8_before = get_attention_int8()
    if args.int8_attn:
        set_attention_int8(args.int8_attn)
    try:
        pipe = load_pipeline(cfg, args.model_cache_dir, quantize=args.quantize, lora=args.lora,
                             lora_scale=args.lora_scale, device=args.device, random_init=args.random_init)
        if args.guidance_microbatch and hasattr(pipe, "guidance_microbatch"):
            pipe.guidance_microbatch = args.guidance_microbatch
        logger.info("Pipeline loaded successfully.")

        input_image = image
        if input_image is None:
            from PIL import Image

            input_image = Image.open(args.image_path).convert("RGB")
        pipe_image = input_image
        if isinstance(input_image, np.ndarray):  # the pipelines take arrays as [B, 3, H, W] in [-1, 1]
            from alg_tpu_torch.pipelines.processing import preprocess_image

            pipe_image = preprocess_image(input_image, *input_image.shape[:2])
        pipe_kwargs = {"image": pipe_image, "prompt": args.prompt, "seed": 42}
        pipe_kwargs.update(cfg.pipeline_kwargs)
        if args.checkpoint_path:
            pipe_kwargs["checkpoint"] = args.checkpoint_path
        if family == "hunyuan" and "resolution" in (cfg.video or {}):
            # height and width bucketed from the image's aspect ratio; an explicit generation.height / width
            # applies when the config names no video.resolution
            from alg_tpu_torch.serving import hunyuan_size

            pipe_kwargs["height"], pipe_kwargs["width"] = hunyuan_size(cfg.video["resolution"], input_image)

        logger.info("Starting video generation...")
        logger.info("Pipeline arguments: %s", {k: v for k, v in pipe_kwargs.items() if k != "image"})
        frames = pipe(**pipe_kwargs)[0]  # [F, H, W, 3] in [0, 1] for batch 0
    finally:
        set_attention_int8(int8_before)
    logger.info("Video generation complete. Received %d frames.", len(frames))

    out = write_video(args.output_path, frames, fps=cfg.video["fps"])
    logger.info("Saving video to: %s", out)
    logger.info("Video saved successfully. Run complete.")
    return out


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Arguments")
    parser.add_argument("--config", type=str, default="./configs/hunyuan_video_alg.yaml")
    parser.add_argument("--image_path", type=str,
                        default="./assets/a red double decker bus driving down a street.jpg")
    parser.add_argument("--prompt", type=str, default="a red double decker bus driving down a street")
    parser.add_argument("--output_path", type=str, default="output.mp4")
    parser.add_argument("--model_cache_dir", type=str, default=None)
    parser.add_argument("--quantize", type=str, choices=("w8", "w4"), default=None,
                        help="quantize the DiT blocks at load: W8A8 (w8) or W4A8 int4 storage (w4); "
                             "not with --lora")
    parser.add_argument("--int8_attn", type=str, choices=("qk", "full"), default=None,
                        help="run DiT self-attention through the int8 kernel (qk = int8 QK^T logits, "
                             "full = both attention products in int8)")
    parser.add_argument("--checkpoint_path", type=str, default=None,
                        help="denoise-state snapshot file: saved during the run, resumed by the same command")
    parser.add_argument("--guidance_microbatch", type=int, default=0,
                        help="run the CFG/ALG guidance passes in micro-batches of N samples instead of one "
                             "batched forward (Wan family)")
    parser.add_argument("--lora", type=str, default=None,
                        help="peft-layout adapter (.npz or .safetensors) merged into the DiT before generation")
    parser.add_argument("--lora_scale", type=float, default=1.0)
    parser.add_argument("--device", type=str, default="cuda", help="torch device to run on (cuda unless asked)")
    parser.add_argument("--random_init", action="store_true",
                        help="random weights from a seed at the checkpoint's shapes instead of its tensors "
                             "(configs and tokenizers are still read)")
    return parser


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(asctime)s - %(levelname)s - %(message)s", stream=sys.stdout)
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
