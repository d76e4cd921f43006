"""Image and video pre/post-processing on the host (counterpart of
``alg_tpu/pipelines/processing.py``).

Images become fp32 ``[1, 3, H, W]`` in [-1, 1]; decoded frames in [-1, 1]
map back to [0, 1], as arrays or as PIL frames. ``PIL`` is imported only
where a PIL image is handled or made.
"""

from __future__ import annotations

import numpy as np


def preprocess_image(image, height: int, width: int) -> np.ndarray:
    """PIL image or array -> fp32 ``[1, 3, H, W]`` in [-1, 1]. A PIL image is
    resized (Lanczos); an array must already be ``height`` x ``width``."""
    if type(image).__module__.startswith("PIL."):
        from PIL import Image

        image = image.convert("RGB").resize((width, height), resample=Image.LANCZOS)
        arr = np.asarray(image).astype(np.float32) / 255.0
    else:
        arr = np.asarray(image, dtype=np.float32)
        if arr.max() > 1.5:
            arr = arr / 255.0
        if arr.shape[0] == 3 and arr.ndim == 3:
            arr = arr.transpose(1, 2, 0)
        if arr.shape[:2] != (height, width):
            raise ValueError(f"Array input must already be {height}x{width} (got {arr.shape[:2]}); "
                             "pass a PIL image for resizing")
    return (arr * 2.0 - 1.0).transpose(2, 0, 1)[None]


def postprocess_video(frames: np.ndarray, output_type: str = "np"):
    """``[B, F, C, H, W]`` fp32 in [-1, 1] -> ``"np"``: ``[B, F, H, W, C]`` in
    [0, 1]; ``"pil"``: one list of RGB PIL frames a sample (the reference's
    default); ``"latent"``: ``frames`` unchanged.

    The port's pipelines default to ``"np"``, not to the reference's
    ``"pil"``: the GPU machines the port runs on have not always had PIL,
    and an array needs no conversion on the way to ``io/video.write_video``."""
    if output_type == "latent":
        return frames
    video = np.clip(frames / 2.0 + 0.5, 0.0, 1.0)
    if output_type == "np":
        return video.transpose(0, 1, 3, 4, 2)
    if output_type == "pil":
        from PIL import Image

        return [[Image.fromarray(f) for f in (v.transpose(0, 2, 3, 1) * 255).round().astype(np.uint8)]
                for v in video]
    raise ValueError(f"Unknown output_type {output_type!r}")


def validate_attention_kwargs(attention_kwargs) -> None:
    """The reference pipelines' ``attention_kwargs`` passthrough carries the
    per-call LoRA ``scale`` to the attention processors. Here adapters are
    merged into the weights before the run, so ``scale == 1.0`` (the
    default, equal to merged weights) is accepted as a no-op; any other
    value, or any other key, is refused rather than silently dropped."""
    if attention_kwargs is None:
        return
    kw = dict(attention_kwargs)
    scale = kw.pop("scale", None)
    if kw:
        raise ValueError(f"Unsupported attention_kwargs keys {sorted(kw)}; supported: ['scale']")
    if scale is not None and scale != 1.0:
        raise ValueError("attention_kwargs['scale'] != 1.0: apply the LoRA scale when merging the adapter")
