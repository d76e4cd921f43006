"""Image and video pre/post-processing on the host (counterpart of
``alg_tpu/pipelines/processing.py``).

Images become fp32 ``[1, 3, H, W]`` in [-1, 1]; decoded frames in [-1, 1]
map back to [0, 1]. ``PIL`` is imported only where a PIL image is handled.
PIL frame output is not ported yet.
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


def postprocess_video(frames: np.ndarray) -> np.ndarray:
    """``[B, F, C, H, W]`` fp32 in [-1, 1] -> ``[B, F, H, W, C]`` in [0, 1]
    (the reference's ``output_type="np"``)."""
    return np.clip(frames / 2.0 + 0.5, 0.0, 1.0).transpose(0, 1, 3, 4, 2)


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
