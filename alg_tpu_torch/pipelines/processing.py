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
