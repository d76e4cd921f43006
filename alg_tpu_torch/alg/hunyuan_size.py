"""HunyuanVideo aspect-ratio bucketing on the host (counterpart of
``alg_tpu/alg/hunyuan_size.py``).

The (w, h) bucket list at stride 32 with a largest ratio of 4.0; the bucket
whose aspect ratio is closest to the image's is chosen (ratios >= 1 among
buckets with diff <= 0, ratios < 1 among diff > 0); resolution names map to
base sizes (720p -> 960, 540p -> 720, 360p -> 480).
"""

from __future__ import annotations

import numpy as np

BASE_SIZE = {"720p": 960, "540p": 720, "360p": 480}


def generate_crop_size_list(base_size: int = 256, patch_size: int = 32, max_ratio: float = 4.0):
    num_patches = round((base_size / patch_size) ** 2)
    assert max_ratio >= 1.0
    crop_size_list = []
    wp, hp = num_patches, 1
    while wp > 0:
        if max(wp, hp) / min(wp, hp) <= max_ratio:
            crop_size_list.append((wp * patch_size, hp * patch_size))
        if (hp + 1) * wp <= num_patches:
            hp += 1
        else:
            wp -= 1
    return crop_size_list


def get_closest_ratio(height: float, width: float, ratios, buckets):
    aspect_ratio = float(height) / float(width)
    diff_ratios = ratios - aspect_ratio
    if aspect_ratio >= 1:
        indices = [(i, x) for i, x in enumerate(diff_ratios) if x <= 0]
    else:
        indices = [(i, x) for i, x in enumerate(diff_ratios) if x > 0]
    closest_id = min(indices, key=lambda pair: abs(pair[1]))[0]
    return buckets[closest_id], ratios[closest_id]


def get_hunyuan_video_size(i2v_resolution: str, input_image):
    """The bucket for ``input_image`` (anything with a PIL-style ``.size``
    of (w, h)), as the first and second entry of the chosen bucket."""
    if i2v_resolution not in BASE_SIZE:
        raise ValueError(f"Unknown i2v_resolution {i2v_resolution!r}")
    origin_size = input_image.size
    crop_size_list = generate_crop_size_list(BASE_SIZE[i2v_resolution], 32)
    aspect_ratios = np.array([round(float(h) / float(w), 5) for h, w in crop_size_list])
    closest_size, _ = get_closest_ratio(origin_size[1], origin_size[0], aspect_ratios, crop_size_list)
    return closest_size[0], closest_size[1]
