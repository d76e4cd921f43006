"""Video export on the host (the port's copy of ``alg_tpu/io/video.py``).

The reference encodes H.264 via torchvision/PyAV with ``crf=18, preset=slow``
(``run.py:127-133``). Fallback ladder when ffmpeg/av are unavailable:

  1. system ``ffmpeg`` binary → H.264 mp4, same codec parameters;
  2. pure-Python MJPEG-AVI (PIL JPEG frames in a RIFF container) — a real
     true-color video file every player handles, no external deps;
  3. GIF (256-color) when the caller explicitly asks for ``.gif``;
  4. raw ``.npy`` frames when PIL itself is missing.
"""

from __future__ import annotations

import os
import shutil
import subprocess

import numpy as np


def _frames_to_uint8(frames) -> np.ndarray:
    """List of PIL images or [F, H, W, C] float/uint8 array → uint8 array."""
    if isinstance(frames, (list, tuple)):
        arr = np.stack([np.asarray(f) for f in frames])
    else:
        arr = np.asarray(frames)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0, 1) * 255).round().astype(np.uint8)
    return arr


def write_mjpeg_avi(path: str, arr: np.ndarray, fps: int, quality: int = 92) -> str:
    """Pure-Python MJPEG-in-RIFF/AVI writer: each frame a PIL-encoded JPEG in
    a ``00dc`` chunk with an ``idx1`` keyframe index. [F, H, W, 3] uint8."""
    import io
    import struct

    from PIL import Image

    f_count, h, w, _ = arr.shape
    jpegs = []
    for fr in arr:
        buf = io.BytesIO()
        Image.fromarray(fr).save(buf, format="JPEG", quality=quality)
        jpegs.append(buf.getvalue())

    def chunk(fourcc: bytes, data: bytes) -> bytes:
        pad = b"\x00" if len(data) % 2 else b""
        return fourcc + struct.pack("<I", len(data)) + data + pad

    def lst(fourcc: bytes, data: bytes) -> bytes:
        return b"LIST" + struct.pack("<I", 4 + len(data)) + fourcc + data

    max_bytes = max(len(j) for j in jpegs)
    avih = struct.pack(
        "<14I",
        int(1_000_000 // fps),  # dwMicroSecPerFrame
        max_bytes * fps,  # dwMaxBytesPerSec
        0,  # dwPaddingGranularity
        0x10,  # dwFlags: AVIF_HASINDEX
        f_count, 0, 1, max_bytes,  # frames, initial, streams, sugg. buffer
        w, h, 0, 0, 0, 0,  # width, height, reserved[4]
    )
    strh = (
        b"vids" + b"MJPG"
        + struct.pack("<IHHIIIIIIiI", 0, 0, 0, 0, 1, fps, 0, f_count, max_bytes, -1, 0)
        + struct.pack("<4h", 0, 0, w, h)
    )
    strf = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, b"MJPG", w * h * 3, 0, 0, 0, 0)
    hdrl = lst(b"hdrl", chunk(b"avih", avih) + lst(b"strl", chunk(b"strh", strh) + chunk(b"strf", strf)))

    movi_items = b"".join(chunk(b"00dc", j) for j in jpegs)
    movi = lst(b"movi", movi_items)

    idx = b""
    off = 4  # offset of each 00dc fourcc relative to 'movi'
    for j in jpegs:
        idx += b"00dc" + struct.pack("<III", 0x10, off, len(j))  # AVIIF_KEYFRAME
        off += 8 + len(j) + (len(j) % 2)
    idx1 = chunk(b"idx1", idx)

    body = b"AVI " + hdrl + movi + idx1
    with open(path, "wb") as fh:
        fh.write(b"RIFF" + struct.pack("<I", len(body)) + body)
    return path


def write_video(output_path: str, frames, fps: int) -> str:
    """Write frames; returns the actual path written (extension may change
    when falling back). H.264 crf 18 preset slow when ffmpeg is available."""
    arr = _frames_to_uint8(frames)
    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is not None:
        f, h, w, _ = arr.shape
        cmd = [
            ffmpeg, "-y", "-f", "rawvideo", "-pix_fmt", "rgb24",
            "-s", f"{w}x{h}", "-r", str(fps), "-i", "-",
            "-c:v", "libx264", "-crf", "18", "-preset", "slow",
            "-pix_fmt", "yuv420p", output_path,
        ]
        proc = subprocess.run(cmd, input=arr.tobytes(), capture_output=True)
        if proc.returncode == 0:
            return output_path
        raise RuntimeError(f"ffmpeg failed: {proc.stderr.decode()[-500:]}")

    base, ext = os.path.splitext(output_path)
    try:
        from PIL import Image  # noqa: F401 — probe PIL availability

        if ext.lower() == ".gif":
            imgs = [Image.fromarray(f) for f in arr]
            imgs[0].save(
                output_path, save_all=True, append_images=imgs[1:],
                duration=int(1000 / fps), loop=0,
            )
            return output_path
        # true-color fallback: MJPEG-AVI (every player decodes it; unlike the
        # old GIF fallback it keeps full color depth)
        return write_mjpeg_avi(base + ".avi", arr, fps)
    except ImportError:
        os.makedirs(base, exist_ok=True)
        for i, f in enumerate(arr):
            np.save(os.path.join(base, f"frame_{i:04d}.npy"), f)
        return base
