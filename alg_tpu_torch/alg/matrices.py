"""Low-pass filters as separable linear operators (counterpart of
``alg_tpu/alg/matrices.py`` and the kernel helpers of ``alg/filters.py``).

Both reference filter types are linear over the spatial dims and separable:
``filtered = M_h @ x @ M_w^T``. The operators are built on the host in
numpy, one pair per distinct filter setting of a run, and applied in the
denoise loop as one fp32 einsum.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def gaussian_kernel_1d(kernel_size: int, sigma: float) -> np.ndarray:
    """Normalised 1D Gaussian, torchvision construction (linspace over
    ±(ks-1)/2, normalised pdf)."""
    ksize_half = (kernel_size - 1) * 0.5
    x = np.linspace(-ksize_half, ksize_half, kernel_size, dtype=np.float32)
    pdf = np.exp(-0.5 * (x / sigma) ** 2)
    return pdf / pdf.sum()


def resolve_kernel_size(blur_kernel_size, height: int) -> int:
    """A float kernel size is relative to H; the result is forced odd."""
    if isinstance(blur_kernel_size, float):
        kernel_val = max(int(blur_kernel_size * height), 1)
    else:
        kernel_val = int(blur_kernel_size)
    if kernel_val % 2 == 0:
        kernel_val += 1
    return kernel_val


@functools.lru_cache(maxsize=256)
def bilinear_resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """``[out_size, in_size]`` operator of an antialiased bilinear 1D resize
    with half-pixel centres (torch ``F.interpolate(bilinear,
    align_corners=False, antialias=True)``).

    The weights are those of ``jax.image.resize(method="linear",
    antialias=True)``: a triangle kernel widened by the downscale factor,
    each output's weights normalised to sum 1, computed in fp32."""
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))  # the reciprocal in float64, as jax does
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - x)  # [in, out]
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(f32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).T.astype(f32)


@functools.lru_cache(maxsize=256)
def down_up_matrix(size: int, resize_factor: float) -> np.ndarray:
    """``[size, size]`` operator of a down-then-up antialiased bilinear
    resize to ``max(1, round(size·f))`` and back; identity at f = 1."""
    if resize_factor == 1.0:
        return np.eye(size, dtype=np.float32)
    mid = max(1, int(round(size * resize_factor)))
    return (bilinear_resize_matrix(mid, size) @ bilinear_resize_matrix(size, mid)).astype(np.float32)


def _reflect_index(i: int, n: int) -> int:
    """PyTorch 'reflect' padding index (no edge repeat)."""
    if n == 1:
        return 0
    period = 2 * (n - 1)
    i = abs(i) % period
    return period - i if i >= n else i


@functools.lru_cache(maxsize=256)
def gaussian_blur_matrix(size: int, kernel_size: int, sigma: float) -> np.ndarray:
    """``[size, size]`` operator of a 1D Gaussian blur with reflect padding;
    identity at sigma = 0."""
    if sigma == 0:
        return np.eye(size, dtype=np.float32)
    kernel = gaussian_kernel_1d(kernel_size, sigma)
    pad = kernel_size // 2
    m = np.zeros((size, size), dtype=np.float32)
    for i in range(size):
        for t in range(kernel_size):
            m[i, _reflect_index(i + t - pad, size)] += kernel[t]
    return m


def filter_matrices(filter_type: str, height: int, width: int, blur_sigma: float = 0.0,
                    blur_kernel_size=3, resize_factor: float = 1.0):
    """Row/column operators ``(M_h [H,H], M_w [W,W])`` for one filter
    setting; no-op settings give identities. The Gaussian kernel size is
    resolved from H for both dims, as in the reference."""
    eye = (np.eye(height, dtype=np.float32), np.eye(width, dtype=np.float32))
    if filter_type == "none":
        return eye
    if filter_type == "down_up":
        return down_up_matrix(height, resize_factor), down_up_matrix(width, resize_factor)
    if filter_type == "gaussian_blur":
        if blur_sigma == 0:
            return eye
        k = resolve_kernel_size(blur_kernel_size, height)
        return gaussian_blur_matrix(height, k, blur_sigma), gaussian_blur_matrix(width, k, blur_sigma)
    raise ValueError(f"Unknown filter_type: {filter_type!r}")


def apply_filter_matrices(x: torch.Tensor, m_h: torch.Tensor, m_w: torch.Tensor) -> torch.Tensor:
    """``y[..., a, b] = sum_{h,w} m_h[a,h]·x[..., h, w]·m_w[b,w]`` in fp32,
    returned in the input dtype."""
    y = torch.einsum("ah,...hw,bw->...ab", m_h.float(), x.float(), m_w.float())
    return y.to(x.dtype)
