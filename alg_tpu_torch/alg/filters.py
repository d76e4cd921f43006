"""Low-pass filters in their direct form (counterpart of ``alg_tpu/alg/filters.py``).

The reference's ``apply_low_pass_filter`` semantics:

  * ``filter_type`` in {"none", "down_up", "gaussian_blur"}, with no-op
    early exits for ``none``, ``down_up`` at resize factor 1 and
    ``gaussian_blur`` at sigma 0;
  * 4D ``[B, C, H, W]`` and 5D ``[B, C, F, H, W]`` inputs (any leading dims)
    are filtered over the trailing (H, W) dims, frame by frame;
  * ``gaussian_blur``: a float kernel size is relative to H and forced odd;
    torchvision's kernel, reflect padding, a separable depthwise convolution;
  * ``down_up``: antialiased bilinear resize (half-pixel centres) to
    ``max(1, round(d·f))`` and back, ``F.interpolate`` both ways.

The denoise loops filter with the operator form of
:mod:`alg_tpu_torch.alg.matrices` instead; this form serves one-off filtering
and holds the operators to what they stand for.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from alg_tpu_torch.alg.matrices import _reflect_index, gaussian_kernel_1d, resolve_kernel_size


def _reflect_pad(x: torch.Tensor, pad: int, dim: int) -> torch.Tensor:
    """PyTorch/numpy 'reflect' padding of ``pad`` along ``dim``, for any pad
    (a pad past the edge reflects again, as ``np.pad`` does)."""
    n = x.shape[dim]
    idx = torch.tensor([_reflect_index(i - pad, n) for i in range(n + 2 * pad)], device=x.device)
    return x.index_select(dim, idx)


def _separable_blur(x: torch.Tensor, kernel) -> torch.Tensor:
    """Depthwise separable Gaussian blur over the trailing (H, W) dims."""
    k = kernel.shape[0]
    pad = k // 2
    lead, (h, w) = x.shape[:-2], x.shape[-2:]
    xp = _reflect_pad(_reflect_pad(x.reshape(-1, 1, h, w), pad, 2), pad, 3)  # [N, 1, H+2p, W+2p]
    kern = torch.as_tensor(kernel, dtype=x.dtype, device=x.device)
    y = F.conv2d(xp, kern.view(1, 1, k, 1))
    y = F.conv2d(y, kern.view(1, 1, 1, k))
    return y.reshape(*lead, h, w)


def _down_up(x: torch.Tensor, resize_factor: float) -> torch.Tensor:
    lead, (h0, w0) = x.shape[:-2], x.shape[-2:]
    h1, w1 = max(1, int(round(h0 * resize_factor))), max(1, int(round(w0 * resize_factor)))
    y = x.reshape(-1, 1, h0, w0)
    y = F.interpolate(y, size=(h1, w1), mode="bilinear", align_corners=False, antialias=True)
    y = F.interpolate(y, size=(h0, w0), mode="bilinear", align_corners=False, antialias=True)
    return y.reshape(*lead, h0, w0)


def apply_low_pass_filter(tensor: torch.Tensor, filter_type: str, blur_sigma: float = 0.0, blur_kernel_size=3,
                          resize_factor: float = 1.0) -> torch.Tensor:
    """The selected low-pass filter over the trailing (H, W) dims."""
    if filter_type == "none":
        return tensor
    if filter_type == "down_up" and resize_factor == 1.0:
        return tensor
    if filter_type == "gaussian_blur" and blur_sigma == 0:
        return tensor
    if filter_type == "gaussian_blur":
        kernel_val = resolve_kernel_size(blur_kernel_size, tensor.shape[-2])
        return _separable_blur(tensor, gaussian_kernel_1d(kernel_val, blur_sigma))
    if filter_type == "down_up":
        return _down_up(tensor, resize_factor)
    raise ValueError(f"Unknown filter_type: {filter_type!r}")
