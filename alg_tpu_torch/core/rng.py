"""Torch-ordered noise (counterpart of ``alg_tpu/core/rng.py``).

The reference threads one CPU ``torch.Generator`` seeded from the run's seed
through every draw (VAE posterior sample first, then the initial latents).
Here that generator is the real one, so the stream is torch's by
construction; ``alg_tpu.core.torch_rng`` reimplements the same stream in
numpy, and the tests hold the two bit-equal. Draws happen on the CPU and
the caller moves them to its device.
"""

from __future__ import annotations

from typing import Sequence

import torch


class NoiseSource:
    """Sequential draws from one ``torch.Generator("cpu")`` per run."""

    def __init__(self, seed: int = 42):
        self.seed = seed
        self._gen = torch.Generator("cpu").manual_seed(seed)

    def randn(self, shape: Sequence[int]) -> torch.Tensor:
        """Standard-normal fp32 CPU tensor of ``shape``."""
        return torch.randn(tuple(shape), generator=self._gen, dtype=torch.float32)
