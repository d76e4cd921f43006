"""PyTorch/CUDA port of alg_tpu: the CogVideoX-5b-I2V sampler with adaptive
low-pass guidance, with hand-written Hopper kernels under ``csrc/``.

Imports ``torch`` and never ``jax``.
"""
