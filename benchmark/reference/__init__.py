"""Plain PyTorch reference of what the benchmark's cells time, in float32.

Written from diffusers' ``CogVideoXTransformer3DModel``,
``AutoencoderKLCogVideoX`` (encoder), ``CogVideoXImageToVideoPipeline``
(latent preparation, CFG), ``CogVideoXDDIMScheduler`` and the ALG
``lp_utils`` (interval schedule, ``down_up`` filter). It imports nothing of
the program and takes only what the benchmark hands it: weights by their
published names, the conditioning image, the prompt embeddings and the noise
draws. Matrix products run in full float32: :func:`strict_fp32` turns TF32
off. Attention is computed in blocks of query rows, so that it fits on the
card at the cells' lengths.
"""

import torch


def strict_fp32() -> None:
    """No TF32 in matrix products or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
