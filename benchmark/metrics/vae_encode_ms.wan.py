"""Layer: the VAE encode of the request's condition video (``models/wan/vae.py`` through
``WanPipeline._encode_video_condition``, tiled at 81 frames of 480x832 by ``models/vae_tiling.py``), read
from the program's ``vae.encode`` span: its milliseconds on the device's clock, once a request. The span
and its reading are ``vae_encode_ms.sample``'s."""

from benchmark import manifest as mf

read = mf.metric_reader("vae_encode_ms.sample")
