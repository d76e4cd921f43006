"""Layer: the VAE encode of the request's conditioning frame (``models/cogvideox/vae.py`` through
``CogVideoXPipeline.vae_encode_sample``), read from the program's ``vae.encode`` span: its milliseconds on
the device's clock (CUDA events), once a request. A part of ``request_prep_ms.sample``."""

from benchmark import program_spans as ps


def read(view):
    records = ps.window_spans(view)
    if records is None or not any(r["name"] == "vae.encode" for r in records):
        return None
    return ps.total_ms(records, "vae.encode")
