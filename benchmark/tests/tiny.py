"""Tiny configurations and traffic of the benchmark's two cells, for running the harness on the CPU."""

import copy
import time

from benchmark import manifest as mf
from benchmark import run

TINY_DIT = {"num_attention_heads": 2, "attention_head_dim": 16, "in_channels": 8, "out_channels": 4,
            "time_embed_dim": 16, "text_embed_dim": 16, "num_layers": 2, "attention_bias": True, "sample_width": 8,
            "sample_height": 8, "patch_size": 2, "patch_size_t": None, "max_text_seq_length": 16, "norm_eps": 1e-5,
            "use_rotary_positional_embeddings": True}
TINY_VAE = {"block_out_channels": [8, 16, 16, 16], "latent_channels": 4, "layers_per_block": 1, "norm_num_groups": 4,
            "norm_eps": 1e-6, "temporal_compression_ratio": 4, "scaling_factor": 0.7, "invert_scale_latents": False}
CELLS = ("cogvideox-5b-i2v.alg-49f", "cogvideox1.5-5b-i2v.noalg-81f")


def tiny_spec(cell: str, dtype: str = "float32") -> mf.CellSpec:
    """The cell's spec with its configuration cut to tiny widths (1.5's options kept) and its traffic
    to 9 frames at 64 x 64, 16 text tokens; steps, CFG and the ALG schedule as the cell's."""
    spec = mf.cell_spec(mf.load_manifest(), cell)
    cfg = copy.deepcopy(spec.config)
    dit = dict(TINY_DIT)
    if cfg["transformer"].get("patch_size_t") is not None:
        dit.update(patch_size_t=2, ofs_embed_dim=16)
    cfg["transformer"] = dit
    cfg["vae"] = {**TINY_VAE, "invert_scale_latents": cfg["vae"]["invert_scale_latents"]}
    cfg["dtypes"] = {"transformer": dtype, "vae": "float32"}
    traffic = {**spec.traffic, "height": 64, "width": 64, "num_frames": 9, "text_tokens": 16}
    spec.config, spec.traffic = cfg, traffic
    return spec


def run_tiny(cell: str, seed: int = 7, seconds: float = 0.0, dtype: str = "float32"):
    """One run of the harness on the CPU at the tiny size: ``execute`` past the look for a card."""
    spec = tiny_spec(cell, dtype)
    c = run.Cell(name=cell, config=spec.config, traffic=spec.traffic, seed=seed, seconds=seconds, trace=False,
                 device="cpu", t_process=time.time())
    return run.execute(c, spec)
