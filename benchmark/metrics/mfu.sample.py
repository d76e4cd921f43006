"""Layer: the model step (``models/cogvideox/transformer.py``). Share of the card's bf16 peak
(989 TFLOP/s) that the window's DiT forwards reach: their model FLOPs (``benchmark.flops.dit_forward_flops``:
``24·S·d²`` a block for the linears, ``4·S²·d`` a block for attention, and the embeddings, per pass)
over the traced window's wall time, in percent."""

from benchmark import flops


def read(view):
    if not view.forwards:
        return None
    work = sum(f["passes"] * flops.dit_forward_flops(view.dit_cfg, f["s_text"], f["s_video"]) for f in view.forwards)
    return work / view.trace.window_s / flops.PEAK_FLOPS_BF16 * 100.0
