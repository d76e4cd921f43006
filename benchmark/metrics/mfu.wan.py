"""Layer: the model step (``models/wan/transformer.py``). Share of the card's bf16 peak (989 TFLOP/s) that
the window's Wan DiT forwards reach: their model FLOPs (``benchmark.flops_wan.forward_flops``: every linear,
the cross-attention's keys and values over the text and image tokens included, and the self- and
cross-attention products, per pass) over the traced window's wall time, in percent."""

from benchmark import flops, flops_wan


def read(view):
    if not view.forwards:
        return None
    work = sum(f["passes"] * flops_wan.forward_flops(view.dit_cfg, f["s_video"], f["s_text"], f["s_image"])
               for f in view.forwards)
    return work / view.trace.window_s / flops.PEAK_FLOPS_BF16 * 100.0
