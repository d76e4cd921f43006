"""Layer: the model step (``models/cogvideox/transformer.py``, ``models/layers.py``), read from the program's
block spans: the device time (CUDA events) of the blocks' AdaLN-zero modulations (``block.norm``: the
LayerNorm of each stream, its scale and shift, and the modulation's linear) and gated residuals
(``block.gate``) over the device time of the DiT forwards (``dit.forward``), in percent. The elementwise,
reduction and cast kernels that no kernel's roofline names run there."""

from benchmark import program_spans as ps


def read(view):
    records = ps.window_spans(view)
    if records is None:
        return None
    forwards = ps.total_ms(records, ps.FORWARD)
    stages = ps.total_ms(records, "block.norm", "block.gate")
    if forwards <= 0 or stages <= 0:
        return None
    return stages / forwards * 100.0
