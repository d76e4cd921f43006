"""Layer: the model step (``models/wan/transformer.py``), read from the program's block spans: the device
time (CUDA events) of the blocks' cross-attention (``attention.cross``: its q, the text and image key and
value projections and norms, both flash launches, their sum and ``to_out``) over the device time of the DiT
forwards (``dit.forward``), in percent. A program without the span reports nothing."""

from benchmark import program_spans as ps


def read(view):
    records = ps.window_spans(view)
    if records is None:
        return None
    forwards = ps.total_ms(records, ps.FORWARD)
    cross = ps.total_ms(records, "attention.cross")
    if forwards <= 0 or cross <= 0:
        return None
    return cross / forwards * 100.0
