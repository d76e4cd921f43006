"""Layer: the matrix products of the Wan DiT's linears (``models/layers.py``'s ``Linear``, cuBLAS through
``F.linear``). The linears' FLOPs (``benchmark.flops_wan.linear_flops``) over the device time of the
matrix-product kernels launched inside the DiT forwards' ranges, matched as ``gemm_roofline.sample``
matches them (its ``is_gemm``), at 989 TFLOP/s, in percent."""

from benchmark import flops, flops_wan
from benchmark import manifest as mf

is_gemm = mf.metric_reader("gemm_roofline.sample").__globals__["is_gemm"]


def read(view):
    ranges = [(f["start"], f["end"]) for f in view.forwards]
    seconds = sum(s for name, s in view.trace.kernels(ranges) if is_gemm(name))
    if seconds <= 0:
        return None
    work = sum(f["passes"] * flops_wan.linear_flops(view.dit_cfg, f["s_video"], f["s_text"], f["s_image"])
               for f in view.forwards)
    return work / flops.PEAK_FLOPS_BF16 / seconds * 100.0
