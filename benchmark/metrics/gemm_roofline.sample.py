"""Layer: the matrix products of the DiT's linears (``models/layers.py``'s ``Linear`` and
``nn.Linear``, cuBLAS through ``F.linear``). The linears' FLOPs (``benchmark.flops.dit_linear_flops``)
over the device time of the matrix-product kernels launched inside the DiT forwards' ranges, at
989 TFLOP/s, in percent. A matrix-product kernel is one whose name holds one of ``PATTERNS``
(cuBLAS's ``nvjet`` and ``gemm`` kernels, CUTLASS's, and cuBLAS's split-K reduction), and none of
the port's own kernels' names."""

from benchmark import flops

PATTERNS = ("nvjet", "gemm", "cutlass", "splitk")
PORT_KERNELS = ("flash_fwd", "qk_prep", "flash_bwd", "rope_kernel", "qk_prolog")


def is_gemm(name: str) -> bool:
    low = name.lower()
    return any(p in low for p in PATTERNS) and not any(k in low for k in PORT_KERNELS)


def read(view):
    ranges = [(f["start"], f["end"]) for f in view.forwards]
    seconds = sum(s for name, s in view.trace.kernels(ranges) if is_gemm(name))
    if seconds <= 0:
        return None
    work = sum(f["passes"] * flops.dit_linear_flops(view.dit_cfg, f["s_text"], f["s_video"]) for f in view.forwards)
    return work / flops.PEAK_FLOPS_BF16 / seconds * 100.0
