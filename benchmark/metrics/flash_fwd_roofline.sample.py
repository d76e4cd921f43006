"""Layer: the kernel ``csrc/flash_attention_tc.cu`` (``flash_fwd_tc_kernel``, through
``ops/flash_attention.py``). The FLOPs the DiT's self-attention needs (``benchmark.flops.attention_flops``:
``Q·Kᵀ`` and ``P·V``, ``4·Sq·Sk·D`` a head) over the device time of the kernel's launches in the
window (``torch.profiler``, by kernel name), at 989 TFLOP/s, in percent."""

from benchmark import flops

KERNEL = "flash_fwd_tc_kernel"


def read(view):
    seconds = sum(s for name, s in view.trace.kernels() if KERNEL in name)
    if seconds <= 0 or not view.forwards:
        return None
    work = sum(f["passes"] * flops.dit_attention_flops(view.dit_cfg, f["s_text"], f["s_video"])
               for f in view.forwards)
    return work / flops.PEAK_FLOPS_BF16 / seconds * 100.0
