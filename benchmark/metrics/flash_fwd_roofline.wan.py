"""Layer: the bf16 flash-attention forward (``ops/flash_attention.py``'s route; at head dim 128 the
``"tc"`` kernel of ``csrc/flash_attention_tc.cu``). The FLOPs of the Wan DiT's three attentions a block
(``benchmark.flops_wan.attention_flops_all``: self-attention over the video tokens, cross-attention to the
text and to the image tokens) over the device time of the launches whose kernel names hold
``flash_fwd_tc_kernel``, the part of the name both bf16 forwards share (``torch.profiler``), at
989 TFLOP/s, in percent."""

from benchmark import flops, flops_wan

KERNEL = "flash_fwd_tc_kernel"


def read(view):
    seconds = sum(s for name, s in view.trace.kernels() if KERNEL in name)
    if seconds <= 0 or not view.forwards:
        return None
    work = sum(f["passes"] * flops_wan.attention_flops_all(view.dit_cfg, f["s_video"], f["s_text"], f["s_image"])
               for f in view.forwards)
    return work / flops.PEAK_FLOPS_BF16 / seconds * 100.0
