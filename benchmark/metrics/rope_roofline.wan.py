"""Layer: the kernel ``csrc/rope.cu`` (``rope_kernel``, through ``ops/rope.py``): the interleaved 3D RoPE of
q and of k of each block's self-attention, two launches a block. Its byte bound
(``benchmark.flops_wan.rope_bytes``: q or k read once and written once in bf16, and the fp32 cos and sin
tables) at 3.35 TB/s over the launches' device time (``torch.profiler``), in percent."""

from benchmark import flops, flops_wan

KERNEL = "rope_kernel"


def read(view):
    seconds = sum(s for name, s in view.trace.kernels() if KERNEL in name)
    if seconds <= 0 or not view.forwards:
        return None
    cfg = view.dit_cfg
    need = sum(2 * cfg["num_layers"] * flops_wan.rope_bytes(f["passes"], cfg["num_attention_heads"], f["s_video"],
                                                            cfg["attention_head_dim"])
               for f in view.forwards)
    return need / flops.PEAK_BYTES / seconds * 100.0
