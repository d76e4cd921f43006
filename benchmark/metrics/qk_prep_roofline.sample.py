"""Layer: the kernel ``csrc/qk_prep.cu`` (``qk_prep_kernel``, through ``ops/qk_prep.py``): the
per-head LayerNorm and RoPE of q and of k, two launches a block. Its byte bound
(``benchmark.flops.qk_prep_bytes``: the tensor read once and written once, the fp32 tables and norm
parameters) at 3.35 TB/s over the launches' device time (``torch.profiler``), in percent."""

from benchmark import flops

KERNEL = "qk_prep_kernel"


def read(view):
    seconds = sum(s for name, s in view.trace.kernels() if KERNEL in name)
    if seconds <= 0 or not view.forwards:
        return None
    cfg = view.dit_cfg
    need = sum(2 * cfg["num_layers"] * flops.qk_prep_bytes(f["passes"], cfg["num_attention_heads"],
                                                           f["s_text"] + f["s_video"], cfg["attention_head_dim"])
               for f in view.forwards)
    return need / flops.PEAK_BYTES / seconds * 100.0
