from alg_tpu_torch.utils.profiling import span, spans, trace_to

__all__ = ["span", "spans", "trace_to"]
