from alg_tpu_torch.utils.profiling import StepTimer, trace_to

__all__ = ["StepTimer", "trace_to"]
