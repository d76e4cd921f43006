"""Multi-device execution on ``torch.distributed`` (counterpart of
``alg_tpu/sharding``): the ``(dp, pp, sp, tp)`` mesh, Megatron tensor
parallelism, GPipe over the DiT blocks and multi-host serving. Sequence
parallelism lives in ``ops.attention``."""

from alg_tpu_torch.sharding.mesh import Mesh, cpu_mesh, init_process_group, make_mesh
from alg_tpu_torch.sharding.multihost import initialize as multihost_initialize
from alg_tpu_torch.sharding.multihost import local_mesh, local_request_slice, serve_batch_multihost
from alg_tpu_torch.sharding.partition import (add_pp, cogvideox_transformer_specs, gather_params,
                                              hunyuan_transformer_specs, shard_params, shard_transformer,
                                              wan_transformer_specs)
from alg_tpu_torch.sharding.pipeline import pipeline_blocks, run_blocks

__all__ = [
    "Mesh", "make_mesh", "cpu_mesh", "init_process_group", "multihost_initialize", "local_mesh",
    "local_request_slice", "serve_batch_multihost", "add_pp", "cogvideox_transformer_specs",
    "wan_transformer_specs", "hunyuan_transformer_specs", "shard_params", "gather_params", "shard_transformer",
    "pipeline_blocks", "run_blocks",
]
