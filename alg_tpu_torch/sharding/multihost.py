"""Multi-host serving (counterpart of ``alg_tpu/sharding/multihost.py``).

Serving requests are independent, so across hosts the layout is no
communication at all: each host serves a contiguous block of the request
list on a mesh of its own ranks (:func:`local_mesh`), and no traffic
crosses hosts within a step. The port runs one process per GPU: a host is
the ``LOCAL_WORLD_SIZE`` consecutive ranks ``torchrun`` starts on one node
(one rank a host when the variable is absent), and the default process
group (:func:`initialize`, over ``tcp://``) spans all hosts only to make the
local groups.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch.distributed as dist

from alg_tpu_torch.sharding.mesh import Mesh, init_process_group


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device="cuda") -> Tuple[int, int]:
    """Join the process group and return ``(rank, world_size)``:
    ``coordinator_address`` ``host:port`` with the process count and this
    process's id, or ``torchrun``'s environment when they are None. Safe to
    call when already initialized."""
    init_method = None if coordinator_address is None else f"tcp://{coordinator_address}"
    if init_method is not None and (num_processes is None or process_id is None):
        raise ValueError("--coordinator needs --num_processes and --process_id")
    return init_process_group(process_id or 0, num_processes or 1, init_method, device)


def _host_size() -> int:
    return int(os.environ.get("LOCAL_WORLD_SIZE", 1))


def host_index() -> Tuple[int, int]:
    """``(this host's index, the number of hosts)``."""
    n = _host_size()
    return dist.get_rank() // n, dist.get_world_size() // n


def local_request_slice(n_requests: int, process_id: Optional[int] = None,
                        process_count: Optional[int] = None) -> slice:
    """The contiguous block of the global request list this host serves;
    the remainder goes to the leading hosts (blocks differ by at most 1)."""
    if process_id is None or process_count is None:
        pid, count = host_index()
        process_id = pid if process_id is None else process_id
        process_count = count if process_count is None else process_count
    base, rem = divmod(n_requests, process_count)
    start = process_id * base + min(process_id, rem)
    return slice(start, start + base + (1 if process_id < rem else 0))


def local_mesh(dp: int = 1, sp: int = 1, tp: Optional[int] = None, device=None) -> Mesh:
    """A ``(dp, 1, sp, tp)`` mesh over this host's ranks only (every rank
    calls it: each host's groups are made by all). ``tp=None`` takes the
    host's ranks the other axes leave."""
    import torch

    device = ("cuda" if torch.cuda.is_available() else "cpu") if device is None else device
    n = _host_size()
    tp = max(n // (dp * sp), 1) if tp is None else tp
    if dp * sp * tp != n:
        raise ValueError(f"dp*sp*tp = {dp}*{sp}*{tp} does not match the {n} rank(s) of a host: launch "
                         f"torchrun --nproc_per_node {dp * sp * tp} on each host")
    host, n_hosts = host_index()
    mine = None
    for h in range(n_hosts):  # every rank makes every host's groups, in the same order
        mesh = Mesh(dp, 1, sp, tp, device, ranks=np.arange(h * n, (h + 1) * n))
        if h == host:
            mine = mesh
    return mine


def serve_batch_multihost(pipeline, requests: Sequence, mesh=None, **gen_kwargs):
    """Serve a global request list across hosts: every process passes the
    same list and gets ``(videos, indices)`` of its host's block, equal to
    what ``serving.serve_batch`` gives those requests on one host (each
    request's seed drives its own noise)."""
    from alg_tpu_torch.serving import serve_batch

    sl = local_request_slice(len(requests))
    local = list(requests[sl])
    if not local:
        return [], []
    return serve_batch(pipeline, local, mesh=mesh, **gen_kwargs), list(range(sl.start, sl.stop))
