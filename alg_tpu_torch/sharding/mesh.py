"""The ``(dp, pp, sp, tp)`` mesh over the ranks of a ``torch.distributed``
process group (counterpart of ``alg_tpu/sharding/mesh.py``).

The port runs one process per GPU. A mesh lays the ranks of the process
group out as ``dp × pp × sp × tp`` in that order (``alg_tpu``'s axis order:
a stage's tp group is made of neighbouring ranks), and holds one process
group for each line of ranks along each axis, and one over the ranks that
share a dp coordinate (the ``model`` group: the ranks that hold the same
data). The groups are made once, by every rank, in the same order, as
``torch.distributed.new_group`` asks.

The backend follows the device: NCCL for CUDA tensors, gloo for CPU
tensors. A mesh larger or smaller than the world raises: the processes come
from the launcher (``torchrun --nproc_per_node N``), never from the mesh.
"""

from __future__ import annotations

import os
import socket
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

AXES = ("dp", "pp", "sp", "tp")


def backend_for(device) -> str:
    """``"nccl"`` for a CUDA device, ``"gloo"`` for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_process_group(rank: int = 0, world_size: int = 1, init_method: Optional[str] = None,
                       device="cuda") -> Tuple[int, int]:
    """Join (or create) the default process group and return ``(rank,
    world_size)``; a no-op that returns the current ids when one exists.

    ``init_method`` is ``tcp://host:port`` or ``file:///path`` (the tests use
    a file store, so that parallel test workers never race for a port); by
    default the launcher's environment (``torchrun``'s ``MASTER_ADDR``,
    ``RANK``, ``WORLD_SIZE``) when it is set, else a one-rank group on a
    free localhost port. A CUDA rank takes the card of its local rank
    (``LOCAL_RANK``, else its rank modulo the cards)."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    device = torch.device(device)
    if init_method is None:
        if "MASTER_ADDR" in os.environ and "WORLD_SIZE" in os.environ:
            init_method = "env://"
            rank, world_size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        else:
            init_method = f"tcp://127.0.0.1:{free_port()}"
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank % max(torch.cuda.device_count(), 1)))
        torch.cuda.set_device(local)
    dist.init_process_group(backend_for(device), init_method=init_method, world_size=world_size, rank=rank)
    return dist.get_rank(), dist.get_world_size()


class Mesh:
    """The ranks ``0..world-1`` laid out ``(dp, pp, sp, tp)``, with this
    rank's coordinate on each axis and the process group of its line along
    each axis. ``shape`` maps axis names to sizes, as ``jax.sharding.Mesh``
    does; ``device`` is where this rank's tensors live."""

    def __init__(self, dp: int, pp: int, sp: int, tp: int, device, ranks=None):
        """``ranks``: the global ranks laid out (all of them by default; a
        host's for ``multihost.local_mesh``). Every rank of the process group
        builds every mesh of a layout, its own and the others', because the
        groups are made collectively."""
        self.shape: Dict[str, int] = {"dp": dp, "pp": pp, "sp": sp, "tp": tp}
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        ranks = np.arange(dp * pp * sp * tp) if ranks is None else np.asarray(ranks)
        self.ranks = ranks.reshape(dp, pp, sp, tp)
        self.rank = dist.get_rank()
        at = np.argwhere(self.ranks == self.rank)
        self.coords: Dict[str, int] = dict(zip(AXES, (int(c) for c in at[0]))) if len(at) else {}
        self._groups: Dict[Tuple[str, ...], object] = {}
        self._group_ranks: Dict[Tuple[str, ...], list] = {}
        for axes in [(a,) for a in AXES] + [("pp", "sp", "tp")]:
            self._make_groups(axes)

    def _make_groups(self, axes: Tuple[str, ...]) -> None:
        moved = np.moveaxis(self.ranks, [AXES.index(a) for a in axes], range(4 - len(axes), 4))
        lines = moved.reshape(-1, int(np.prod([self.shape[a] for a in axes])))
        for line in lines:  # every rank makes every group, in the same order
            ranks = [int(r) for r in line]
            group = dist.new_group(ranks) if len(ranks) > 1 else None
            if self.rank in ranks:
                self._groups[axes], self._group_ranks[axes] = group, ranks

    def _key(self, axis) -> Tuple[str, ...]:
        return (axis,) if isinstance(axis, str) else tuple(axis)

    def size(self, axis) -> int:
        """The number of ranks along ``axis`` (a name, or ``("pp", "sp", "tp")``)."""
        return len(self._group_ranks[self._key(axis)])

    def local_rank(self, axis) -> int:
        """This rank's index along ``axis``."""
        return self._group_ranks[self._key(axis)].index(self.rank)

    def group(self, axis):
        """The process group of this rank's line along ``axis`` (None when it holds one rank)."""
        return self._groups[self._key(axis)]

    def group_ranks(self, axis) -> list:
        """The global ranks of that group, in axis order."""
        return self._group_ranks[self._key(axis)]

    @property
    def devices(self) -> np.ndarray:
        """The ranks as an array of the mesh's shape (``jax.sharding.Mesh.devices``' counterpart)."""
        return self.ranks

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank}, device={self.device})"


def make_mesh(dp: int = 1, tp: Optional[int] = None, sp: int = 1, pp: int = 1, device=None) -> Mesh:
    """A ``("dp", "pp", "sp", "tp")`` mesh over every rank of the default
    process group (made here from the launcher's environment, or as a
    one-rank group, when none exists). ``tp=None`` takes the ranks the other
    axes leave. ``device``: where this rank's tensors live; by default its
    card when CUDA is there, else the CPU (which picks the gloo backend)."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    world = dist.get_world_size() if dist.is_initialized() else int(os.environ.get("WORLD_SIZE", 1))
    if tp is None:
        tp = max(world // (dp * sp * pp), 1)
    n = dp * pp * sp * tp
    if n != world or min(dp, pp, sp, tp) < 1:  # checked before a process group is made for it
        raise ValueError(
            f"dp*pp*sp*tp = {dp}*{pp}*{sp}*{tp} = {n} does not match the {world} rank(s) of the process group: "
            f"one process runs per rank, so launch {n} of them, e.g. torchrun --nproc_per_node {n}")
    init_process_group(device=device)
    return Mesh(dp, pp, sp, tp, device)


def cpu_mesh(n_ranks: int, dp: int = 1, sp: int = 1) -> Mesh:
    """A gloo mesh on the CPU over ``n_ranks`` processes (tp fills the rest),
    for tests without a card; the process group must already hold them."""
    if not dist.is_initialized() or dist.get_world_size() != n_ranks:
        have = dist.get_world_size() if dist.is_initialized() else 1
        raise RuntimeError(f"cpu_mesh({n_ranks}) needs a gloo process group of {n_ranks} ranks, have {have}: "
                           f"launch them with torchrun --nproc_per_node {n_ranks} or init_process_group")
    return make_mesh(dp=dp, sp=sp, device="cpu")

