"""Placement of the data shards, and their exchanges.

Counterpart of yabpe_tpu/dist/mesh.py. The training mesh has the JAX
package's two logical axes:

- ``data``: word rows are cut into ``num_shards`` shards. Shards are
  ordered process-major, as the JAX mesh orders its devices: process p
  holds the contiguous block ``local_shards``, all of them on its one
  device. The exchange along this axis (the JAX loops' ``all_gather`` and
  ``psum`` over ``data``) is :meth:`DataMesh.all_gather` and
  :meth:`DataMesh.all_reduce`: a stack of the local shards' tensors, and
  across processes a ``torch.distributed`` collective.
- ``vocab``: ``vocab_shards`` slabs of the count table, by left-symbol
  rows. Every process holds all of them on its device, as the JAX
  package's virtual mesh holds them in one process, so the gather over
  ``vocab`` never leaves the process (``dist/sharded.py``).

The collective backend is explicit: ``"nccl"`` where each process has a
card of its own, ``"gloo"`` on the CPU, or for several processes on one
card (NCCL refuses two ranks on one device). Gloo takes device tensors
for ``all_gather`` and ``all_reduce`` and moves them through host memory
itself. :func:`multiprocess_initialize` sets up the process group from
torchrun's environment over a given backend, and
:func:`multihost_initialize`, the JAX package's name, over the backend the
machine suggests.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

BACKENDS = ("nccl", "gloo")


def process_info() -> tuple[int, int, str | None]:
    """(processes, rank, backend) of the default process group; (1, 0,
    None) when ``torch.distributed`` is not initialized."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return 1, 0, None
    return dist.get_world_size(), dist.get_rank(), str(dist.get_backend())


@dataclass(frozen=True)
class DataMesh:
    """``num_shards`` data shards over ``processes`` processes, this one's
    on ``device``, and ``vocab_shards`` count-table slabs per process."""

    num_shards: int
    device: torch.device
    vocab_shards: int = 1
    processes: int = 1
    rank: int = 0

    @property
    def shards_per_process(self) -> int:
        return -(-self.num_shards // self.processes)

    @property
    def local_shards(self) -> range:
        """Global indices of this process's data shards (process-major)."""
        per = self.shards_per_process
        lo = min(self.rank * per, self.num_shards)
        return range(lo, min(lo + per, self.num_shards))

    @property
    def devices(self) -> list[torch.device]:
        """The device of each local shard."""
        return [self.device] * len(self.local_shards)

    def all_gather(self, parts: list[torch.Tensor]) -> torch.Tensor:
        """Every shard's tensor, stacked along a new leading shard axis in
        global shard order; ``parts`` are this process's shards'."""
        if len(parts) != len(self.local_shards):
            raise ValueError(
                f"{len(parts)} parts for {len(self.local_shards)} local shards"
            )
        local = torch.stack(parts)
        if self.processes == 1:
            return local
        import torch.distributed as dist

        per = self.shards_per_process
        if local.shape[0] < per:  # the last process may hold fewer
            pad = local.new_zeros((per - local.shape[0], *local.shape[1:]))
            local = torch.cat([local, pad])
        out = [torch.empty_like(local) for _ in range(self.processes)]
        dist.all_gather(out, local.contiguous())
        return torch.cat(out)[: self.num_shards]

    def all_reduce(self, t: torch.Tensor, op: str) -> torch.Tensor:
        """``t`` reduced over the processes (``op`` "max" or "sum"); one
        process returns it as it is. The local shards are the caller's to
        reduce first."""
        if self.processes == 1:
            return t
        import torch.distributed as dist

        t = t.contiguous()
        dist.all_reduce(t, {"max": dist.ReduceOp.MAX, "sum": dist.ReduceOp.SUM}[op])
        return t


def _mesh(
    num_shards: int,
    vocab_shards: int,
    device: str | torch.device,
    processes: int,
    backend: str | None,
) -> DataMesh:
    if num_shards < 1 or vocab_shards < 1:
        raise ValueError(
            f"shard counts must be positive, got {num_shards} x {vocab_shards}"
        )
    rank = 0
    if processes > 1:
        world, rank, running = process_info()
        if backend not in BACKENDS:
            raise ValueError(
                f"{processes} processes need an explicit backend, one of "
                f"{BACKENDS}; got {backend!r}"
            )
        if world != processes or running != backend:
            raise ValueError(
                f"torch.distributed runs {world} processes over "
                f"{running!r}; the mesh asks for {processes} over {backend!r}"
            )
    return DataMesh(num_shards, torch.device(device), vocab_shards, processes, rank)


def make_data_mesh(
    num_shards: int,
    device: str | torch.device,
    processes: int = 1,
    backend: str | None = None,
) -> DataMesh:
    """A 1-D ``data`` mesh of ``num_shards`` shards; with ``processes`` >
    1, over the initialized default process group, whose backend must be
    ``backend``."""
    return _mesh(num_shards, 1, device, processes, backend)


def make_2d_mesh(
    data_shards: int,
    vocab_shards: int,
    device: str | torch.device,
    processes: int = 1,
    backend: str | None = None,
) -> DataMesh:
    """A (data, vocab) mesh: ``data_shards`` word shards over the
    processes, ``vocab_shards`` count-table slabs in every process."""
    return _mesh(data_shards, vocab_shards, device, processes, backend)


def all_gather_host(array: np.ndarray, backend: str | None) -> np.ndarray:
    """[processes, ...]: every process's ``array`` (same shape and dtype
    everywhere), over the default process group. NCCL moves device
    tensors, so there the array goes through the current card."""
    import torch.distributed as dist

    t = torch.from_numpy(np.ascontiguousarray(array))
    if backend == "nccl":
        t = t.cuda()
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t)
    return torch.stack(out).cpu().numpy()


def multiprocess_initialize(backend: str) -> None:
    """Initialize ``torch.distributed`` under a multi-process launcher
    (torchrun's ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``), over
    ``backend``; a no-op without those variables or when already done.
    Counterpart of the JAX package's ``multihost_initialize``."""
    import torch.distributed as dist

    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    needed = ("RANK", "WORLD_SIZE", "MASTER_ADDR")
    if not all(os.environ.get(k) for k in needed) or dist.is_initialized():
        return
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group(backend=backend)


def multihost_initialize() -> None:
    """Initialize ``torch.distributed`` when running under a multi-process
    launcher: :func:`multiprocess_initialize` over ``"nccl"`` where CUDA is
    available and ``"gloo"`` otherwise. A no-op without the launcher's
    variables (one process), as the JAX package's ``multihost_initialize``
    is without its coordinator's."""
    multiprocess_initialize("nccl" if torch.cuda.is_available() else "gloo")


__all__ = [
    "BACKENDS",
    "DataMesh",
    "all_gather_host",
    "make_2d_mesh",
    "make_data_mesh",
    "multihost_initialize",
    "multiprocess_initialize",
    "process_info",
]
