"""Placement of the data shards, and their one exchange per epoch.

Counterpart of yabpe_tpu/dist/mesh.py for the data-sharded merge loop
(``dist/hbm_sharded.py``). In this version the loop runs in one process:
every shard lives on the caller's device (the one card, or the CPU in the
tests), the counterpart of the JAX package's virtual mesh of devices in
one process, and the exchange (the JAX loop's ``all_gather`` over the
``data`` axis) is a stack of the shards' tensors along a leading shard
axis. :meth:`DataMesh.all_gather` is the one place that exchanges, so a
multi-process version can put ``torch.distributed`` there (NCCL on the
card, gloo on the CPU), together with ``dist/ingest.py``: ROADMAP.md
queue 1 item 6.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

_MULTI_PROCESS = (
    "multi-process data sharding (torch.distributed, with dist/ingest.py) "
    "is not ported yet (ROADMAP.md, queue 1 item 6: distributed)"
)


@dataclass(frozen=True)
class DataMesh:
    """``num_shards`` data shards, all on ``device``, in this process."""

    num_shards: int
    device: torch.device

    @property
    def devices(self) -> list[torch.device]:
        """The device of each shard."""
        return [self.device] * self.num_shards

    def all_gather(self, parts: list[torch.Tensor]) -> torch.Tensor:
        """Every shard's tensor, stacked along a new leading shard axis."""
        if len(parts) != self.num_shards:
            raise ValueError(f"{len(parts)} parts for {self.num_shards} shards")
        return torch.stack(parts)


def make_data_mesh(
    num_shards: int, device: str | torch.device, processes: int = 1
) -> DataMesh:
    """A 1-D mesh of ``num_shards`` data shards on ``device``.

    ``processes`` > 1 raises NotImplementedError: one process holds every
    shard in this version.
    """
    if processes > 1:
        raise NotImplementedError(_MULTI_PROCESS)
    if num_shards < 1:
        raise ValueError(f"num_shards must be positive, got {num_shards}")
    return DataMesh(num_shards, torch.device(device))


__all__ = ["DataMesh", "make_data_mesh"]
