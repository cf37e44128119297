"""Multi-process corpus ingestion: per-process file shards -> one word table.

Counterpart of yabpe_tpu/dist/ingest.py over ``torch.distributed``. Each
process ingests its round-robin share of the files with the local
pipeline (``pretok/ingest.py``, the native scanner); the raw word tables
are exchanged and unioned, process 0's first, on every process through
``NativeCounter.add_table``. Counts are integers that commute, so the
global table does not depend on the process count, and it is the same on
every process. In one process this is the local pipeline.
"""

from __future__ import annotations

from collections.abc import Sequence
from pathlib import Path

import numpy as np

from yabpe_tpu_torch import native
from yabpe_tpu_torch.dist.mesh import all_gather_host, process_info
from yabpe_tpu_torch.pretok import ingest as local_ingest


def shard_files(
    files: Sequence[str | Path], process_index: int, process_count: int
) -> list[str | Path]:
    """Round-robin file assignment for this process (deterministic)."""
    return [f for i, f in enumerate(files) if i % process_count == process_index]


def _allgather_table(
    blob: bytes, lens: np.ndarray, counts: np.ndarray, backend: str | None
) -> list[tuple[bytes, np.ndarray, np.ndarray]]:
    """Every process's raw word table, process 0's first.

    Two exchanges: the three sizes, then ONE payload of raw bytes
    ``lens | counts | blob``, padded to the largest process's.
    """
    lens = np.ascontiguousarray(lens, dtype=np.int32)
    counts = np.ascontiguousarray(counts, dtype=np.int64)
    payload = lens.tobytes() + counts.tobytes() + blob
    sizes = np.array([len(blob), len(lens), len(payload)], dtype=np.int64)
    all_sizes = all_gather_host(sizes, backend)
    max_payload = int(all_sizes[:, 2].max())

    packed = np.zeros(max_payload, dtype=np.uint8)
    packed[: len(payload)] = np.frombuffer(payload, dtype=np.uint8)
    all_packed = all_gather_host(packed, backend)

    out = []
    for p in range(all_sizes.shape[0]):
        nb, nw = int(all_sizes[p, 0]), int(all_sizes[p, 1])
        raw = all_packed[p]
        lens_p = np.frombuffer(raw[: 4 * nw].tobytes(), dtype=np.int32)
        counts_p = np.frombuffer(raw[4 * nw : 12 * nw].tobytes(), dtype=np.int64)
        blob_p = raw[12 * nw : 12 * nw + nb].tobytes()
        out.append((blob_p, lens_p, counts_p))
    return out


def count_pretokens_global(
    files: Sequence[str | Path],
    special_tokens: Sequence[str],
    *,
    chunk_size_bytes: int = 32 * 1024 * 1024,
    max_workers: int = 8,
    align_to_newline: bool = True,
) -> tuple[bytes, np.ndarray, np.ndarray]:
    """The raw word table (blob, lens int32, counts int64) of all files,
    over every process of the default process group.

    Every process passes the SAME ``files``; each ingests only its
    round-robin share, and the returned table is identical on every
    process: first-occurrence order of the process-0-major union, so that
    training downstream is deterministic.
    """
    p_cnt, p_idx, backend = process_info()
    mine = shard_files(files, p_idx, p_cnt)
    local = local_ingest.count_pretokens_raw(
        mine,
        special_tokens,
        chunk_size_bytes=chunk_size_bytes,
        max_workers=max_workers,
        align_to_newline=align_to_newline,
    )
    if p_cnt == 1:
        return local

    root = native.NativeCounter()
    try:
        for blob, lens, counts in _allgather_table(*local, backend):
            root.add_table(blob, lens, counts)
        return root.export()
    finally:
        root.close()


__all__ = ["count_pretokens_global", "shard_files"]
