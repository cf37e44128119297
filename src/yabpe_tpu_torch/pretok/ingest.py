"""Parallel corpus ingestion: files -> pre-token frequency table.

Counterpart of yabpe_tpu/pretok/ingest.py. Workers aggregate frequency
counters of unique pre-token byte strings; pair counts are sums, so the
result is independent of worker count and scheduling.

The native scanner is the ingest path; it runs on threads, since ctypes
releases the GIL. The ``regex`` path runs only where the caller allows it
(``require_native=False``) and the native library cannot be built; the
device route of the trainer never allows it. There, as in the JAX
package, spans go to a pool of threads or, for corpora past 8 MiB or with
``use_processes=True``, of processes (the regex engine holds the GIL).

While the tracer records (utils/profiling.py), the native path's scan
(``yabpe.ingest.scan``: the main thread waits for the workers), each
worker (``yabpe.ingest.worker``, with its index) and the fold and export
(``yabpe.ingest.fold``) are spans.
"""

from __future__ import annotations

import multiprocessing
import os
from collections import Counter
from collections.abc import Sequence
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from pathlib import Path

import numpy as np

from yabpe_tpu_torch import native
from yabpe_tpu_torch.pretok import chunking
from yabpe_tpu_torch.pretok.patterns import compile_trainer_pattern
from yabpe_tpu_torch.utils.profiling import span


def _count_span(
    path: str,
    start: int,
    end: int,
    special_tokens: tuple[str, ...],
) -> Counter[bytes]:
    """Pre-tokenize one byte span with ``regex`` and count pre-tokens."""
    data = chunking.read_span(path, start, end)
    text = chunking.decode_span_utf8(data, path, start)
    pattern = compile_trainer_pattern(special_tokens)
    str_counts = Counter(pattern.findall(text))
    str_counts.pop("", None)
    return Counter({t.encode("utf-8"): c for t, c in str_counts.items()})


def _count_shard_native(
    shard: list[tuple[str, int, int]],
    specials: tuple[str, ...],
    worker: int = 0,
    parent: dict | None = None,
) -> native.NativeCounter:
    """Accumulate a whole span shard into ONE persistent counter."""
    with span("yabpe.ingest.worker", parent=parent, worker=worker):
        counter = native.NativeCounter(specials)
        for path, start, end in shard:
            data = chunking.read_span(path, start, end)
            if native.utf8_invalid_at(data) >= 0:
                # Raise the reference-parity positioned ValueError.
                chunking.decode_span_utf8(data, path, start)
            counter.add(data)
    return counter


def _native_count_raw(
    tasks: list[tuple[str, int, int]],
    specials: tuple[str, ...],
    max_workers: int,
) -> tuple[bytes, np.ndarray, np.ndarray]:
    """Count all spans natively, fold into one counter and export it.

    Spans are assigned to workers round-robin, so the exported table order
    is stable for a given worker count; the counts are worker-count
    invariant either way.
    """
    max_workers = min(max_workers, os.cpu_count() or 1, len(tasks))
    if max_workers <= 1:
        with span("yabpe.ingest.scan"):
            parts = [_count_shard_native(tasks, specials)]
    else:
        shards = [tasks[i::max_workers] for i in range(max_workers)]
        with ThreadPoolExecutor(max_workers=max_workers) as pool:
            with span("yabpe.ingest.scan") as scan:
                futures = [
                    pool.submit(_count_shard_native, shard, specials, i, scan)
                    for i, shard in enumerate(shards)
                ]
                parts = [f.result() for f in futures]
    with span("yabpe.ingest.fold"):
        for part in parts[1:]:
            parts[0].merge(part)
            part.close()
        try:
            return parts[0].export()
        finally:
            parts[0].close()


def _spans(
    files: Sequence[str | Path], chunk_size_bytes: int, align_to_newline: bool
) -> list[tuple[str, int, int]]:
    tasks: list[tuple[str, int, int]] = []
    for file in files:
        p = chunking.ensure_exists(file)
        for start, end in chunking.chunk_spans(
            p, chunk_size_bytes, align_to_newline=align_to_newline
        ):
            tasks.append((str(p), start, end))
    return tasks


def counter_from_raw(blob: bytes, lens, counts) -> Counter[bytes]:
    """Materialize a Counter from a raw exported word table."""
    total: Counter[bytes] = Counter()
    off = 0
    for length, count in zip(lens.tolist(), counts.tolist()):
        total[blob[off : off + length]] = count
        off += length
    total.pop(b"", None)
    return total


def count_pretokens_raw(
    files: Sequence[str | Path],
    special_tokens: Sequence[str],
    *,
    chunk_size_bytes: int = 8 * 1024 * 1024,
    max_workers: int = 8,
    align_to_newline: bool = False,
) -> tuple[bytes, np.ndarray, np.ndarray]:
    """Native ingest returning the raw exported word table.

    Returns (concatenated word bytes, int32 lengths, int64 counts) without
    materializing Python byte strings. Raises
    :class:`~yabpe_tpu_torch.native.NativeBuildError` when the native
    scanner cannot be built.
    """
    native.load()
    tasks = _spans(files, chunk_size_bytes, align_to_newline)
    if not tasks:
        return b"", np.zeros(0, dtype=np.int32), np.zeros(0, dtype=np.int64)
    return _native_count_raw(tasks, tuple(special_tokens), max_workers)


def count_pretokens(
    files: Sequence[str | Path],
    special_tokens: Sequence[str],
    *,
    chunk_size_bytes: int = 8 * 1024 * 1024,
    max_workers: int = 8,
    align_to_newline: bool = False,
    require_native: bool = True,
    use_processes: bool | None = None,
) -> Counter[bytes]:
    """Count pre-token occurrences across ``files``.

    Args:
        files: UTF-8 text files. Raises FileNotFoundError on a missing file.
        special_tokens: matched as whole pre-tokens (trainer dialect).
        chunk_size_bytes: span size for parallel workers.
        max_workers: worker pool size.
        align_to_newline: end spans at newlines so pre-tokens never straddle
            spans (see chunking.chunk_spans). Off by default for parity.
        require_native: raise when the native scanner cannot be built
            (True), or count with ``regex`` then (False).
        use_processes: on the ``regex`` path, a process pool (True), a
            thread pool (False), or processes for corpora over 8 MiB
            (None), as in the JAX package. The native scanner ignores it:
            it runs on threads.

    Returns:
        Counter mapping pre-token UTF-8 bytes to occurrence count.
    """
    if require_native or native.available():
        blob, lens, counts = count_pretokens_raw(
            files,
            special_tokens,
            chunk_size_bytes=chunk_size_bytes,
            max_workers=max_workers,
            align_to_newline=align_to_newline,
        )
        return counter_from_raw(blob, lens, counts)
    return count_pretokens_regex(
        files,
        special_tokens,
        chunk_size_bytes=chunk_size_bytes,
        max_workers=max_workers,
        align_to_newline=align_to_newline,
        use_processes=use_processes,
    )


def count_pretokens_regex(
    files: Sequence[str | Path],
    special_tokens: Sequence[str],
    *,
    chunk_size_bytes: int = 8 * 1024 * 1024,
    max_workers: int = 1,
    align_to_newline: bool = False,
    use_processes: bool | None = None,
) -> Counter[bytes]:
    """:func:`count_pretokens` through the ``regex`` package: span by span
    in this thread with one worker or one span, else in a pool of
    ``max_workers`` threads or processes (``use_processes``; None means
    processes for corpora over 8 MiB, the JAX package's rule)."""
    specials = tuple(special_tokens)
    tasks = _spans(files, chunk_size_bytes, align_to_newline)
    total: Counter[bytes] = Counter()
    if max_workers <= 1 or len(tasks) <= 1:
        for path, start, end in tasks:
            total.update(_count_span(path, start, end, specials))
        return total
    if use_processes is None:
        use_processes = sum(os.path.getsize(f) for f in files) > 8 * 1024 * 1024
    # processes are spawned, not forked: the caller may hold threads
    # (torch's own), which a fork does not carry over safely
    pool = (
        ProcessPoolExecutor(max_workers, mp_context=multiprocessing.get_context("spawn"))
        if use_processes
        else ThreadPoolExecutor(max_workers)
    )
    with pool:
        futures = [
            pool.submit(_count_span, path, start, end, specials)
            for path, start, end in tasks
        ]
        for fut in futures:
            total.update(fut.result())
    return total


__all__ = [
    "count_pretokens",
    "count_pretokens_raw",
    "count_pretokens_regex",
    "counter_from_raw",
]
