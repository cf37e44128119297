"""Large-vocabulary merge loop: the count table and a lazy row-max select.

Counterpart of yabpe_tpu/train/bigvocab.py, in torch ops on the caller's
device. The trainer runs this loop for problems past the merge kernels'
limits (words of more than 64 symbols, pair mass past 2^31, vocab past
131,072) at vocab > 2048. A full-table argmax per step would read the
whole [V, V] table, so the loop keeps ``row_max``, an upper bound on each
row's max count: increases are folded in eagerly (a scatter max of the
post-update values at every cell a delta touched, in
train/incremental.py); decreases leave a stale bound, which the select
repairs lazily.

- :func:`lazy_select_rows` and :func:`lazy_select` are the JAX
  ``while_loop`` as a host loop: pick the lex-greatest row among those
  whose bound is the global bound max, re-scan it, and confirm (the bound
  is tight, so it is the global max) or tighten it and go round again.
  Each round reads its verdict back to the host, so **a step makes one
  host sync per round** (about one round a step; stale tops are rare)
  **plus the tier sync of train/incremental.py**. Every tightened bound
  is the JAX loop's, so ``row_max`` equals its state.
- :func:`merge_step_big`, :func:`merge_chunk_big` and
  :func:`run_bigvocab_merge_loop` are the engine, with ``resume`` and
  ``on_chunk`` as in the JAX driver (``:226-279``).
- :func:`lazy_select_rows_async` runs a fixed number of those rounds on
  the device and returns the verdict as a flag, for the sharded loops
  (``dist/sharded.py``, ``dist/speculative.py``), which read it with
  what else the step reads, in one host sync;
- :func:`lazy_select_2d` is the data-sharded loop's select
  (``dist/hbm_sharded.py``), which must not wait on the host: it runs a
  fixed number of rounds, each of which re-scans ``width`` rows at once,
  and returns whether the result is exact as a device flag for the caller
  to check later. A round's rows are the greatest (bound, lex rank) key
  of each of ``width`` stripes of rows (row r in stripe r % width): one
  reduction, where a global top-``width`` (``torch.topk``) is a
  multi-pass radix select of several launches on the card.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from yabpe_tpu_torch.core.vocab import Vocab
from yabpe_tpu_torch.core.wordtable import WordTable
from yabpe_tpu_torch.train.incremental import (
    pick_affected_cap,
    run_engine_chunks,
    start_engine,
    tiered_count_update,
)
from yabpe_tpu_torch.train.state import (
    TrainState,
    count_dtype,
    count_pairs,
    vocab_update,
)

#: Verify rounds and rows re-scanned per round of :func:`lazy_select_2d`.
VERIFY_ROUNDS = 2
VERIFY_WIDTH = 32
#: Rounds of :func:`lazy_select_rows_async` before its verdict is read.
SELECT_ROUNDS = 4


def lazy_select_2d(
    counts: torch.Tensor,
    row_max: torch.Tensor,
    lex_rank: torch.Tensor,
    *,
    rounds: int = VERIFY_ROUNDS,
    width: int = VERIFY_WIDTH,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact (left, right, count) of the greatest cell of ``counts`` [V, V]:
    the highest count, ties to the greatest lex rank of the row, then of the
    column.

    ``row_max`` [V] must bound every row's max from above; the rows it
    re-scans are tightened **in place**. Returns 0-d tensors ``(a, b, m,
    exact)``; ``exact`` is false when ``rounds`` rounds of ``width``
    re-scans did not reach a row whose bound is tight, and then (a, b, m)
    is not the answer, though ``m`` still bounds every count from above.
    No host sync.

    Exactness: after the rounds, ``a`` is the row with the greatest
    (bound, lex rank) key. When its bound equals its true max ``m``, every
    other row's max is at most its bound, which is at most ``m``, and a row
    of max ``m`` with a greater lex rank would have a bound of ``m`` and a
    greater key. So ``a`` is the lex-greatest row holding the global max,
    the row the JAX function finds.
    """
    v = counts.shape[0]
    # (bound, lex rank) as one int64 key: bound < 2^31 and lex + 1 < 2^32,
    # so the key orders any vocabulary this loop takes.
    lex1 = lex_rank.long() + 1
    top = min(width, v)
    pad = -v % top
    stripe = torch.arange(top, device=counts.device)
    for _ in range(rounds):
        key = torch.add(lex1, row_max, alpha=1 << 32)
        if pad:
            key = torch.nn.functional.pad(key, (0, pad), value=-1)
        best = key.view(-1, top).argmax(dim=0)
        rows = (best * top + stripe).clamp(max=v - 1)
        row_max.index_copy_(0, rows, counts.index_select(0, rows).amax(dim=1))
    a = torch.add(lex1, row_max, alpha=1 << 32).argmax()
    m = row_max.index_select(0, a.view(1))[0]
    row = counts.index_select(0, a.view(1))[0]
    exact = row.max() == m
    b = torch.where(row == m, lex_rank, -1).argmax()
    return a, b, m, exact


@dataclass
class BigState:
    """A :class:`TrainState`, its [V * V] count table and the per-row
    upper bound ``row_max`` [V] (the count table's dtype)."""

    core: TrainState
    counts: torch.Tensor
    row_max: torch.Tensor


def lazy_select_rows(
    table_flat: torch.Tensor,
    row_max: torch.Tensor,
    lex_rows: torch.Tensor,
    lex_cols: torch.Tensor,
    row_width: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact (count m, row a, col b) maximum of a flattened [rows, width]
    table by lazy bound verification.

    ``row_max`` is a per-row upper bound, tightened **in place** at every
    re-scanned row. Rows tie-break by ``lex_rows``, columns by
    ``lex_cols``. Returns 0-d tensors and the bounds; one host sync per
    round.
    """
    table = table_flat.view(-1, row_width)
    while True:
        m = row_max.max()
        a = torch.where(row_max == m, lex_rows, -1).argmax()
        true_max = table.index_select(0, a.view(1))[0].max()
        row_max.index_copy_(0, a.view(1), true_max.view(1))
        if bool(true_max == m):  # the round's host sync
            break
    row = table.index_select(0, a.view(1))[0]
    b = torch.where(row == m, lex_cols, -1).argmax()
    return m, a.int(), b.int(), row_max


def lazy_select_rows_async(
    table_flat: torch.Tensor,
    row_max: torch.Tensor,
    lex_rows: torch.Tensor,
    lex_cols: torch.Tensor,
    row_width: int,
    rounds: int = SELECT_ROUNDS,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`lazy_select_rows` for ``rounds`` rounds on the device, with no
    host sync: returns 0-d tensors (m, a, b, done).

    A round after the loop has converged changes nothing (it picks the
    same row and writes back its own tight bound), so when ``done`` is
    true, (m, a, b) and ``row_max`` are exactly the JAX ``while_loop``'s;
    when it is false, :func:`lazy_select_rows` on the same ``row_max``
    takes the loop on from where it stopped.
    """
    table = table_flat.view(-1, row_width)
    for _ in range(rounds):
        m = row_max.max()
        a = torch.where(row_max == m, lex_rows, -1).argmax()
        true_max = table.index_select(0, a.view(1))[0].max()
        row_max.index_copy_(0, a.view(1), true_max.view(1))
    done = true_max == m
    row = table.index_select(0, a.view(1))[0]
    b = torch.where(row == m, lex_cols, -1).argmax()
    return m, a.int(), b.int(), done


def lazy_select(
    counts_flat: torch.Tensor,
    row_max: torch.Tensor,
    lex_rank: torch.Tensor,
    vocab_cap: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact (left, right, count) by bound verification, and ``row_max``
    with any stale tops tightened (in place)."""
    m, a, b, row_max = lazy_select_rows(
        counts_flat, row_max, lex_rank, lex_rank, vocab_cap
    )
    return a, b, m, row_max


def merge_step_big(
    state: BigState,
    step_index: int,
    *,
    vocab_cap: int,
    min_frequency: int,
    affected_cap: int,
    count_strategy: str = "dense",
) -> bool:
    """One merge step, O(V + affected x width) device traffic, **in
    place**; returns whether the loop has stopped."""
    V = vocab_cap
    st = state.core
    left, right, best_count, _ = lazy_select(
        state.counts, state.row_max, st.vocab.lex_rank, V
    )
    stopped = st.vocab.stopped | (best_count < max(min_frequency, 1))
    do = ~stopped
    new_sym = vocab_update(st.vocab, left, right, do, stopped, step_index)
    st.words, state.counts, state.row_max, stop = tiered_count_update(
        st.words, st.freqs, state.counts, left, right, new_sym,
        vocab_cap=V, affected_cap=affected_cap, gate=do,
        row_max=state.row_max, count_strategy=count_strategy,
        sync_with=stopped,
    )
    return bool(stop)


def merge_chunk_big(
    state: BigState,
    chunk_start: int,
    *,
    vocab_cap: int,
    min_frequency: int,
    num_merges: int,
    chunk_size: int,
    affected_cap: int,
    count_strategy: str = "dense",
) -> BigState:
    """Run merge steps [chunk_start, chunk_start + chunk_size), capped at
    ``num_merges``, in place; the steps after a stop are skipped."""
    for step in range(chunk_start, min(chunk_start + chunk_size, num_merges)):
        if merge_step_big(
            state, step, vocab_cap=vocab_cap, min_frequency=min_frequency,
            affected_cap=affected_cap, count_strategy=count_strategy,
        ):
            break
    return state


def run_bigvocab_merge_loop(
    table: WordTable,
    base_vocab: Vocab,
    *,
    vocab_cap: int,
    num_merges: int,
    min_frequency: int,
    chunk_size: int = 256,
    resume: tuple[np.ndarray, int] | None = None,
    on_chunk=None,
    count_strategy: str = "dense",
    device: str | torch.device = "cuda",
) -> np.ndarray:
    """The engine's driver; returns the [num_merges, 3] merge record.

    ``resume=(merges_ids, steps_done)`` rebuilds the state by replaying
    the recorded merges (train/checkpoint.py); the count table and the
    row bounds are then recounted from the replayed words.
    ``on_chunk(merges_ids, steps_done)`` is called after every chunk.
    """
    core, start = start_engine(table, base_vocab, vocab_cap, num_merges, resume, device)
    counts = count_pairs(
        core.words, core.freqs, vocab_cap, count_strategy, count_dtype(table)
    )
    state = BigState(
        core=core, counts=counts,
        row_max=counts.view(vocab_cap, vocab_cap).amax(dim=1),
    )
    return run_engine_chunks(
        state, merge_chunk_big, start, num_merges=num_merges,
        chunk_size=chunk_size, on_chunk=on_chunk, vocab_cap=vocab_cap,
        min_frequency=min_frequency,
        affected_cap=pick_affected_cap(int(core.words.shape[0])),
        count_strategy=count_strategy,
    )


__all__ = [
    "SELECT_ROUNDS",
    "VERIFY_ROUNDS",
    "VERIFY_WIDTH",
    "BigState",
    "lazy_select",
    "lazy_select_2d",
    "lazy_select_rows",
    "lazy_select_rows_async",
    "merge_chunk_big",
    "merge_step_big",
    "run_bigvocab_merge_loop",
]
