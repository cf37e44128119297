"""Incremental merge loop: a persistent count table and affected-row deltas.

Counterpart of yabpe_tpu/train/incremental.py, in torch ops on the
caller's device: the dense pair-count table is training state, and each
merge step updates only the rows that hold the merged pair, gathered into
a fixed-capacity buffer by a cumsum-slot scatter, subtracting their old
adjacent-pair counts and adding the new ones. When more rows are affected
than the largest buffer holds (the first few merges), the step falls back
to the full recount and a full-table apply. The trainer runs this loop
for problems past the merge kernels' limits (words of more than 64
symbols, and the like) at vocab <= 2048.

The JAX step picks the smallest capacity tier that holds the affected
rows with a ``lax.switch`` on the device. Here the host picks it: the
step reads the affected-row count and the stop flag back in one copy, so
**a step makes one host sync**, and the tier (hence every state array,
``row_max`` of the bigvocab engine included) is the JAX step's.

The delta scatters never drop: an empty slot's cells go to cell 0 with
weight 0, and its row write repeats slot 0's (the same row with the same
value), where the JAX scatters drop out-of-range indices.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from yabpe_tpu_torch.core.vocab import Vocab
from yabpe_tpu_torch.core.wordtable import WordTable
from yabpe_tpu_torch.kernels.merge_apply import apply_pair_merge
from yabpe_tpu_torch.kernels.pair_count import adjacent_pairs
from yabpe_tpu_torch.kernels.select import select_best_pair
from yabpe_tpu_torch.train.state import (
    TrainState,
    count_dtype,
    count_pairs,
    init_state,
    vocab_update,
)


@dataclass
class IncState:
    """A :class:`TrainState` and its persistent [V * V] count table."""

    core: TrainState
    counts: torch.Tensor


def init_counts(
    words: torch.Tensor,
    freqs: torch.Tensor,
    *,
    vocab_cap: int,
    count_strategy: str = "dense",
    dtype: torch.dtype = torch.int32,
) -> torch.Tensor:
    return count_pairs(words, freqs, vocab_cap, count_strategy, dtype)


def _affected_slots(
    affected: torch.Tensor, cap: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Pack the indices of the affected rows into a [cap] buffer.

    Returns (idx_buf, val_buf): row indices (N for empty slots) and slot
    validity. The valid slots come first, in row order.
    """
    n = affected.shape[0]
    pos = affected.int().cumsum(0) - 1
    slot = torch.where(affected & (pos < cap), pos, cap).long()
    rows = torch.arange(n, dtype=torch.int32, device=affected.device)
    # Slot ``cap`` is a dump for the rows that take no slot.
    idx_buf = torch.full((cap + 1,), n, dtype=torch.int32, device=affected.device)
    idx_buf.scatter_(0, slot, rows)
    val_buf = torch.zeros(cap + 1, dtype=torch.bool, device=affected.device)
    val_buf.scatter_(0, slot, affected)
    return idx_buf[:cap], val_buf[:cap]


def _pair_delta(
    rows: torch.Tensor, f: torch.Tensor, vocab_cap: int, sign: int, dtype: torch.dtype
) -> tuple[torch.Tensor, torch.Tensor]:
    """(keys, weights) of ``sign *`` the adjacent-pair counts of ``rows``;
    an invalid pair's key is 0 with weight 0."""
    left, right, valid = adjacent_pairs(rows)
    keys = torch.where(valid, left.long() * vocab_cap + right, 0)
    weights = torch.where(valid, sign * f[:, None].to(dtype), 0)
    return keys.reshape(-1), weights.reshape(-1)


def _tier_caps(affected_cap: int) -> tuple[int, ...]:
    """Ascending capacity tiers up to ``affected_cap``: 16, 128, 1024, ...
    (the JAX package's, so each step's tier is the same)."""
    caps = []
    c = 16
    while c < affected_cap:
        caps.append(c)
        c *= 8
    caps.append(affected_cap)
    return tuple(caps)


def affected_rows_and_tier(
    words: torch.Tensor,
    left: torch.Tensor,
    right: torch.Tensor,
    gate: torch.Tensor | bool,
    affected_cap: int,
) -> tuple[torch.Tensor, torch.Tensor, tuple[int, ...]]:
    """Rows that hold the merged pair, and the capacity tier they need.

    Returns (affected bool [N], tier as a 0-d tensor, caps). ``tier ==
    len(caps)`` means no tier holds them (a full recount). ``gate=False``
    empties the affected set. No host sync.
    """
    lw = words[:, :-1]
    rw = words[:, 1:]
    affected = ((lw == left) & (rw == right) & (lw >= 0)).any(dim=1) & gate
    n_aff = affected.sum()
    caps = _tier_caps(affected_cap)
    tier = sum((n_aff > c).int() for c in caps)
    return affected, tier, caps


def pack_merge_delta(
    words: torch.Tensor,
    freqs: torch.Tensor,
    affected: torch.Tensor,
    left: torch.Tensor,
    right: torch.Tensor,
    new_sym: torch.Tensor,
    cap: int,
    vocab_cap: int,
    dtype: torch.dtype = torch.int32,
    slots: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One merge's sparse count delta at a fixed buffer capacity.

    Gathers the ``affected`` rows into a [cap]-slot buffer, applies the
    merge to them, writes the merged rows back into ``words`` **in
    place**, and returns the old/new adjacent-pair (keys, weights): old
    pairs at -freq, new at +freq. Exact only when the affected rows fit
    ``cap``. ``slots`` is a precomputed :func:`_affected_slots` result
    (the speculative epochs keep it to replay a partial commit).
    """
    n = words.shape[0]
    idx_buf, val_buf = slots if slots is not None else _affected_slots(affected, cap)
    safe_idx = idx_buf.clamp(max=n - 1).long()
    rows = words.index_select(0, safe_idx)
    f = torch.where(val_buf, freqs.index_select(0, safe_idx), 0)

    old_keys, old_w = _pair_delta(rows, f, vocab_cap, -1, dtype)
    new_rows = apply_pair_merge(rows, left, right, new_sym)
    new_keys, new_w = _pair_delta(new_rows, f, vocab_cap, +1, dtype)

    write_rows(words, safe_idx, val_buf, torch.where(val_buf[:, None], new_rows, rows))
    return torch.cat([old_keys, new_keys]), torch.cat([old_w, new_w])


def write_rows(
    words: torch.Tensor, safe_idx: torch.Tensor, val_buf: torch.Tensor, rows: torch.Tensor
) -> None:
    """``words[safe_idx[i]] = rows[i]`` for the valid slots, **in place**.

    Valid slots come first, so an empty slot rewrites slot 0's row with
    slot 0's value: every write to a row carries the same bytes (the JAX
    scatter drops the empty slots instead).
    """
    target = torch.where(val_buf, safe_idx, safe_idx[0])
    words.index_copy_(0, target, torch.where(val_buf[:, None], rows, rows[0]))


def tiered_count_update(
    words: torch.Tensor,
    freqs: torch.Tensor,
    counts: torch.Tensor,
    left: torch.Tensor,
    right: torch.Tensor,
    new_sym: torch.Tensor,
    *,
    vocab_cap: int,
    affected_cap: int,
    gate: torch.Tensor | bool = True,
    row_max: torch.Tensor | None = None,
    count_strategy: str = "dense",
    sync_with: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None, int]:
    """Apply one merge to (words, counts[, row_max]) with tiered buffers.

    Picks the smallest capacity tier that holds the affected rows and runs
    the gather/delta/scatter at that size; above the top tier, the exact
    full recount. ``row_max`` (the bigvocab per-row upper bound) takes the
    post-update values at the touched cells by a scatter max, or the exact
    row maxima after a recount. Returns (words, counts, row_max or None,
    the value of ``sync_with`` read in the same host sync as the tier,
    else 0). Below the top tier it updates ``words``, ``counts`` and
    ``row_max`` in place; the recount returns new tensors.
    """
    V = vocab_cap
    affected, tier, caps = affected_rows_and_tier(
        words, left, right, gate, affected_cap
    )
    extra = torch.zeros((), dtype=torch.int64, device=words.device) if sync_with is None else sync_with
    tier_i, extra_i = torch.stack([tier.long(), extra.long()]).tolist()  # the step's host sync
    if tier_i < len(caps):
        keys, w = pack_merge_delta(
            words, freqs, affected, left, right, new_sym, caps[tier_i], V, counts.dtype
        )
        counts.index_add_(0, keys, w)
        if row_max is not None:
            # An invalid key (cell 0, weight 0) offers -1 to row 0.
            vals = torch.where(w != 0, counts.index_select(0, keys), -1)
            row_max.scatter_reduce_(0, keys // V, vals.to(row_max.dtype), "amax")
    else:
        words = apply_pair_merge(words, left, right, new_sym)
        counts = count_pairs(words, freqs, V, count_strategy, counts.dtype)
        if row_max is not None:
            row_max = counts.view(V, V).amax(dim=1)
    return words, counts, row_max, extra_i


def merge_step_incremental(
    state: IncState,
    step_index: int,
    *,
    vocab_cap: int,
    min_frequency: int,
    affected_cap: int,
    count_strategy: str = "dense",
) -> bool:
    """One merge step with incremental count maintenance, **in place**;
    returns whether the loop has stopped (read in the step's one sync)."""
    st = state.core
    left, right, best_count = select_best_pair(
        state.counts, st.vocab.lex_rank, vocab_cap
    )
    stopped = st.vocab.stopped | (best_count < max(min_frequency, 1))
    do = ~stopped
    new_sym = vocab_update(st.vocab, left, right, do, stopped, step_index)
    st.words, state.counts, _, stop = tiered_count_update(
        st.words, st.freqs, state.counts, left, right, new_sym,
        vocab_cap=vocab_cap, affected_cap=affected_cap, gate=do,
        count_strategy=count_strategy, sync_with=stopped,
    )
    return bool(stop)


def merge_chunk_incremental(
    state: IncState,
    chunk_start: int,
    *,
    vocab_cap: int,
    min_frequency: int,
    num_merges: int,
    chunk_size: int,
    affected_cap: int,
    count_strategy: str = "dense",
) -> IncState:
    """Run incremental merge steps [chunk_start, chunk_start +
    chunk_size), capped at ``num_merges``, in place; the steps after a
    stop are skipped (the JAX chunk runs them as no-ops)."""
    for step in range(chunk_start, min(chunk_start + chunk_size, num_merges)):
        if merge_step_incremental(
            state, step, vocab_cap=vocab_cap, min_frequency=min_frequency,
            affected_cap=affected_cap, count_strategy=count_strategy,
        ):
            break
    return state


def pick_affected_cap(num_rows: int) -> int:
    """Fixed gather-buffer size: small enough to keep deltas cheap, large
    enough that only the earliest merges overflow into the full recount."""
    cap = 256
    while cap < num_rows // 8 and cap < 4096:
        cap *= 2
    return min(cap, num_rows)


def start_engine(
    table: WordTable,
    base_vocab: Vocab,
    vocab_cap: int,
    num_merges: int,
    resume: tuple[np.ndarray, int] | None,
    device: str | torch.device,
) -> tuple[TrainState, int]:
    """The engines' starting state on ``device`` and its first step: the
    initial state, or with ``resume=(merges_ids, steps_done)`` the state
    the record's replay rebuilds (train/checkpoint.py)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but CUDA is not available")
    if resume is None:
        return init_state(table, base_vocab, vocab_cap, num_merges, device), 0
    from yabpe_tpu_torch.train.checkpoint import resume_state

    merges_ids, steps_done = resume
    start = min(int(steps_done), num_merges)
    return resume_state(
        table, base_vocab, vocab_cap, num_merges, merges_ids, start, device
    ), start


def run_engine_chunks(
    state, merge_chunk, start: int, *, num_merges: int, chunk_size: int,
    on_chunk=None, **chunk_kw,
) -> np.ndarray:
    """Call an engine's ``merge_chunk`` on ``state`` (an IncState or a
    BigState) chunk by chunk from step ``start`` until the merges are done
    or a step stops; ``on_chunk(merges_ids, steps_done)`` after every
    chunk. Returns the merge record, [num_merges, 3] int32 ids."""
    chunk = max(1, min(chunk_size, num_merges))
    while start < num_merges:
        merge_chunk(state, start, num_merges=num_merges, chunk_size=chunk, **chunk_kw)
        start += chunk
        if on_chunk is not None:
            on_chunk(state.core.vocab.merges.cpu().numpy(), min(start, num_merges))
        if bool(state.core.vocab.stopped):
            break
    return state.core.vocab.merges.cpu().numpy()


def run_incremental_merge_loop(
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
    """The engine's driver, the JAX trainer's incremental route
    (``_run_single_device``, ``:404-444``); returns the [num_merges, 3]
    merge record.

    ``resume=(merges_ids, steps_done)`` rebuilds the state by replaying
    the record (train/checkpoint.py), then recounts the table from the
    replayed words. ``on_chunk(merges_ids, steps_done)`` is called after
    every chunk.
    """
    core, start = start_engine(table, base_vocab, vocab_cap, num_merges, resume, device)
    state = IncState(
        core=core,
        counts=init_counts(
            core.words, core.freqs, vocab_cap=vocab_cap,
            count_strategy=count_strategy, dtype=count_dtype(table),
        ),
    )
    return run_engine_chunks(
        state, merge_chunk_incremental, start, num_merges=num_merges,
        chunk_size=chunk_size, on_chunk=on_chunk, vocab_cap=vocab_cap,
        min_frequency=min_frequency,
        affected_cap=pick_affected_cap(int(core.words.shape[0])),
        count_strategy=count_strategy,
    )


__all__ = [
    "IncState",
    "affected_rows_and_tier",
    "init_counts",
    "merge_chunk_incremental",
    "merge_step_incremental",
    "pack_merge_delta",
    "pick_affected_cap",
    "run_engine_chunks",
    "run_incremental_merge_loop",
    "start_engine",
    "tiered_count_update",
    "write_rows",
]
