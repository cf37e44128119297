"""Training state of the merge loop in torch, its plain merge step, and
the merge-record conversion.

Counterpart of yabpe_tpu/train/state.py:

- :class:`VocabState` is the token side of the JAX package's
  ``TrainState`` (its fields without ``words`` and ``freqs``, which the
  kernels and the sharded loop keep in their own word shards), and
  :func:`vocab_update` (``:178``) its maintenance;
- :class:`TrainState` is the whole of it: words and frequencies beside a
  :class:`VocabState`; :func:`init_state` builds it, :func:`merge_step`
  and :func:`merge_chunk` run the reference-shaped step (full recount,
  full-table select) on it, and the fallback engines
  (train/incremental.py, train/bigvocab.py) step it through their own
  count tables;
- :func:`count_pairs`, :func:`max_possible_pair_count` and
  :func:`resolve_count_strategy` are the JAX counting helpers, and
  :func:`count_dtype` picks an int64 table where the pair mass reaches
  2^31, past the int32 table's exactness;
- :func:`merges_to_bytes` (``:280``).

These are XLA code in the JAX package, not a Pallas kernel, so the port
runs them as plain torch ops on the caller's device. A step reads nothing
back to the host: a chunk's steps after a stop write nothing, gated by
device flags, as the JAX chunk's are.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

from yabpe_tpu_torch.core import lexkey
from yabpe_tpu_torch.core.vocab import Vocab
from yabpe_tpu_torch.core.wordtable import WordTable
from yabpe_tpu_torch.kernels.merge_apply import apply_pair_merge
from yabpe_tpu_torch.kernels.pair_count import pair_counts_dense
from yabpe_tpu_torch.kernels.select import select_best_pair


@dataclass
class VocabState:
    """Token table of a merge loop, tensors on one device.

    Attributes:
        token_bytes: [V, L] int32 token byte strings, -1 padded.
        token_len: [V] int32 token byte lengths.
        lex_rank: [V] int32 dense lex rank among live tokens, -1 for free ids.
        next_id: 0-d int32, the first free token id.
        stopped: 0-d bool, set once a step found no pair to merge.
        merges: [M, 3] int32 (left, right, new id) per step, -1 where not
            taken; None where no record is kept (a speculative chain).
        num_done: 0-d int32, the steps taken.
    """

    token_bytes: torch.Tensor
    token_len: torch.Tensor
    lex_rank: torch.Tensor
    next_id: torch.Tensor
    stopped: torch.Tensor
    merges: torch.Tensor | None
    num_done: torch.Tensor

    @classmethod
    def initial(
        cls,
        base_tokens: list[bytes],
        vocab_cap: int,
        byte_width: int,
        num_merges: int,
        device: str | torch.device,
    ) -> "VocabState":
        """The state before the first merge: the base tokens at ids
        0..b0-1, the merge record all -1."""
        token_bytes, token_len = lexkey.initial_token_matrix(
            base_tokens, vocab_cap, byte_width
        )
        lex_rank = lexkey.initial_lex_ranks(base_tokens, vocab_cap)

        def put(a) -> torch.Tensor:
            return torch.tensor(a, dtype=torch.int32, device=device)

        return cls(
            token_bytes=put(token_bytes),
            token_len=put(token_len),
            lex_rank=put(lex_rank),
            next_id=put(len(base_tokens)),
            stopped=torch.tensor(False, device=device),
            merges=torch.full(
                (max(num_merges, 1), 3), -1, dtype=torch.int32, device=device
            ),
            num_done=put(0),
        )

    def speculative_copy(self) -> "VocabState":
        """A copy to run speculative steps on: no merge record."""
        return VocabState(
            **{
                f.name: getattr(self, f.name).clone()
                for f in fields(self)
                if f.name != "merges"
            },
            merges=None,
        )


def vocab_update(
    state: VocabState,
    left: torch.Tensor,
    right: torch.Tensor,
    do: torch.Tensor,
    stopped: torch.Tensor,
    step_index: int,
) -> torch.Tensor:
    """Token-table, lex-rank and merge-record maintenance for one step.

    Counterpart of yabpe_tpu/train/state.py::vocab_update, updating
    ``state`` **in place**. ``left``, ``right`` are 0-d id tensors, ``do``
    and ``stopped`` 0-d bools: where ``do`` is false nothing is grown and
    nothing recorded. Returns the merged symbol id as a 0-d tensor (the
    existing id when the merged bytes are already a live token: the dedup
    branch). Gathers, scatters and selects only, so a device caller never
    waits on the host.
    """
    vocab_cap = state.lex_rank.shape[0]
    merged, merged_len = lexkey.concat_token_bytes(
        state.token_bytes, state.token_len, left, right
    )
    less, equal = lexkey.rows_vs_query(state.token_bytes, merged)
    active = (
        torch.arange(vocab_cap, device=state.lex_rank.device) < state.next_id
    )
    eq_active = equal & active
    exists = eq_active.any()
    existing_id = eq_active.int().argmax().to(state.next_id.dtype)
    new_sym = torch.where(exists, existing_id, state.next_id)

    grow = do & ~exists
    # next_id < vocab_cap whenever a step grows the table (the driver runs
    # vocab_cap - b0 merges at most); the clamp keeps the index in range
    # for the steps that write nothing.
    slot = state.next_id.clamp(max=vocab_cap - 1).long().view(1)
    bumped, insert_rank = lexkey.insert_lex_rank(state.lex_rank, active, less)
    bumped.index_copy_(0, slot, insert_rank.view(1))
    state.lex_rank.copy_(torch.where(grow, bumped, state.lex_rank))
    state.token_bytes.index_copy_(
        0, slot,
        torch.where(grow, merged, state.token_bytes.index_select(0, slot)[0])[None],
    )
    state.token_len.index_copy_(
        0, slot,
        torch.where(grow, merged_len.to(state.token_len.dtype),
                    state.token_len.index_select(0, slot)),
    )
    state.next_id += grow.to(state.next_id.dtype)

    if state.merges is not None:
        row = state.merges[step_index]
        record = torch.stack([t.to(row.dtype) for t in (left, right, new_sym)])
        row.copy_(torch.where(do, record, row))
        state.num_done += do.to(state.num_done.dtype)
    state.stopped = stopped
    return new_sym


@dataclass
class TrainState:
    """The JAX package's ``TrainState`` (``:41``), on one device.

    Attributes:
        words: [N, W] int32 padded symbol rows, updated by the merges.
        freqs: [N] int32 word frequencies (constant).
        vocab: the token table, the merge record and the step counters.
    """

    words: torch.Tensor
    freqs: torch.Tensor
    vocab: VocabState


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def init_state(
    table: WordTable,
    base_vocab: Vocab,
    vocab_cap: int,
    num_merges: int,
    device: str | torch.device,
) -> TrainState:
    """The state before the first merge, on ``device``."""
    if table.freqs.max(initial=0) > np.iinfo(np.int32).max:
        raise ValueError("word frequency exceeds int32; corpus too large for v0")
    base_tokens = list(base_vocab.tokens())
    byte_width = _round_up(max(table.width, base_vocab.max_token_len(), 2), 8)
    return TrainState(
        words=torch.tensor(table.words, dtype=torch.int32, device=device),
        freqs=torch.tensor(table.freqs, dtype=torch.int32, device=device),
        vocab=VocabState.initial(base_tokens, vocab_cap, byte_width, num_merges, device),
    )


#: No pair count can exceed the corpus's total adjacent-position weight, so
#: the JAX package's f32 one-hot matmul counts are exact strictly below this.
MATMUL_EXACT_BOUND = 2**24


def max_possible_pair_count(table: WordTable) -> int:
    """Upper bound on any pair count: sum of freq * (word_len - 1)."""
    lens = (table.words >= 0).sum(axis=1).astype(np.int64)
    return int(np.dot(np.maximum(lens - 1, 0), table.freqs.astype(np.int64)))


def count_dtype(table: WordTable) -> torch.dtype:
    """int32 for the count table while every count stays below 2^31,
    int64 past that (where the JAX package's int32 table would wrap)."""
    return torch.int32 if max_possible_pair_count(table) < 2**31 else torch.int64


def resolve_count_strategy(
    requested: str, table: WordTable, vocab_cap: int, backend: str
) -> str:
    """Resolve ``count_strategy`` to "dense" or "matmul", as the JAX
    package does: "matmul" must be exact (every possible count below
    2^24) or raises ValueError; "auto" takes it only on a TPU at
    vocab <= 2048, so never here. Both count the same table
    (:func:`count_pairs`)."""
    if requested == "dense":
        return "dense"
    bound = max_possible_pair_count(table)
    exact = bound < MATMUL_EXACT_BOUND
    if requested == "matmul":
        if not exact:
            raise ValueError(
                f"count_strategy='matmul' is not exact for this corpus: the "
                f"pair-count bound {bound} reaches the f32 accumulation "
                f"limit {MATMUL_EXACT_BOUND}; use 'dense' or 'auto'"
            )
        return "matmul"
    if requested == "auto":
        profitable = backend == "tpu" and vocab_cap <= 2048
        return "matmul" if (exact and profitable) else "dense"
    raise ValueError(f"unknown count_strategy {requested!r}")


def count_pairs(
    words: torch.Tensor,
    freqs: torch.Tensor,
    vocab_cap: int,
    strategy: str,
    dtype: torch.dtype = torch.int32,
) -> torch.Tensor:
    """The flat [V * V] pair-count table. "dense" and "matmul" give the
    same counts: "matmul" is the TPU's MXU layout of them, so here both
    are ``pair_counts_dense``."""
    if strategy not in ("dense", "matmul"):
        raise ValueError(
            f"unknown count_strategy {strategy!r} (resolve 'auto' with "
            "resolve_count_strategy first)"
        )
    return pair_counts_dense(words, freqs, vocab_cap, dtype)


def merge_step(
    state: TrainState,
    step_index: int,
    *,
    vocab_cap: int,
    min_frequency: int,
    count_strategy: str = "dense",
    dtype: torch.dtype = torch.int32,
) -> None:
    """One merge step, full recount and full-table select, **in place**.

    A step after a stop writes nothing (``do`` is a device flag); the
    caller runs only steps below ``num_merges``.
    """
    counts = count_pairs(state.words, state.freqs, vocab_cap, count_strategy, dtype)
    left, right, best_count = select_best_pair(counts, state.vocab.lex_rank, vocab_cap)
    stopped = state.vocab.stopped | (best_count < max(min_frequency, 1))
    do = ~stopped
    new_sym = vocab_update(state.vocab, left, right, do, stopped, step_index)
    merged = apply_pair_merge(state.words, left, right, new_sym)
    state.words = torch.where(do, merged, state.words)


def merge_chunk(
    state: TrainState,
    chunk_start: int,
    *,
    vocab_cap: int,
    min_frequency: int,
    num_merges: int,
    chunk_size: int,
    count_strategy: str = "dense",
    dtype: torch.dtype = torch.int32,
) -> TrainState:
    """Run merge steps [chunk_start, chunk_start + chunk_size), capped at
    ``num_merges``, on ``state`` in place; returns it."""
    for step in range(chunk_start, min(chunk_start + chunk_size, num_merges)):
        merge_step(
            state, step, vocab_cap=vocab_cap, min_frequency=min_frequency,
            count_strategy=count_strategy, dtype=dtype,
        )
    return state


def merges_to_bytes(
    merges_ids: np.ndarray, base_vocab: Vocab
) -> tuple[Vocab, list[tuple[bytes, bytes]]]:
    """Convert the device merge record back to byte-string merges + vocab.

    Replays id-space merges on the host, growing a copy of the base vocab
    exactly as the device did (dedup included). Rows with a negative left
    id (steps never taken) end the record.
    """
    vocab = Vocab()
    for tok in base_vocab.tokens():
        vocab.add(tok)
    merges: list[tuple[bytes, bytes]] = []
    for left, right, new_sym in merges_ids:
        if left < 0:
            break
        lb = vocab.bytes_of(int(left))
        rb = vocab.bytes_of(int(right))
        got = vocab.add(lb + rb)
        if got != int(new_sym):
            raise AssertionError(
                f"host/device vocab divergence: merge {lb!r}+{rb!r} -> id {got} "
                f"on host but {int(new_sym)} on device"
            )
        merges.append((lb, rb))
    return vocab, merges


__all__ = [
    "MATMUL_EXACT_BOUND",
    "TrainState",
    "VocabState",
    "count_dtype",
    "count_pairs",
    "init_state",
    "max_possible_pair_count",
    "merge_chunk",
    "merge_step",
    "merges_to_bytes",
    "resolve_count_strategy",
    "vocab_update",
]
