"""Host side of the merge-loop kernel (kernels/hbm_loop) on one device.

Counterpart of yabpe_tpu/train/hbm_driver.py. It admits the problem,
turns the numpy word table and base vocabulary into the kernel's state
tensors (:func:`state_from_numpy`), and runs chunks until the merges are
done or a step stops, with one host sync per chunk to read the stop flag.
A resumed run starts at chunk 0 with the checkpoint's record preloaded
and ``replay_until`` at its step count, as the JAX driver does (``:405``):
the kernel replays those steps, then trains live.

:func:`kernel_limits` is the admission as a predicate (the reason a
problem is past the limits of K2, or with ``fused=True`` of K1, or
None), and :func:`admit` its raising form, so that the trainer's route
and :func:`run_hbm_merge_loop`'s own check never disagree (the rule of
the JAX module's ``plan_buckets``, ``:121-124``). A problem past them goes to the fallback
engines (train/bigvocab.py, train/incremental.py); one whose state does
not fit the device's free memory raises on every route
(:func:`check_memory`).

The initial pair counts are a [b0, b0] corner (every initial symbol is a
byte or special id below b0), computed with one numpy bincount and placed
into a device-zeroed [V, V] table, so no [V, V] array crosses from the
host; the corner's block maxima go into a device-zeroed ``block_max``
likewise.
"""

from __future__ import annotations

import numpy as np
import torch

from yabpe_tpu_torch.core import lexkey
from yabpe_tpu_torch.core.vocab import Vocab
from yabpe_tpu_torch.core.wordtable import WordTable
from yabpe_tpu_torch.kernels.hbm_loop import (
    BLOCK_COLS,
    MAX_VOCAB_CAP,
    MAX_WORD_WIDTH,
    N_SCALARS,
    N_STATS,
    NEXT_ID,
    NUM_DONE,
    STAT_BLOCKS_READ,
    STAT_NS_BOUND,
    STAT_NS_COMPARE,
    STAT_NS_VERIFY,
    STAT_NS_VOCAB,
    STAT_REPLAYED,
    STAT_TIE_ROWS,
    STAT_VERIFIED,
    STOPPED,
    HbmState,
    block_count,
    hbm_merge_chunk,
    key_rows,
    raise_on_divergence,
)
from yabpe_tpu_torch.train.state import max_possible_pair_count
from yabpe_tpu_torch.utils import profiling

#: Where the trainer sends problems past these limits.
_ENGINES = "the trainer runs such problems on the bigvocab or incremental engine"


class HbmKernelUnsupported(ValueError):
    """The problem is past the merge kernels' limits."""


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def byte_width(word_width: int, base_tokens: list[bytes]) -> int:
    """Width L of the token byte matrix: a merged token is a substring of
    one word, so the longest word or base token bounds it."""
    longest = max((len(t) for t in base_tokens), default=0)
    return _round_up(max(word_width, longest, 2), 8)


def initial_corner_counts(
    words: np.ndarray, freqs: np.ndarray, base_size: int
) -> np.ndarray:
    """Initial pair counts as a [base, base] int64 corner."""
    left = words[:, :-1]
    right = words[:, 1:]
    valid = (left >= 0) & (right >= 0)
    keys = np.where(valid, left.astype(np.int64) * base_size + right, 0)
    wts = np.where(valid, freqs[:, None].astype(np.int64), 0)
    corner = np.bincount(
        keys.ravel(), weights=wts.ravel(), minlength=base_size * base_size
    )
    return corner.reshape(base_size, base_size).astype(np.int64)


def state_bytes(n_words: int, width: int, vocab_cap: int, token_width: int,
                num_merges: int) -> int:
    """Device bytes of the kernel state, the block bounds and the prefix
    keys included (the engines, which the trainer checks with it too, have
    neither: a tenth of a percent of the table)."""
    v = vocab_cap
    return 4 * (
        n_words * (width + 1) + v * v + v * block_count(v) + v * (token_width + 3)
        + 3 * max(num_merges, 1) + N_SCALARS + N_STATS
    ) + 8 * key_rows(v)


def kernel_limits(table: WordTable, vocab_cap: int, *, fused: bool = False) -> str | None:
    """Why the merge kernels cannot take this problem, or None where they
    can. K2: vocab <= MAX_VOCAB_CAP (its select keys' ids and lex ranks),
    word width <= MAX_WORD_WIDTH (the apply's per-thread arrays) and total
    pair mass below 2^31 (the int32 count table's exactness). K1
    (``fused=True``): the same pair mass only, at any width; its vocab is
    kept far inside 16-bit ids by ``fused_driver.fused_applicable``'s
    48 MB plan, and csrc/fused_loop.cu's entry check refuses the rest."""
    if not fused and (vocab_cap > MAX_VOCAB_CAP or max(table.width, 2) > MAX_WORD_WIDTH):
        return (
            f"vocab {vocab_cap} / word width {table.width} exceed the merge "
            f"kernels' limits (vocab <= {MAX_VOCAB_CAP}, width <= "
            f"{MAX_WORD_WIDTH})"
        )
    mass = max_possible_pair_count(table)
    if mass >= 2**31:
        return (
            f"total pair mass {mass} reaches 2^31, past the int32 count "
            "table's exactness"
        )
    return None


def check_memory(need: int, device: torch.device) -> None:
    """Raise RuntimeError where ``need`` bytes of merge state exceed the
    free memory of a CUDA ``device``; every route needs the [V, V] table,
    so none takes such a problem. Free memory counts the blocks that
    PyTorch's caching allocator holds unused (a previous training's
    table, say), which it releases when an allocation needs them."""
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        free += torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)
        if need > free:
            raise RuntimeError(
                f"merge state needs {need} bytes but {device} has {free} free"
            )


def admit(table: WordTable, vocab_cap: int, num_merges: int,
          token_width: int, device: torch.device, *, fused: bool = False) -> None:
    """The raising form of :func:`kernel_limits` (HbmKernelUnsupported),
    then :func:`check_memory` for the kernel's state."""
    reason = kernel_limits(table, vocab_cap, fused=fused)
    if reason is not None:
        raise HbmKernelUnsupported(f"{reason}; {_ENGINES}")
    check_memory(
        state_bytes(
            table.words.shape[0], max(table.width, 2), vocab_cap, token_width,
            num_merges,
        ),
        device,
    )


def state_from_numpy(
    words: np.ndarray,
    freqs: np.ndarray,
    base_tokens: list[bytes],
    vocab_cap: int,
    device: str | torch.device,
    *,
    num_merges: int | None = None,
) -> HbmState:
    """Build the kernel state on ``device`` from the JAX package's numpy
    inputs: a WordTable's ``words`` [N, W] / ``freqs`` [N], the base
    vocabulary's token bytes, and the vocabulary capacity.

    ``num_merges`` sizes the merge record (default: vocab_cap - b0).
    """
    device = torch.device(device)
    b0 = len(base_tokens)
    v = max(vocab_cap, b0)
    if num_merges is None:
        num_merges = v - b0
    corner = initial_corner_counts(words, freqs, b0)
    if freqs.max(initial=0) > np.iinfo(np.int32).max or corner.max(
        initial=0
    ) > np.iinfo(np.int32).max:
        raise HbmKernelUnsupported(f"a count exceeds int32; {_ENGINES}")
    token_bytes, token_len = lexkey.initial_token_matrix(
        base_tokens, v, byte_width(words.shape[1], base_tokens)
    )
    lex_rank = lexkey.initial_lex_ranks(base_tokens, v)
    token_key = torch.zeros(key_rows(v), dtype=torch.int64)
    token_key[:v] = lexkey.prefix_keys(torch.from_numpy(token_bytes))

    def put(a: np.ndarray) -> torch.Tensor:  # a copy: the state is mutated
        return torch.tensor(a, dtype=torch.int32, device=device)

    counts = torch.zeros((v, v), dtype=torch.int32, device=device)
    counts[:b0, :b0] = put(corner)
    row_max = np.zeros(v, dtype=np.int32)
    row_max[:b0] = corner.max(axis=1, initial=0)
    block_max = torch.zeros((v, block_count(v)), dtype=torch.int32, device=device)
    if b0:
        block_max[:b0, :block_count(b0)] = put(np.stack(
            [corner[:, k:k + BLOCK_COLS].max(axis=1) for k in range(0, b0, BLOCK_COLS)], axis=1
        ))
    scalars = np.zeros(N_SCALARS, dtype=np.int32)
    scalars[NEXT_ID] = b0
    return HbmState(
        words=put(words),
        freqs=put(freqs),
        counts=counts,
        row_max=put(row_max),
        block_max=block_max,
        token_bytes=put(token_bytes),
        token_len=put(token_len),
        lex_rank=put(lex_rank),
        token_key=token_key.to(device),
        merges=torch.full((max(num_merges, 1), 3), -1, dtype=torch.int32, device=device),
        scalars=put(scalars),
        stats=torch.zeros(N_STATS, dtype=torch.int32, device=device),
    )


def run_hbm_merge_loop(
    table: WordTable,
    base_vocab: Vocab,
    *,
    vocab_cap: int,
    num_merges: int,
    min_frequency: int,
    chunk_size: int = 2048,
    device: str | torch.device = "cuda",
    on_chunk=None,
    on_state=None,
    resume: tuple[np.ndarray, int] | None = None,
) -> np.ndarray:
    """Run the merge loop on the kernel; returns [num_merges, 3] int32 ids.

    ``resume=(merges_ids, steps_done)`` replays the record's first
    ``steps_done`` merges through the kernel's replay mode, then trains on
    from there; a record that disagrees with the vocab raises
    AssertionError. ``on_chunk(merges_ids, steps_done)`` gets the merge
    record as numpy after every chunk (the checkpoint saver);
    ``on_state(state, steps_done)`` sees the state itself (tests recount
    the table with it).
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but CUDA is not available")
    base_tokens = list(base_vocab.tokens())
    with profiling.span("yabpe.route.state"):
        admit(
            table, max(vocab_cap, len(base_tokens)), num_merges,
            byte_width(table.width, base_tokens), device,
        )
        state = state_from_numpy(
            table.words, table.freqs, base_tokens, vocab_cap, device,
            num_merges=num_merges,
        )
        replay = {}
        if resume is not None:
            merges_ids, steps_done = resume
            until = max(0, min(int(steps_done), num_merges))
            state.merges[:until] = torch.as_tensor(
                np.asarray(merges_ids[:until], dtype=np.int32), device=device
            )
            replay = dict(replay_until=until)
    return run_chunks(
        hbm_merge_chunk, state, num_merges=num_merges,
        min_frequency=min_frequency, chunk_size=chunk_size, on_chunk=on_chunk,
        on_state=on_state, **replay,
    )


def run_chunks(
    merge_chunk, state, *, num_merges: int, min_frequency: int,
    chunk_size: int, on_chunk=None, on_state=None, **chunk_kw,
) -> np.ndarray:
    """Call ``merge_chunk`` (a kernel wrapper, with ``chunk_kw``) on
    ``state`` chunk by chunk until the merges are done or a step stops,
    with one host sync per chunk (and a copy of the merge record for
    ``on_chunk``); returns the merge record, [num_merges, 3] int32 ids.

    While the tracer is on (utils/profiling.py), each chunk is a span and,
    for K2 on the card, the chunk's sync also reads ``state.stats`` into
    the counters ``k2.steps``, ``k2.rows_verified``, ``k2.blocks_read``,
    ``k2.tie_rows``, ``k2.select_ns``, ``k2.bound_ns`` and ``k2.vocab_ns``
    (:func:`k2_counters`); off, it
    reads nothing more. The twin leaves
    ``stats`` alone, so on the CPU there are no such counters."""
    chunk = max(1, min(chunk_size, num_merges))
    k2 = isinstance(state, HbmState)
    on_card = k2 and state.stats.is_cuda
    last = None  # (scalars, stats) at the previous sync, while tracing
    start = 0
    with profiling.span("yabpe.route.chunks"):
        if on_card and profiling.enabled():
            last = state.scalars.tolist(), state.stats.tolist()
        while start < num_merges:
            with profiling.span("yabpe.k2.chunk" if k2 else "yabpe.k1.chunk", start=start):
                merge_chunk(
                    state,
                    chunk_start=start,
                    chunk_size=chunk,
                    num_merges=num_merges,
                    min_frequency=min_frequency,
                    **chunk_kw,
                )
                start += chunk
                if on_state is not None:
                    on_state(state, min(start, num_merges))
                scalars = state.scalars.tolist()  # the chunk's one host sync
                if on_card and profiling.enabled():
                    now = scalars, state.stats.tolist()
                    if last is not None:
                        for name, n in k2_counters(last, now).items():
                            profiling.count(name, n)
                    last = now
                raise_on_divergence(scalars)
                if on_chunk is not None:
                    on_chunk(state.merges[:num_merges].cpu().numpy(), min(start, num_merges))
            if scalars[STOPPED]:
                break
        return state.merges[:num_merges].cpu().numpy()


def k2_counters(before: tuple[list[int], list[int]],
                after: tuple[list[int], list[int]]) -> dict[str, int]:
    """K2's counters over a stretch of steps, from ``(scalars, stats)`` read
    before and after it: live steps (merges done less replayed steps), the
    rows the select verified, the column blocks those verifies read in
    full, the token rows the dedup compare read where a prefix key tied
    the merged string's, and nanoseconds of the step kernel's phases
    whose work grows with the vocabulary: the select (bound passes and
    verifies), the bound passes alone, and the vocab phases (the dedup
    compare and lex-rank insertion, then the vocab update and the record).
    A replayed step adds to none of these slots. Each ``stats`` slot is an
    int32 that wraps, so each difference is taken modulo 2^32."""
    (s0, t0), (s1, t1) = before, after

    def diff(slot: int) -> int:
        return (t1[slot] - t0[slot]) % 2**32

    return {
        "k2.steps": s1[NUM_DONE] - s0[NUM_DONE] - diff(STAT_REPLAYED),
        "k2.rows_verified": diff(STAT_VERIFIED),
        "k2.blocks_read": diff(STAT_BLOCKS_READ),
        "k2.tie_rows": diff(STAT_TIE_ROWS),
        "k2.select_ns": diff(STAT_NS_BOUND) + diff(STAT_NS_VERIFY),
        "k2.bound_ns": diff(STAT_NS_BOUND),
        "k2.vocab_ns": diff(STAT_NS_COMPARE) + diff(STAT_NS_VOCAB),
    }


__all__ = [
    "MAX_VOCAB_CAP",
    "MAX_WORD_WIDTH",
    "HbmKernelUnsupported",
    "admit",
    "check_memory",
    "kernel_limits",
    "byte_width",
    "initial_corner_counts",
    "k2_counters",
    "run_chunks",
    "run_hbm_merge_loop",
    "state_bytes",
    "state_from_numpy",
]
