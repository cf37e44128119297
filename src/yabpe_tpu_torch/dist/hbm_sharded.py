"""Data-sharded merge loop with the replay kernel on every word shard.

Counterpart of yabpe_tpu/dist/hbm_sharded.py. The word table is cut into
``data_shards`` contiguous row ranges; the replicated selection and
validation state (the [V, V] count table, its row-max bound, the token
table) lives in torch on the loop's device. Per epoch of up to ``k``
merges:

1. **Select** (:func:`_select_chain`): pick a speculative chain of k
   merges from the table as it stands, re-selecting after each pick from
   a view adjusted by the follow-up estimate (``dist/speculative.py``).
2. **Replay** (``kernels/replay_emit.py``): every shard replays the chain
   over its words in one kernel call and logs each step's delta cells at
   a fixed capacity (overflow flagged, never folded in).
3. **Exchange and validate** (:func:`_validate`): the shards' logs are
   stacked (``dist/mesh.py``), and selection runs again against the true,
   evolving table; the longest exact, overflow-free prefix commits. The
   merges equal the single-device loop's for any shard count.
4. **Commit**: a full chain keeps the replayed shards; a prefix is
   replayed again over the epoch-start shards.

The host reads the device once per epoch: the committed count, the stop
flag and the chain's length, in one copy. Inside an epoch nothing waits
on the host: the exact selects run a fixed number of verify rounds
(``train/bigvocab.py``) and report exactness as a flag; a validation step
whose select was not exact is not committed, and its epoch ends there (a
"select cut"; the re-scanned bounds are tighter for the next epoch).

Differences from the JAX loop, none of which changes a merge:

- the shards are the port's [N, W] int32 words, not packed i16 rows, so
  ids up to the vocabulary cap need no ``wide`` mode, and a shard holds
  exactly its rows, without padding;
- the speculative view is the table itself: the chain adds its estimates
  in place and takes them back out exactly (integer adds) before the
  replay, where the JAX loop keeps a second [V, V] copy;
- cells are scattered by flat int64 index; a cell that must not count
  goes to a spare row V of the table with weight 0;
- the validation's exchange is one gather of each shard's logs, flags
  and cursors, packed, where the JAX loop's shard_map takes the logs as
  a sharded array.

Across processes (``processes`` > 1, ``dist/mesh.py``), each process
builds and replays only its own shards, process-major; the selection and
validation state is replicated, and every process validates the same
gathered logs, so they all commit the same prefix.

Scope: vocab_cap <= 63,488, word width <= 64, total pair mass < 2^31 (the
int32 table's exactness, as in ``train/hbm_driver.py``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from yabpe_tpu_torch.core.vocab import Vocab
from yabpe_tpu_torch.core.wordtable import WordTable
from yabpe_tpu_torch.dist.mesh import DataMesh, make_data_mesh
from yabpe_tpu_torch.dist.speculative import estimate_followup_2d
from yabpe_tpu_torch.kernels.replay_emit import (
    max_log_rows,
    replay_emit_chunk,
    step_live,
    step_slots,
)
from yabpe_tpu_torch.train.bigvocab import lazy_select_2d
from yabpe_tpu_torch.train.hbm_driver import byte_width, initial_corner_counts
from yabpe_tpu_torch.train.state import VocabState, vocab_update
from yabpe_tpu_torch.utils.logging import get_logger

_LOG = get_logger(__name__)

#: The JAX loop's limits (u16 ids in its packed words; word width).
MAX_VOCAB_CAP = 63488
MAX_WORD_WIDTH = 64

#: Phases of an epoch, in the order ``stats_out["phase_ms"]`` lists them.
PHASES = ("select", "replay", "validate", "commit")


class HbmShardedUnsupported(ValueError):
    """The problem violates a precondition of the sharded loop."""


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def hbm_sharded_applicable(
    n_words: int,
    word_width: int,
    vocab_cap: int,
    data_shards: int = 1,
    processes: int = 1,
) -> bool:
    """The JAX loop's preconditions (yabpe_tpu/dist/hbm_sharded.py:83),
    kept as they are so that both trainers route the same problems here:
    the vocabulary and width caps, a shard for every process, and room in
    the log plan for the smallest useful chain."""
    if vocab_cap > MAX_VOCAB_CAP or max(word_width, 2) > MAX_WORD_WIDTH:
        return False
    if processes > max(data_shards, 1):
        return False
    W = max(word_width, 2)
    S = max(data_shards, 1)
    nrs = _round_up((n_words + S * 128 - 1) // (S * 128), 8)
    # the smallest useful log plan: cps0=32 + (k-1) * cps=8 at k=2
    return max_log_rows(nrs, (W + 2) * 128) >= 40


def log_plan(
    n_words: int, word_width: int, data_shards: int, k: int, cps: int
) -> tuple[int, int]:
    """(cap_rows, cps0): the JAX loop's log plan (``:363-376``).

    Merge 0 of an epoch sees the heaviest delta, so it owns cps0 rows of
    128 cells, about twice the shard's 128-word row count, later steps
    ``cps`` rows each; cap_rows bounds every plan, the overflow fallback's
    included (the TPU kernel's VMEM budget, kept so that cps0 is the JAX
    package's).
    """
    W = max(word_width, 2)
    S = data_shards
    nrs = _round_up((n_words + S * 128 - 1) // (S * 128), 8)
    cap_rows = max_log_rows(nrs, (W + 2) * 128)
    if cap_rows < (k - 1) * cps + 32:
        raise HbmShardedUnsupported(
            f"word shard ({nrs} rows of 128 words) leaves no room for the "
            f"cell logs (max {cap_rows} rows < k*cps plan); raise data_shards"
        )
    cps0 = _round_up(min(max(4 * cps, 2 * nrs), 8192), 8)
    return cap_rows, min(cps0, cap_rows - (k - 1) * cps)


def shard_rows(n_words: int, data_shards: int) -> list[tuple[int, int]]:
    """[lo, hi) row range of each shard: contiguous ranges of a whole
    number of 8 x 128-word blocks, as the JAX loop cuts (``:320``)."""
    S = data_shards
    rows_per = _round_up((n_words + S * 128 - 1) // (S * 128), 8) * 128
    bounds = []
    for d in range(S):
        lo = min(d * rows_per, n_words)
        bounds.append((lo, min(lo + rows_per, n_words)))
    return bounds


def _admit(table: WordTable, vocab_cap: int) -> None:
    if vocab_cap > MAX_VOCAB_CAP:
        raise HbmShardedUnsupported(
            f"vocab_cap {vocab_cap} > {MAX_VOCAB_CAP}; the sharded loop's "
            "limit (the JAX loop's u16 packed ids)"
        )
    if max(table.width, 2) > MAX_WORD_WIDTH:
        raise HbmShardedUnsupported(
            f"word width {table.width} > {MAX_WORD_WIDTH}"
        )
    lengths = (table.words >= 0).sum(axis=1).astype(np.int64)
    freqs = table.freqs.astype(np.int64)
    mass = int((np.maximum(lengths - 1, 0) * freqs).sum())
    if mass >= 2**31 or freqs.max(initial=0) > np.iinfo(np.int32).max:
        raise HbmShardedUnsupported(
            f"total pair mass {mass} reaches 2^31, past the int32 count "
            "table's exactness"
        )


class _Tables:
    """The replicated count state: counts [V, V] and row_max [V], views of
    tensors with a spare row V that takes the cells that must not count."""

    def __init__(self, corner: np.ndarray, vocab_cap: int, device) -> None:
        b0 = corner.shape[0]
        v = vocab_cap
        self.v = v
        self.counts_ext = torch.zeros((v + 1, v), dtype=torch.int32, device=device)
        self.counts = self.counts_ext[:v]
        self.counts[:b0, :b0] = torch.tensor(corner, dtype=torch.int32, device=device)
        self.row_max_ext = torch.zeros((v + 1,), dtype=torch.int32, device=device)
        self.row_max = self.row_max_ext[:v]
        self.row_max[:b0] = torch.tensor(
            corner.max(axis=1, initial=0), dtype=torch.int32, device=device
        )
        self._spread: dict[int, torch.Tensor] = {}

    def fold(self, left, right, weight, live) -> None:
        """Add the live cells to the table and raise their rows' bounds."""
        v = self.v
        n = left.numel()
        spread = self._spread.get(n)
        if spread is None:  # spare-row columns, spread to avoid one hot cell
            spread = torch.arange(n, device=left.device) % v + v * v
            self._spread[n] = spread
        flat = torch.where(live, left.long() * v + right.long(), spread)
        table = self.counts_ext.view(-1)
        table.index_add_(0, flat, torch.where(live, weight, 0))
        vals = torch.where(live, table.gather(0, flat), -1)
        rows = torch.where(live, left.long(), v)
        self.row_max_ext.scatter_reduce_(0, rows, vals, "amax")


def _select_chain(
    tables: _Tables,
    vocab: VocabState,
    ptr: int,
    *,
    k: int,
    min_frequency: int,
    num_merges: int,
    inexact: torch.Tensor,
):
    """Speculative k-merge chain off the table as it stands.

    Returns [k] int32 tensors (A, B, C, ok); ok[j] = 0 marks rows past a
    stop in the chain or the merge budget (the kernel skips them;
    validation decides the real stop). The speculative token table and
    the view's estimates are discarded: the table is returned exactly as
    it came. Counts the chain's inexact selects into ``inexact``.
    """
    counts = tables.counts
    rmv = tables.row_max.clone()
    spec = vocab.speculative_copy()
    ok_chain = torch.ones((), dtype=torch.bool, device=counts.device)
    picks: list[list[torch.Tensor]] = [[], [], [], []]
    added: list[tuple[torch.Tensor, torch.Tensor]] = []
    for j in range(min(k, num_merges - ptr)):
        left, right, cnt, exact = lazy_select_2d(counts, rmv, spec.lex_rank)
        inexact += ~exact
        frozen_stop = (cnt < max(min_frequency, 1)) | (cnt <= 0)
        do = ok_chain & ~frozen_stop
        new_sym = vocab_update(spec, left, right, do, spec.stopped, ptr + j)
        added.append(
            estimate_followup_2d(counts, rmv, left, right, cnt, new_sym, do)
        )
        for out, value in zip(picks, (left, right, new_sym, do)):
            out.append(value.to(torch.int32))
        ok_chain = do
    cells = torch.cat([c for c, _ in added])
    deltas = torch.cat([d for _, d in added])
    counts.view(-1).index_add_(0, cells, -deltas)
    pad = k - len(added)
    return tuple(
        torch.nn.functional.pad(torch.stack(values), (0, pad)) for values in picks
    )


def _validate(
    mesh: DataMesh,
    outs,
    A: torch.Tensor,
    B: torch.Tensor,
    okf: torch.Tensor,
    tables: _Tables,
    vocab: VocabState,
    ptr: int,
    *,
    k: int,
    cps: int,
    cps0: int,
    min_frequency: int,
    num_merges: int,
    replay: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exchange the shards' cell logs and commit the exact prefix.

    Replays selection against the true table, folding in the gathered
    cells of each step that matches; updates ``tables`` and ``vocab`` in
    place. ``replay=True`` is the resume path: (a, b) come from the
    recorded merges instead of live selection, and the stop test is
    skipped (recorded merges were all committed once). Returns 0-d tensors
    (p, cut): the merges committed, and whether the commit ended at a
    select that was not exact.
    """
    # ONE exchange a call: each shard's (left | right | weight | ok | cursor)
    cells = outs[0][1].numel()
    g = mesh.all_gather([
        torch.cat([o[1].view(-1), o[2].view(-1), o[3].view(-1), o[4], o[5]])
        for o in outs
    ])
    g_l, g_r, g_w = g[:, :cells], g[:, cells : 2 * cells], g[:, 2 * cells : 3 * cells]
    g_ok = g[:, 3 * cells : 3 * cells + k]  # [S, k]
    g_cursor = g[:, 3 * cells + k :]  # [S, k]
    ok_all = (g_ok.amin(dim=0) > 0) & (okf > 0)
    device = okf.device
    valid = torch.ones((), dtype=torch.bool, device=device)
    never = torch.zeros((), dtype=torch.bool, device=device)
    cut = never
    stopped = vocab.stopped
    p = torch.zeros((), dtype=torch.int32, device=device)
    for j in range(min(k, num_merges - ptr)):
        if replay:
            a_t, b_t, true_stop, exact = A[j], B[j], never, ~never
        else:
            a_t, b_t, cnt_t, exact = lazy_select_2d(
                tables.counts, tables.row_max, vocab.lex_rank
            )
            true_stop = (cnt_t < max(min_frequency, 1)) | (cnt_t <= 0)
        match = (
            valid & ~true_stop & exact & ok_all[j]
            & (a_t == A[j]) & (b_t == B[j])
        )
        # a select that is not exact still bounds the count from above, so
        # its stop is real; its pick is not committed
        stopped = stopped | (valid & true_stop)
        cut = cut | (valid & ~true_stop & ~exact)
        vocab_update(vocab, a_t, b_t, match, stopped, ptr + j)
        # a step's cells are each shard's slots below its cursor; the
        # kernel leaves the slots past them unwritten
        first, count = step_slots(j, cps, cps0)
        tables.fold(
            g_l[:, first : first + count].reshape(-1),
            g_r[:, first : first + count].reshape(-1),
            g_w[:, first : first + count].reshape(-1),
            match & step_live(g_cursor, j, cps=cps, cps0=cps0).reshape(-1),
        )
        p = p + match.to(torch.int32)
        valid = match
    vocab.stopped = stopped
    return p, cut


class _PhaseTimer:
    """CUDA events at the phase boundaries of every epoch, read once at
    the end (no sync in the loop); a no-op unless ``on``."""

    def __init__(self, on: bool) -> None:
        self.on = on
        self.epochs: list[list[torch.cuda.Event]] = []

    def mark(self, start: bool = False) -> None:
        if not self.on:
            return
        if start:
            self.epochs.append([])
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        self.epochs[-1].append(event)

    def totals(self) -> dict[str, float]:
        sums = dict.fromkeys(PHASES, 0.0)
        for events in self.epochs:
            for name, (t0, t1) in zip(PHASES, zip(events, events[1:])):
                sums[name] += t0.elapsed_time(t1)
        return sums


def run_hbm_sharded_merge_loop(
    table: WordTable,
    base_vocab: Vocab,
    *,
    vocab_cap: int,
    num_merges: int,
    min_frequency: int,
    data_shards: int,
    spec_batch: int = 16,
    cps: int = 64,
    device: str | torch.device = "cuda",
    stats_out: dict | None = None,
    resume: tuple[np.ndarray, int] | None = None,
    on_chunk=None,
    processes: int = 1,
    backend: str | None = None,
) -> np.ndarray:
    """Run the merge loop with the replay kernel on every word shard.

    Returns the [num_merges, 3] merge record (left, right, new id), equal
    to the single-device loop's for any shard count. ``cps`` is the cell-log
    capacity of a step past the first, in 128-cell rows; an epoch whose
    first step overflows runs that merge alone at a capacity doubled until
    it fits (HbmShardedUnsupported past the log plan's cap).

    ``resume`` is a ``(merges_ids, steps_done)`` record: its first
    ``steps_done`` merges replay through the same kernel calls and
    validation, selection skipped, rebuilding the exact state before live
    training goes on. ``on_chunk(merges_ids, steps_done)`` fires after
    every live epoch that commits. ``stats_out`` receives ``epochs``,
    ``fallbacks``, ``merges_done``, ``select_cuts`` (epochs ended by a
    select that was not exact), ``chain_inexact`` (speculative picks that
    were not exact), ``loop_seconds`` and, on the card, ``phase_ms``:
    device-timeline milliseconds of the epochs' phases, summed.

    ``processes`` > 1 spreads the shards over the processes of the
    initialized default process group (``backend`` "nccl" or "gloo"),
    process-major: each process builds and replays only its own shards,
    and the epoch's cell logs and overflow flags go through
    ``DataMesh.all_gather``; every process passes the same table.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but CUDA is not available")
    _admit(table, vocab_cap)
    k = max(2, int(spec_batch))
    S = data_shards
    mesh = make_data_mesh(S, device, processes, backend)
    if not mesh.local_shards:
        raise HbmShardedUnsupported(
            f"process {mesh.rank} holds no shard of the {S}-shard data mesh"
        )
    base_tokens = list(base_vocab.tokens())
    b0 = len(base_tokens)
    V = vocab_cap
    words_np = table.words
    if words_np.shape[1] < 2:
        words_np = np.pad(words_np, ((0, 0), (0, 2 - words_np.shape[1])), constant_values=-1)
    n = words_np.shape[0]
    cap_rows, cps0 = log_plan(n, words_np.shape[1], S, k, cps)

    shards = []
    bounds = shard_rows(n, S)
    for (lo, hi), dev in zip((bounds[d] for d in mesh.local_shards), mesh.devices):
        shards.append((
            torch.tensor(words_np[lo:hi], dtype=torch.int32, device=dev),
            torch.tensor(table.freqs[lo:hi], dtype=torch.int32, device=dev),
        ))

    # ---- replicated selection and validation state
    tables = _Tables(initial_corner_counts(words_np, table.freqs, b0), V, device)
    vocab = VocabState.initial(
        base_tokens, V, byte_width(table.width, base_tokens), num_merges, device
    )
    inexact = torch.zeros((), dtype=torch.int32, device=device)

    def dispatch(words, chain, cc, cc0):
        return [
            replay_emit_chunk(w, f, chain, cps=cc, cps0=cc0)
            for w, f in words
        ]

    def validate(outs, A, B, okf, kk, cc0, replay):
        return _validate(
            mesh, outs, A, B, okf, tables, vocab, ptr, k=kk, cps=cps, cps0=cc0,
            min_frequency=min_frequency, num_merges=num_merges, replay=replay,
        )

    def read(*values) -> list[int]:  # the epoch's one host sync
        return torch.stack([v.to(torch.int32) for v in values]).tolist()

    timer = _PhaseTimer(stats_out is not None and device.type == "cuda")
    ptr = epochs = fallbacks = cuts = 0
    replay_n = 0
    merges_rec = None
    if resume is not None:
        merges_rec, steps_done = resume
        replay_n = max(0, min(int(steps_done), num_merges))
    t0 = time.perf_counter()
    stopped = False
    while ptr < num_merges and not stopped:
        in_replay = ptr < replay_n
        timer.mark(start=True)
        if in_replay:
            kk = min(k, replay_n - ptr)
            rec = np.zeros((k, 3), np.int32)
            rec[:kk] = merges_rec[ptr : ptr + kk]
            A, B, C = torch.tensor(rec.T, device=device).unbind()
            okf = (torch.arange(k, device=device) < kk).to(torch.int32)
        else:
            A, B, C, okf = _select_chain(
                tables, vocab, ptr, k=k, min_frequency=min_frequency,
                num_merges=num_merges, inexact=inexact,
            )
        chain = torch.stack([torch.where(okf > 0, A, -1), B, C], dim=1).contiguous()
        timer.mark()
        outs = dispatch(shards, chain, cps, cps0)
        timer.mark()
        p_t, cut_t = validate(outs, A, B, okf, k, cps0, in_replay)
        timer.mark()
        p, stop, cut, m_active = read(p_t, vocab.stopped, cut_t, okf.sum())
        epochs += 1
        cuts += cut
        if p == 0 and not stop and not cut:
            # merge 0's cells overflowed cps0 rows on some shard (its select
            # is the chain's own, on the same table and bounds, so it
            # matched): run that merge alone, doubling the log capacity
            # until it fits or the plan's cap is reached
            fallbacks += 1
            fb_cap = cap_rows - cps
            cps0_fb = min(4 * cps0, fb_cap)
            chain1 = chain[:2].clone()
            chain1[1, 0] = -1  # k=2: one live step
            ok1 = okf[:2] * torch.tensor([1, 0], dtype=okf.dtype, device=device)
            while True:
                outs = dispatch(shards, chain1, cps, cps0_fb)
                p_t, _ = validate(outs, A[:2], B[:2], ok1, 2, cps0_fb, in_replay)
                p, stop = read(p_t, vocab.stopped)
                if p > 0 or stop:
                    break
                if cps0_fb >= fb_cap:
                    raise HbmShardedUnsupported(
                        "merge delta exceeds the largest cell log of the "
                        f"plan ({cps0_fb} rows per shard); raise data_shards"
                    )
                cps0_fb = min(2 * cps0_fb, fb_cap)
            m_active = min(m_active, 1)
        if p >= m_active and m_active > 0:
            shards = [(o[0], f) for o, (_, f) in zip(outs, shards)]
        elif p > 0:
            commit = chain.clone()
            commit[p:, 0] = -1
            outs_c = dispatch(shards, commit, cps, cps0)
            shards = [(o[0], f) for o, (_, f) in zip(outs_c, shards)]
        timer.mark()
        ptr += p
        stopped = bool(stop)
        if in_replay and ptr >= replay_n:
            # replay runs no select, so no bound was tightened: start the
            # live epochs from exact bounds
            tables.row_max.copy_(tables.counts.amax(dim=1))
        if on_chunk is not None and not in_replay and p > 0:
            on_chunk(vocab.merges.cpu().numpy(), min(ptr, num_merges))

    merges = vocab.merges.cpu().numpy()
    seconds = time.perf_counter() - t0
    if stats_out is not None:
        stats_out["epochs"] = epochs
        stats_out["fallbacks"] = fallbacks
        stats_out["merges_done"] = ptr
        stats_out["select_cuts"] = cuts
        stats_out["chain_inexact"] = int(inexact)
        stats_out["loop_seconds"] = seconds
        if timer.on:
            stats_out["phase_ms"] = timer.totals()
    _LOG.info(
        "hbm-sharded loop: %d merges in %d epochs (%.2f commits/epoch, "
        "%d fallbacks, %d select cuts) over %d shards in %.3fs",
        ptr, epochs, ptr / max(epochs, 1), fallbacks, cuts, S, seconds,
    )
    return merges


__all__ = [
    "HbmShardedUnsupported",
    "MAX_VOCAB_CAP",
    "MAX_WORD_WIDTH",
    "PHASES",
    "hbm_sharded_applicable",
    "log_plan",
    "run_hbm_sharded_merge_loop",
    "shard_rows",
]
