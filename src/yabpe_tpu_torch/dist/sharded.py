"""Sharded merge loop over a (data[, vocab]) mesh, in torch.

Counterpart of yabpe_tpu/dist/sharded.py, whose shard_map bodies are XLA
collectives and ``lax`` loops (no Pallas kernel): here they are plain
torch ops on the caller's device. The layout is the JAX package's:

- word rows and frequencies: cut into ``data_shards`` shards, this
  process's on its device (``dist/mesh.py``, process-major);
- token table, lex ranks, merge record: replicated, every process applying
  identical updates;
- pair counts: a persistent table, replicated on every process, as
  ``vocab_shards`` slabs of [V / nv, V] by left-symbol rows (one slab, the
  whole table, on a 1-D mesh), each with its per-row upper bound
  ``row_max`` (the bigvocab engine's lazy select, ``train/bigvocab.py``).

Per step (:func:`_step`): every slab selects its exact best lazily, the
winner is the (count, lex left, lex right) tuple max over the slabs (the
JAX tie-break), every data shard packs its sparse merge delta into the
smallest capacity tier that holds its affected rows, ONE gather of
``(keys | weights)`` over ``data`` follows, and each slab adds the part of
the global delta that lands in its rows. Past the top tier every shard
applies the merge to all its rows and the slabs are recounted (a sum over
``data``). JAX's ``lax.switch`` on a ``pmax``'d tier is a branch on the
device; here the tier is a host integer, so a step reads the device
ONCE: the tier (a max over the local shards, then over the processes),
whether the selects converged, and the stop flag, in one copy. A select
runs ``SELECT_ROUNDS`` rounds on the device before that read; one that
did not converge (rare) finishes on the host, and the step reads again.

``spec_batch > 1`` on a 1-D mesh runs the speculative epochs of
``dist/speculative.py``: k merges per exchange. The merges, and the state
at chunk boundaries, equal the JAX loop's for any layout.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from yabpe_tpu_torch.core.vocab import Vocab
from yabpe_tpu_torch.core.wordtable import WordTable
from yabpe_tpu_torch.dist.mesh import DataMesh, make_2d_mesh
from yabpe_tpu_torch.kernels.merge_apply import apply_pair_merge
from yabpe_tpu_torch.kernels.pair_count import adjacent_pairs
from yabpe_tpu_torch.train.bigvocab import lazy_select_rows, lazy_select_rows_async
from yabpe_tpu_torch.train.incremental import (
    _tier_caps,
    affected_rows_and_tier,
    pack_merge_delta,
    pick_affected_cap,
)
from yabpe_tpu_torch.train.state import (
    VocabState,
    count_dtype,
    init_state,
    vocab_update,
)
from yabpe_tpu_torch.utils.logging import get_logger

_LOG = get_logger(__name__)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass
class Shard2DState:
    """One process's training state on the (data, vocab) mesh.

    Counterpart of the JAX package's ``Shard2DState`` (and, with one slab,
    of the 1-D loop's ``BigState``).

    Attributes:
        vocab: the replicated token table, merge record and stop flag.
        words: this process's data shards, [rows, W] int32 each.
        freqs: their frequencies, [rows] int32 each.
        slabs: the count table's ``vocab_shards`` slabs, flat
            [V / nv * V] each (the count table's dtype).
        row_max: each slab's per-row upper bound, [V / nv].
        stats: counters of the run (steps, host_syncs, full_recounts,
            select_finishes).
    """

    vocab: VocabState
    words: list[torch.Tensor]
    freqs: list[torch.Tensor]
    slabs: list[torch.Tensor]
    row_max: list[torch.Tensor]
    stats: dict

    @property
    def vocab_cap(self) -> int:
        return int(self.vocab.lex_rank.shape[0])

    @property
    def rows_per(self) -> int:
        return self.vocab_cap // len(self.slabs)

    def read(self, mesh: DataMesh, values: list[torch.Tensor]) -> list[int]:
        """The host's one read of a step: ``values`` (0-d integer tensors)
        maxed over the processes."""
        self.stats["host_syncs"] += 1
        packed = torch.stack([v.long() for v in values])
        return mesh.all_reduce(packed, "max").tolist()


def _init_slabs(
    words: list[torch.Tensor],
    freqs: list[torch.Tensor],
    mesh: DataMesh,
    vocab_cap: int,
    dtype: torch.dtype,
) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """Every slab's count table and row maxima: the local shards' counts of
    the pairs whose left symbol is in the slab's rows, summed over ``data``
    (the JAX ``_init_slab_body``)."""
    V = vocab_cap
    rows_per = V // mesh.vocab_shards
    slabs, row_max = [], []
    for v in range(mesh.vocab_shards):
        lo = v * rows_per
        slab = torch.zeros(rows_per * V, dtype=dtype, device=mesh.device)
        for w, f in zip(words, freqs):
            left, right, valid = adjacent_pairs(w)
            in_slice = valid & (left >= lo) & (left < lo + rows_per)
            key = torch.where(in_slice, (left.long() - lo) * V + right, 0)
            weight = torch.where(in_slice, f[:, None].to(dtype), 0)
            slab.index_add_(0, key.reshape(-1), weight.reshape(-1))
        slab = mesh.all_reduce(slab, "sum")
        slabs.append(slab)
        row_max.append(slab.view(rows_per, V).amax(dim=1))
    return slabs, row_max


def _select(state: Shard2DState, exact: bool):
    """Each slab's (count, global left, right) best and whether its select
    converged; ``exact`` finishes the selects on the host."""
    V, rows_per = state.vocab_cap, state.rows_per
    lex = state.vocab.lex_rank
    cands = []
    for v, (slab, rm) in enumerate(zip(state.slabs, state.row_max)):
        lex_rows = lex[v * rows_per : (v + 1) * rows_per]
        if exact:
            m, a, b, _ = lazy_select_rows(slab, rm, lex_rows, lex, V)
            done = torch.ones((), dtype=torch.bool, device=slab.device)
        else:
            m, a, b, done = lazy_select_rows_async(slab, rm, lex_rows, lex, V)
        cands.append((m, a + v * rows_per, b, done))
    return cands


def _winner(cands, lex_rank: torch.Tensor):
    """The exact tuple-order winner over the slabs: the count first, then
    the lex rank of the left symbol, then of the right (the JAX loop's
    gather over ``vocab``)."""
    counts_v = torch.stack([c[0] for c in cands])
    lefts_v = torch.stack([c[1] for c in cands]).long()
    rights_v = torch.stack([c[2] for c in cands]).long()
    tie1 = counts_v == counts_v.max()
    s2 = torch.where(tie1, lex_rank[lefts_v], -1)
    tie2 = tie1 & (s2 == s2.max())
    s3 = torch.where(tie2, lex_rank[rights_v], -1)
    widx = s3.argmax()
    done = torch.stack([c[3] for c in cands]).all()
    return lefts_v[widx].int(), rights_v[widx].int(), counts_v[widx], done


def _apply_delta(state: Shard2DState, gkeys: torch.Tensor, gw: torch.Tensor) -> None:
    """Add the gathered global delta to each slab's rows, and raise the
    bounds of the rows it touched to their new values."""
    V, rows_per = state.vocab_cap, state.rows_per
    slab_cells = rows_per * V
    live = gw != 0  # an empty slot's cells carry weight 0
    for v, (slab, rm) in enumerate(zip(state.slabs, state.row_max)):
        lk = gkeys - v * slab_cells
        in_slab = live & (lk >= 0) & (lk < slab_cells)
        lk = torch.where(in_slab, lk, 0)
        slab.index_add_(0, lk, torch.where(in_slab, gw, 0).to(slab.dtype))
        vals = torch.where(in_slab, slab.index_select(0, lk), -1)
        rm.scatter_reduce_(0, lk // V, vals, "amax")


def _step(
    state: Shard2DState,
    mesh: DataMesh,
    step: int,
    *,
    min_frequency: int,
    affected_cap: int,
) -> bool:
    """One merge step, **in place**; returns whether the loop stopped."""
    st = state.vocab
    V = state.vocab_cap
    caps = _tier_caps(affected_cap)
    exact = False
    while True:
        left, right, best, done = _winner(_select(state, exact), st.lex_rank)
        stopped = st.stopped | (best < max(min_frequency, 1)) | (best <= 0)
        do = ~stopped
        aff = [
            affected_rows_and_tier(w, left, right, do, affected_cap)[:2]
            for w in state.words
        ]
        tier_local = torch.stack([t for _, t in aff]).amax()
        tier, not_done, stop = state.read(mesh, [tier_local, ~done, stopped])
        if not not_done:
            break
        state.stats["select_finishes"] += 1
        exact = True

    new_sym = vocab_update(st, left, right, do, stopped, step)
    if tier < len(caps):
        parts = []
        for w, f, (affected, _) in zip(state.words, state.freqs, aff):
            keys, wts = pack_merge_delta(
                w, f, affected, left, right, new_sym, caps[tier], V,
                state.slabs[0].dtype,
            )
            # ONE exchange for (keys | weights): latency, not payload,
            # dominates a step across processes.
            parts.append(torch.stack([keys, wts.long()]))
        packed = mesh.all_gather(parts)
        _apply_delta(state, packed[:, 0].reshape(-1), packed[:, 1].reshape(-1))
    else:
        # only reachable where do is true (an empty affected set is tier 0)
        state.stats["full_recounts"] += 1
        state.words = [apply_pair_merge(w, left, right, new_sym) for w in state.words]
        dtype = state.slabs[0].dtype
        state.slabs = state.row_max = []  # free the old slabs first
        state.slabs, state.row_max = _init_slabs(state.words, state.freqs, mesh, V, dtype)
    state.stats["steps"] += 1
    return bool(stop)


def run_steps(
    state: Shard2DState,
    mesh: DataMesh,
    start: int,
    end: int,
    *,
    min_frequency: int,
    affected_cap: int,
) -> None:
    """Merge steps [start, end) on ``state``, in place; the steps after a
    stop are skipped (the JAX chunk runs them as no-ops)."""
    for step in range(start, end):
        if _step(
            state, mesh, step, min_frequency=min_frequency,
            affected_cap=affected_cap,
        ):
            break


def _synced_clock(device: torch.device) -> float:
    """The host clock once the device's queued work is done."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def init_sharded_state(
    table: WordTable,
    base_vocab: Vocab,
    mesh: DataMesh,
    *,
    vocab_cap: int,
    num_merges: int,
    resume: tuple[np.ndarray, int] | None = None,
) -> tuple[Shard2DState, int]:
    """The state before the first step, or after ``resume``'s replay, and
    the first step. ``table`` is padded to whole data shards and
    ``vocab_cap`` a multiple of the vocab shards (the caller's, in the JAX
    order)."""
    device = mesh.device
    t0 = time.perf_counter()
    if resume is not None:
        from yabpe_tpu_torch.train.checkpoint import resume_state

        merges_ids, steps_done = resume
        start = min(int(steps_done), num_merges)
        core = resume_state(
            table, base_vocab, vocab_cap, num_merges, merges_ids, start, device
        )
    else:
        start = 0
        core = init_state(table, base_vocab, vocab_cap, num_merges, device)
    rows = table.words.shape[0] // mesh.num_shards
    local = mesh.local_shards
    if not local:
        raise ValueError(
            f"process {mesh.rank} holds no shard of the {mesh.num_shards}-shard "
            "data mesh"
        )
    words = [core.words[d * rows : (d + 1) * rows].clone() for d in local]
    freqs = [core.freqs[d * rows : (d + 1) * rows].clone() for d in local]
    dtype = count_dtype(table)
    t1 = _synced_clock(device)
    slabs, row_max = _init_slabs(words, freqs, mesh, vocab_cap, dtype)
    stats = dict(
        steps=0, host_syncs=0, full_recounts=0, select_finishes=0,
        resume_seconds=t1 - t0, slab_init_seconds=_synced_clock(device) - t1,
    )
    return Shard2DState(core.vocab, words, freqs, slabs, row_max, stats), start


def run_sharded_merge_loop(
    table: WordTable,
    base_vocab: Vocab,
    *,
    vocab_cap: int,
    num_merges: int,
    min_frequency: int,
    data_shards: int,
    vocab_shards: int = 1,
    chunk_size: int = 256,
    resume: tuple[np.ndarray, int] | None = None,
    on_chunk=None,
    spec_batch: int = 0,
    stats_out: dict | None = None,
    device: str | torch.device = "cuda",
    processes: int = 1,
    backend: str | None = None,
) -> np.ndarray:
    """Run the merge loop sharded over a (data[, vocab]) mesh.

    Word rows are data-parallel; with ``vocab_shards > 1`` the count table
    is kept as slabs of left-symbol rows. Returns the [num_merges, 3] merge
    record, identical to the single-device loop's for any layout.
    ``resume=(merges_ids, steps_done)`` replays a checkpoint first;
    ``on_chunk(merges_ids, steps_done)`` fires after every chunk.
    ``processes`` > 1 spreads the data shards over the processes of the
    initialized default process group, over ``backend`` ("nccl" or
    "gloo"); every process passes the same table.

    ``spec_batch > 1`` (1-D meshes only) batches that many merges per
    exchange in speculate/validate epochs (``dist/speculative.py``): the
    mode for meshes where one exchange per merge is slow. With
    ``vocab_shards > 1`` it is ignored, with a warning, as in the JAX loop.
    ``stats_out`` receives ``steps`` (merge steps of the per-step loop),
    ``host_syncs``, ``full_recounts``, ``select_finishes``,
    ``resume_seconds`` (the checkpoint's replay, with the state's set-up),
    ``slab_init_seconds`` and ``loop_seconds``, and on the speculative
    loop its epochs' counters.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but CUDA is not available")
    mesh = make_2d_mesh(data_shards, vocab_shards, device, processes, backend)
    vocab_cap = _round_up(vocab_cap, vocab_shards)
    table = table.pad_rows_to(_round_up(table.words.shape[0], data_shards))
    state, start = init_sharded_state(
        table, base_vocab, mesh, vocab_cap=vocab_cap, num_merges=num_merges,
        resume=resume,
    )
    chunk = max(1, min(chunk_size, num_merges))
    affected_cap = pick_affected_cap(table.words.shape[0] // data_shards)
    t0 = time.perf_counter()

    if spec_batch > 1 and vocab_shards > 1:
        _LOG.warning(
            "spec_batch=%d ignored: speculative epochs need the replicated "
            "frozen count table for communication-free selection, which a "
            "vocab-sharded mesh does not hold; the 2D loop runs per step",
            spec_batch,
        )
    if spec_batch > 1 and vocab_shards == 1:
        from yabpe_tpu_torch.dist.speculative import run_speculative

        merges = run_speculative(
            state, mesh, start,
            num_merges=num_merges, min_frequency=min_frequency, chunk=chunk,
            spec_batch=spec_batch, affected_cap=affected_cap,
            on_chunk=on_chunk, stats_out=stats_out,
        )
    else:
        while start < num_merges:
            end = min(start + chunk, num_merges)
            run_steps(
                state, mesh, start, end, min_frequency=min_frequency,
                affected_cap=affected_cap,
            )
            start = end
            if on_chunk is not None:
                on_chunk(state.vocab.merges.cpu().numpy(), start)
            state.stats["host_syncs"] += 1
            if bool(state.vocab.stopped):
                break
        merges = state.vocab.merges.cpu().numpy()
    seconds = time.perf_counter() - t0
    steps = max(state.stats["steps"], 1)
    _LOG.info(
        "sharded loop: %d x %d shards, %d steps in %.3fs, %.2f host syncs "
        "a step, %d full recounts",
        data_shards, vocab_shards, state.stats["steps"], seconds,
        state.stats["host_syncs"] / steps, state.stats["full_recounts"],
    )
    if stats_out is not None:
        stats_out.update(state.stats, loop_seconds=seconds)
    return merges


__all__ = [
    "Shard2DState",
    "init_sharded_state",
    "run_sharded_merge_loop",
    "run_steps",
]
