"""Latency-tolerant sharded merge loop: k merges per exchange.

Counterpart of yabpe_tpu/dist/speculative.py, in torch on the caller's
device. The per-step sharded loop (``dist/sharded.py``) exchanges once per
merge; this module amortizes the exchanges with SPECULATE -> EXCHANGE ->
VALIDATE epochs (:func:`_spec_epoch`):

1. **Speculate** (no exchange, replicated decisions): from the count table
   as it stands, pick k candidate merges, re-selecting after each pick
   from a view adjusted by the follow-up estimate
   (:func:`estimate_followup_2d`); apply them to this process's word
   shards and pack each merge's sparse delta at a fixed capacity (a
   shard's overflow is flagged, never folded in).
2. **Exchange**: the k packed deltas and overflow flags of every shard in
   ONE gather.
3. **Validate** (no exchange, replicated): replay selection against the
   true, evolving table; the longest prefix whose picks are the true
   (count, lex) argmax and whose deltas fit on every shard commits; a
   partial commit replays the accepted merges onto the epoch-start rows
   the speculation found.

The chains are the JAX package's: the selects are exact (a select that
does not converge in its device rounds is finished on the host, and the
speculation run again exactly), and the estimate keeps the JAX float32
arithmetic. The speculative view is the table itself, its estimates taken
back out exactly before the exchange. An epoch reads the host once to
check its speculative selects, and once per validated step.
:func:`estimate_followup_2d` is also the kernel-sharded loop's
(``dist/hbm_sharded.py``).
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np
import torch

from yabpe_tpu_torch.dist.mesh import DataMesh
from yabpe_tpu_torch.kernels.merge_apply import apply_pair_merge
from yabpe_tpu_torch.train.bigvocab import lazy_select_rows, lazy_select_rows_async
from yabpe_tpu_torch.train.incremental import (
    _affected_slots,
    pack_merge_delta,
    write_rows,
)
from yabpe_tpu_torch.train.state import vocab_update
from yabpe_tpu_torch.utils.logging import get_logger

if TYPE_CHECKING:
    from yabpe_tpu_torch.dist.sharded import Shard2DState

_LOG = get_logger(__name__)


def estimate_followup(
    gview: torch.Tensor,
    rmv: torch.Tensor,
    left: torch.Tensor,
    right: torch.Tensor,
    cnt: torch.Tensor,
    new_sym: torch.Tensor,
    do: torch.Tensor,
    V: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The JAX package's 1-D estimate (``:48``): :func:`estimate_followup_2d`
    on the flat [V * V] view ``gview``, **in place**; returns the adjusted
    (view, row-max bound)."""
    estimate_followup_2d(gview.view(V, V), rmv, left, right, cnt, new_sym, do)
    return gview, rmv


def estimate_followup_2d(
    gview: torch.Tensor,
    rmv: torch.Tensor,
    left: torch.Tensor,
    right: torch.Tensor,
    cnt: torch.Tensor,
    new_sym: torch.Tensor,
    do: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Adjust a frozen [V, V] count view after a speculative merge, **in
    place**.

    A merge (a, b) -> c moves pair mass (x, a) -> (x, c) and (b, y) ->
    (c, y) for the occurrences that merged. The estimate takes the share of
    a's right pairings (and of b's left pairings) that were (a, b), in the
    JAX function's float32 arithmetic (``floor(col * (n_ab / denom))``,
    clipped), so that the speculative chains are the JAX package's. The
    (a, b) cell is zeroed. ``rmv`` [V], the view's row-max bound, is
    raised to stay a bound. Nothing moves where ``do`` is false.

    ``left``, ``right``, ``cnt``, ``new_sym`` are 0-d integer tensors,
    ``do`` a 0-d bool. No host sync. Returns ``(cells, deltas)``: the flat
    cell indices (int64, ``row * V + col``) and int32 amounts added to the
    view, so that a caller can take them back out exactly.
    """
    v = gview.shape[0]
    iota = torch.arange(v, device=gview.device)
    a = left.long().view(1)
    b = right.long().view(1)
    col_a = gview.index_select(1, a)[:, 0]
    row_a = gview.index_select(0, a)[0]
    col_b = gview.index_select(1, b)[:, 0]
    row_b = gview.index_select(0, b)[0]
    n_ab = cnt.clamp(min=0).to(torch.int32)
    one = torch.ones((), dtype=torch.int32, device=gview.device)
    denom_a = torch.maximum(torch.maximum(row_a.sum().to(torch.int32), n_ab), one)
    denom_b = torch.maximum(torch.maximum(col_b.sum().to(torch.int32), n_ab), one)
    frac_a = n_ab.float() / denom_a.float()
    frac_b = n_ab.float() / denom_b.float()
    est_col = torch.floor(col_a.float() * frac_a).to(torch.int32)
    est_row = torch.floor(row_b.float() * frac_b).to(torch.int32)
    est_col = torch.minimum(est_col.clamp(min=0), col_a)
    est_row = torch.minimum(est_row.clamp(min=0), row_b)
    zero = torch.zeros((), dtype=torch.int32, device=gview.device)
    est_col = torch.where(do, est_col, zero)
    est_row = torch.where(do, est_row, zero)
    c = new_sym.long().clamp(0, v - 1)
    cur_ab = col_b.index_select(0, a.clamp(max=v - 1))
    ab = a * v + b
    cells = torch.cat([
        iota * v + c,      # column c += est_col
        iota * v + a,      # column a -= est_col
        c * v + iota,      # row c    += est_row
        b * v + iota,      # row b    -= est_row
        torch.where(do, ab, torch.zeros_like(ab)),
    ])
    deltas = torch.cat([
        est_col, -est_col, est_row, -est_row,
        torch.where(do, -cur_ab, torch.zeros_like(cur_ab)),
    ])
    gview.view(-1).index_add_(0, cells, deltas)
    c1 = c.view(1)
    rmv.copy_(torch.maximum(rmv, gview.index_select(1, c1)[:, 0]))
    rmv.index_copy_(
        0, c1,
        torch.maximum(rmv.index_select(0, c1), gview.index_select(0, c1).amax(dim=1)),
    )
    return cells, deltas





def _speculate(
    state: Shard2DState, n: int, *, k: int, min_frequency: int, cap0: int, cap: int,
    exact: bool,
):
    """Speculation of an epoch over this process's shards: ``n`` (<= k)
    merges picked from the count table as it stands, applied to copies of
    the word shards. Returns (chain, words, payloads, slots, done): the
    chain's [n] (A, B, C) tensors; for each local shard its speculated
    words, its packed payload (ok flags | keys0 | w0 | keys_r | w_r, the
    JAX layout, zero past ``n``) and each step's affected slots; and
    whether every select converged (a 0-d tensor; always true with
    ``exact``). The table comes back exactly as it went in."""
    V = state.vocab_cap
    counts = state.slabs[0]
    view = counts.view(V, V)
    dtype = counts.dtype
    device = counts.device
    spec = state.vocab.speculative_copy()
    rmv = state.row_max[0].clone()
    true_t = torch.ones((), dtype=torch.bool, device=device)
    chain_ok = true_t
    done = true_t
    n_shards = len(state.words)
    words_s = [w.clone() for w in state.words]
    alive = [true_t] * n_shards
    okf = [[] for _ in range(n_shards)]
    keys = [[] for _ in range(n_shards)]
    slots_kept = [[] for _ in range(n_shards)]
    A, B, C = [], [], []
    added = []
    width = state.words[0].shape[1] - 1
    for j in range(k):
        capj = cap0 if j == 0 else cap
        if j >= n:  # past the merge budget: nothing speculated, zero delta
            zero = torch.zeros(2 * 2 * width * capj, dtype=torch.int64, device=device)
            for s in range(n_shards):
                okf[s].append(torch.zeros((), dtype=torch.int64, device=device))
                keys[s].append(zero)
            continue
        if exact:
            m, a, b, _ = lazy_select_rows(counts, rmv, spec.lex_rank, spec.lex_rank, V)
        else:
            m, a, b, ok = lazy_select_rows_async(counts, rmv, spec.lex_rank, spec.lex_rank, V)
            done = done & ok
        frozen_stop = (m < max(min_frequency, 1)) | (m <= 0)
        pre = chain_ok & ~frozen_stop
        new_sym = vocab_update(spec, a, b, pre, spec.stopped, 0)
        for s in range(n_shards):
            w = words_s[s]
            lw, rw = w[:, :-1], w[:, 1:]
            affected = ((lw == a) & (rw == b) & (lw >= 0)).any(dim=1) & pre & alive[s]
            overflow = affected.sum() > capj
            do_s = pre & alive[s] & ~overflow
            affected = affected & ~overflow
            slots = _affected_slots(affected, capj)
            kj, wj = pack_merge_delta(
                w, state.freqs[s], affected, a, b, new_sym, capj, V, dtype, slots=slots,
            )
            okf[s].append(do_s.long())
            keys[s].append(torch.cat([kj, wj.long()]))
            slots_kept[s].append(slots)
            alive[s] = do_s
        added.append(estimate_followup_2d(view, rmv, a, b, m, new_sym, pre))
        A.append(a)
        B.append(b)
        C.append(new_sym.to(torch.int32))
        chain_ok = pre
    if added:
        counts.index_add_(0, torch.cat([c for c, _ in added]), -torch.cat([d for _, d in added]))
    payloads = []
    for s in range(n_shards):
        # ok | keys0 | w0 | keys_r | w_r: each step's (keys | weights) halves
        halves = [t.view(2, -1) for t in keys[s]]
        payloads.append(torch.cat(
            [torch.stack(okf[s]), halves[0][0], halves[0][1]]
            + [h[0] for h in halves[1:]] + [h[1] for h in halves[1:]]
        ))
    chain = tuple(torch.stack(v) if v else torch.zeros(0, dtype=torch.int32, device=device)
                  for v in (A, B, C))
    return chain, words_s, payloads, slots_kept, done


def _spec_epoch(
    state: Shard2DState,
    mesh: DataMesh,
    ptr: int,
    *,
    k: int,
    min_frequency: int,
    num_merges: int,
    cap0: int,
    cap: int,
) -> tuple[int, bool]:
    """One speculate/exchange/validate epoch on ``state``, in place;
    returns (p, stopped): the merges committed, and whether validation
    found the stop."""
    V = state.vocab_cap
    W1 = state.words[0].shape[1] - 1
    L0 = 2 * W1 * cap0
    LR = 2 * W1 * cap
    n = min(k, num_merges - ptr)
    kw = dict(k=k, min_frequency=min_frequency, cap0=cap0, cap=cap)
    spec = _speculate(state, n, exact=False, **kw)
    state.stats["host_syncs"] += 1
    if not bool(spec[-1]):
        state.stats["select_finishes"] += 1
        spec = _speculate(state, n, exact=True, **kw)
    (A, B, C), words_s, payloads, slots_kept, _ = spec

    # ---- exchange: one gather
    gathered = mesh.all_gather(payloads)  # [S, T]
    g_ok = gathered[:, :k]
    g_keys0 = gathered[:, k : k + L0]
    g_w0 = gathered[:, k + L0 : k + 2 * L0]
    rest = gathered[:, k + 2 * L0 :]
    nsh = gathered.shape[0]
    g_keys_r = rest[:, : (k - 1) * LR].reshape(nsh, k - 1, LR)
    g_w_r = rest[:, (k - 1) * LR :].reshape(nsh, k - 1, LR)
    ok_all = g_ok.amin(dim=0) > 0

    # ---- validate: replicated, against the true table
    counts = state.slabs[0]
    rm = state.row_max[0]
    vocab = state.vocab
    p = stop = 0
    lex = vocab.lex_rank
    for j in range(n):
        cnt_t, a_t, b_t, done = lazy_select_rows_async(counts, rm, lex, lex, V)
        while True:
            true_stop = (cnt_t < max(min_frequency, 1)) | (cnt_t <= 0)
            match = ~true_stop & ok_all[j] & (a_t == A[j]) & (b_t == B[j])
            state.stats["host_syncs"] += 1
            converged, matched, stop = torch.stack([done, match, true_stop]).tolist()
            if converged:
                break
            state.stats["select_finishes"] += 1
            cnt_t, a_t, b_t, _ = lazy_select_rows(counts, rm, lex, lex, V)
            done = torch.ones_like(done)
        if stop:
            vocab.stopped = torch.ones_like(vocab.stopped)
            break
        if not matched:
            break
        vocab_update(vocab, a_t, b_t, match, vocab.stopped, ptr + j)
        if j == 0:
            gkeys, gw = g_keys0.reshape(-1), g_w0.reshape(-1)
        else:
            gkeys, gw = g_keys_r[:, j - 1].reshape(-1), g_w_r[:, j - 1].reshape(-1)
        live = gw != 0
        gkeys = torch.where(live, gkeys, 0)
        counts.index_add_(0, gkeys, gw.to(counts.dtype))
        vals = torch.where(live, counts.index_select(0, gkeys), -1)
        rm.scatter_reduce_(0, gkeys // V, vals, "amax")
        p += 1

    # ---- commit
    if p == n:
        state.words = words_s
    elif p > 0:
        # replay only the rows the speculation found, onto the epoch start
        for s, w in enumerate(state.words):
            n_rows = w.shape[0]
            for j in range(p):
                idx, valid = slots_kept[s][j]
                safe = idx.clamp(max=n_rows - 1).long()
                rows = w.index_select(0, safe)
                new_rows = apply_pair_merge(rows, A[j], B[j], C[j])
                write_rows(w, safe, valid, torch.where(valid[:, None], new_rows, rows))
    return p, bool(stop)


def sharded_chunk_speculative(
    state: Shard2DState,
    mesh: DataMesh,
    chunk_start: int,
    *,
    min_frequency: int,
    num_merges: int,
    chunk_size: int,
    spec_batch: int,
    cap0: int,
    cap: int,
) -> tuple[int, int]:
    """Run epochs until the chunk is covered or an epoch makes no progress.

    Returns (ptr, epochs): ``ptr`` below the chunk's end with the loop not
    stopped means an epoch committed nothing (merge 0's delta overflowed
    ``cap0`` on some shard), and the caller must take that merge through
    the per-step loop. ``epochs`` counts the exchanges spent.
    """
    end = min(chunk_start + chunk_size, num_merges)
    ptr, epochs, last_p, stopped = chunk_start, 0, 1, False
    while ptr < end and last_p > 0 and not stopped:
        last_p, stopped = _spec_epoch(
            state, mesh, ptr, k=spec_batch, min_frequency=min_frequency,
            num_merges=num_merges, cap0=cap0, cap=cap,
        )
        ptr += last_p
        epochs += 1
    return ptr, epochs


def run_speculative(
    state: Shard2DState,
    mesh: DataMesh,
    start_step: int,
    *,
    num_merges: int,
    min_frequency: int,
    chunk: int,
    spec_batch: int,
    affected_cap: int,
    on_chunk,
    stats_out: dict | None = None,
) -> np.ndarray:
    """Drive speculate/validate epochs (the JAX ``_run_speculative``); a
    chunk whose epoch made no progress (a cap0 overflow) goes through the
    per-step loop.

    k adapts to the commit rate between chunks, as in the JAX driver:
    under 30 % of the speculation accepted halves it while it is above 4,
    over 85 % doubles it up to max(spec_batch, 16). Any k schedule gives
    the same merges.
    """
    from yabpe_tpu_torch.dist.sharded import run_steps

    cap0 = affected_cap
    cap = min(256, cap0)
    k = max(2, min(spec_batch, num_merges))
    k_max = max(k, 16)
    total_epochs = total_spec_commits = fallbacks = 0
    start = start_step
    while start < num_merges:
        chunk_end = min(start + chunk, num_merges)
        ptr, epochs = sharded_chunk_speculative(
            state, mesh, start, min_frequency=min_frequency,
            num_merges=num_merges, chunk_size=chunk, spec_batch=k,
            cap0=cap0, cap=cap,
        )
        total_epochs += epochs
        total_spec_commits += ptr - start
        if epochs > 0:
            rate = (ptr - start) / (epochs * k)
            if rate < 0.3 and k > 4:
                k //= 2
            elif rate > 0.85 and k < k_max:
                k *= 2
        state.stats["host_syncs"] += 1
        if ptr < chunk_end and not bool(state.vocab.stopped):
            fallbacks += 1
            end = min(ptr + chunk, num_merges)
            run_steps(
                state, mesh, ptr, end, min_frequency=min_frequency,
                affected_cap=affected_cap,
            )
            ptr = end
        start = ptr
        if on_chunk is not None:
            on_chunk(state.vocab.merges.cpu().numpy(), min(start, num_merges))
        state.stats["host_syncs"] += 1
        if bool(state.vocab.stopped):
            break
    commits_per_epoch = total_spec_commits / max(total_epochs, 1)
    _LOG.info(
        "speculative loop: %d merges in %d epochs (%.2f commits/epoch), "
        "%d fallback chunks, final k=%d",
        total_spec_commits, total_epochs, commits_per_epoch, fallbacks, k,
    )
    if stats_out is not None:
        stats_out.update(
            spec_epochs=total_epochs,
            spec_commits=total_spec_commits,
            commits_per_epoch=commits_per_epoch,
            fallback_chunks=fallbacks,
            final_k=k,
        )
    return state.vocab.merges.cpu().numpy()


__all__ = [
    "estimate_followup",
    "estimate_followup_2d",
    "run_speculative",
    "sharded_chunk_speculative",
]
