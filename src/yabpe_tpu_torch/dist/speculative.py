"""Follow-up estimation for speculative merge chains.

Counterpart of yabpe_tpu/dist/speculative.py, in part: only
:func:`estimate_followup_2d` (``:121``), which the data-sharded merge loop
(``dist/hbm_sharded.py``) builds its speculative chains with. The XLA
speculative loop of that module (``_spec_epoch``,
``sharded_chunk_speculative``) waits for ROADMAP.md queue 1 item 6.
"""

from __future__ import annotations

import torch


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


__all__ = ["estimate_followup_2d"]
