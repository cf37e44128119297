"""Exact pair selection over a [V, V] count table through a row-max bound.

Counterpart of yabpe_tpu/train/bigvocab.py, in part: only
:func:`lazy_select_2d` (``:109``), which the data-sharded merge loop
(``dist/hbm_sharded.py``) selects with. The rest of that module, the
single-device large-vocabulary loop past the merge kernels' limits, waits
for ROADMAP.md queue 1 item 4.

``row_max`` is an upper bound on each row's max count: increases are
folded in eagerly by the callers, decreases leave it stale. The JAX
function repairs a stale top with a ``while_loop``: re-scan the
lex-greatest row whose bound is the global bound max, tighten it, and
retry until the re-scanned row's max equals its bound. On a GPU each
round of such a loop would cost a host round trip to decide whether to go
on, so this version runs a fixed number of rounds, each of which
re-scans ``width`` rows at once, and returns whether the result is exact
as a device flag for the caller to check later. A round's rows are the
greatest (bound, lex rank) key of each of ``width`` stripes of rows (row r
in stripe r % width): one reduction, where a global top-``width``
(``torch.topk``) is a multi-pass radix select of several launches on the
card.
"""

from __future__ import annotations

import torch

#: Verify rounds and rows re-scanned per round of :func:`lazy_select_2d`.
VERIFY_ROUNDS = 2
VERIFY_WIDTH = 32


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
    # (bound, lex rank) as one int64 key; lex + 1 < 2^16 (vocab <= 63,488).
    lex1 = lex_rank.long() + 1
    top = min(width, v)
    pad = -v % top
    stripe = torch.arange(top, device=counts.device)
    for _ in range(rounds):
        key = torch.add(lex1, row_max, alpha=65536)
        if pad:
            key = torch.nn.functional.pad(key, (0, pad), value=-1)
        best = key.view(-1, top).argmax(dim=0)
        rows = (best * top + stripe).clamp(max=v - 1)
        row_max.index_copy_(0, rows, counts.index_select(0, rows).amax(dim=1))
    a = torch.add(lex1, row_max, alpha=65536).argmax()
    m = row_max.index_select(0, a.view(1))[0]
    row = counts.index_select(0, a.view(1))[0]
    exact = row.max() == m
    b = torch.where(row == m, lex_rank, -1).argmax()
    return a, b, m, exact


__all__ = ["VERIFY_ROUNDS", "VERIFY_WIDTH", "lazy_select_2d"]
