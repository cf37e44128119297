"""Best-pair selection: count argmax with exact lexicographic tie-breaking.

Counterpart of yabpe_tpu/kernels/select.py, in torch ops on any device:
the highest count wins, ties go to the lexicographically greatest
(left bytes, right bytes) tuple, which the dense lex-rank table
(core/lexkey.py) turns into two integer argmaxes: the greatest
lex_rank[left] over rows that hold a max-count pair, then the greatest
lex_rank[right] within that row. Lex ranks are unique among live tokens,
so both argmaxes are unambiguous.
"""

from __future__ import annotations

import torch


def select_best_pair(
    counts_flat: torch.Tensor,
    lex_rank: torch.Tensor,
    vocab_cap: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The (left, right) pair with (max count, max lex tuple).

    Args:
        counts_flat: [V * V] pair counts.
        lex_rank: int32 [V]; dense lex ranks of live tokens, -1 inactive.
        vocab_cap: V.

    Returns:
        (left, right, count): 0-d tensors, no host sync. When the table is
        all zero, count is 0 and the ids mean nothing: callers gate on the
        count.
    """
    counts = counts_flat.view(vocab_cap, vocab_cap)
    best_count = counts.max()
    cand = counts == best_count
    row_has = cand.any(dim=1)
    left = torch.where(row_has, lex_rank, -1).argmax()
    right = torch.where(cand.index_select(0, left.view(1))[0], lex_rank, -1).argmax()
    return left.int(), right.int(), best_count


__all__ = ["select_best_pair"]
