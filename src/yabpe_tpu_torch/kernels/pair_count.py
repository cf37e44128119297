"""Adjacent-pair counts of a padded word table, as a dense [V * V] table.

Counterpart of yabpe_tpu/kernels/pair_count.py, in torch ops on any
device: one ``index_add_`` of the word frequencies into a flat table.

The JAX module's second strategy, ``pair_counts_matmul``, is the TPU's
MXU layout of the same counts (one-hot operands in a matrix product,
exact below 2^24 per count). Here every strategy is this scatter, which
gives the same table; ``train/state.py::count_pairs`` accepts the
strategy names and their exactness rule.
"""

from __future__ import annotations

import torch


def adjacent_pairs(
    words: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(left, right, valid) views of the adjacent symbol pairs.

    words: int32 [N, W], -1 padded. Overlapping occurrences all count:
    "aaa" contributes (a, a) twice.
    """
    left = words[:, :-1]
    right = words[:, 1:]
    valid = (left >= 0) & (right >= 0)
    return left, right, valid


def pair_counts_dense(
    words: torch.Tensor,
    freqs: torch.Tensor,
    vocab_cap: int,
    dtype: torch.dtype = torch.int32,
) -> torch.Tensor:
    """Exact dense pair-count table.

    Args:
        words: int32 [N, W], -1 padded symbol rows.
        freqs: [N] occurrence counts (0 for padding rows).
        vocab_cap: symbol-id capacity V; the table is [V * V], flat.
        dtype: int32, exact while the corpus's total pair mass stays
            below 2^31 (``train/state.py::count_dtype``), or int64.

    Returns:
        [V * V] of ``dtype``: counts[a * V + b] = the sum of the
        frequencies over adjacent (a, b).
    """
    left, right, valid = adjacent_pairs(words)
    # Invalid positions add 0 to cell 0.
    key = torch.where(valid, left.long() * vocab_cap + right, 0)
    weight = torch.where(valid, freqs[:, None].to(dtype), 0)
    counts = torch.zeros(vocab_cap * vocab_cap, dtype=dtype, device=words.device)
    return counts.index_add_(0, key.reshape(-1), weight.reshape(-1))


__all__ = ["adjacent_pairs", "pair_counts_dense"]
