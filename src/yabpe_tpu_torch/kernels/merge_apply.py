"""Masked leftmost merge application and row compaction over padded words.

Counterpart of yabpe_tpu/kernels/merge_apply.py, in torch ops on any
device and for any word width: within each word, occurrences of a pair
are replaced left to right without overlap ("aaa" with the pair (a, a)
merges positions 0-1, not 1-2), then the row is compacted. The
leftmost-non-overlapping rule is a run-parity computation through an
exclusive running max, and compaction one stable sort along the row.

The JAX module compacts narrow rows with an O(W^2) one-hot reduction and
wide ones with a sort, a choice of speed on the TPU; both give the same
rows, so this one sorts at every width.

These are XLA code in the JAX package, not a Pallas kernel: the
fallback engines (train/incremental.py, train/bigvocab.py), the
checkpoint replay (train/checkpoint.py) and the device encoder's scan
(tok/device_encode.py) run them on the caller's device.
"""

from __future__ import annotations

import torch

from yabpe_tpu_torch.core.wordtable import PAD


def leftmost_nonoverlapping(match: torch.Tensor) -> torch.Tensor:
    """The leftmost non-overlapping True positions of each row.

    Given match[i, j] = "a pair occurrence starts at column j", returns
    applied[i, j] = match[i, j] and not applied[i, j - 1]. Overlap is only
    possible inside runs of consecutive matches, where the applied
    positions are the even offsets within each run.
    """
    n, w = match.shape
    iota = torch.arange(w, device=match.device).expand(n, w)
    # Last non-match column at or before j; -1 if none.
    last_false_incl = torch.where(match, -1, iota).cummax(dim=1).values
    # Exclusive version: last non-match column strictly before j.
    prev_false = torch.cat(
        [torch.full((n, 1), -1, device=match.device), last_false_incl[:, :-1]],
        dim=1,
    )
    run_offset = iota - (prev_false + 1)
    return match & (run_offset % 2 == 0)


def compact_rows(values: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """Stably move the kept entries of each row to its front; PAD the tail."""
    n, w = values.shape
    iota = torch.arange(w, device=values.device).expand(n, w)
    order = torch.where(keep, iota, w + iota).argsort(dim=1)
    sorted_vals = values.gather(1, order)
    new_len = keep.sum(dim=1, keepdim=True)
    return torch.where(iota < new_len, sorted_vals, PAD).to(values.dtype)


def apply_pair_merge(
    words: torch.Tensor,
    left_sym: int | torch.Tensor,
    right_sym: int | torch.Tensor,
    new_sym: int | torch.Tensor,
) -> torch.Tensor:
    """Merge every leftmost non-overlapping (left_sym, right_sym) occurrence.

    Args:
        words: int32 [N, W], -1 padded.
        left_sym/right_sym/new_sym: ints or 0-d tensors on the words'
            device (no host sync either way).

    Returns:
        The updated words, compacted, same shape; ``words`` is not changed.
    """
    left = words[:, :-1]
    right = words[:, 1:]
    match = (left == left_sym) & (right == right_sym) & (left >= 0)
    applied = leftmost_nonoverlapping(match)

    false_col = torch.zeros((words.shape[0], 1), dtype=torch.bool, device=words.device)
    applied_at = torch.cat([applied, false_col], dim=1)  # merge starts
    removed_at = torch.cat([false_col, applied], dim=1)  # right halves

    new = torch.as_tensor(new_sym, dtype=words.dtype, device=words.device)
    vals = torch.where(applied_at, new, words)
    keep = ~removed_at & (words >= 0)
    return compact_rows(vals, keep)


def apply_rowwise_merge(
    words: torch.Tensor, applied: torch.Tensor, new_syms: torch.Tensor
) -> torch.Tensor:
    """The encoder's apply: precomputed merges, a symbol per position.

    Args:
        words: int32 [N, W], -1 padded.
        applied: bool [N, W - 1]; non-overlapping merge starts of each row.
        new_syms: int32 [N, W - 1]; the replacement symbol of each applied
            position (read nowhere else).

    Returns:
        The updated words, compacted, same shape; ``words`` is not changed.
    """
    false_col = torch.zeros((words.shape[0], 1), dtype=torch.bool, device=words.device)
    applied_at = torch.cat([applied, false_col], dim=1)  # merge starts
    removed_at = torch.cat([false_col, applied], dim=1)  # right halves
    new_full = torch.cat([new_syms.to(words.dtype), torch.full_like(words[:, :1], PAD)], dim=1)
    vals = torch.where(applied_at, new_full, words)
    keep = ~removed_at & (words >= 0)
    return compact_rows(vals, keep)


__all__ = [
    "apply_pair_merge",
    "apply_rowwise_merge",
    "compact_rows",
    "leftmost_nonoverlapping",
]
