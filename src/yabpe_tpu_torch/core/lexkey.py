"""Lexicographic ordering of variable-length byte strings, on tensors.

Counterpart of yabpe_tpu/core/lexkey.py. The reference breaks pair-count
ties by the lexicographically *greatest* pair of token byte strings,
compared as a tuple: left token first, then right. The trainer keeps, for
every live token id, its dense **lexicographic rank** among all live
tokens, so the tie-break becomes an integer argmax over
``(count, lex_rank[left], lex_rank[right])``.

Token byte strings are an int32 matrix padded with -1; since -1 < any byte
value, padded fixed-width comparison reproduces the shorter-string-is-prefix
rule ("ab" < "abc") for free.

The numpy helpers build the initial state on the host; the torch functions
are the plain versions that the merge kernels' twins and the sharded
loop's vocabulary update use on any device, without a host sync.

K2 (csrc/hbm_loop.cu) also keeps a 64-bit **prefix key** per token
(:func:`prefix_keys`), so that its dedup compare orders most tokens
against the merged string by one integer compare.
"""

from __future__ import annotations

import numpy as np
import torch

BYTE_PAD: int = -1

#: Bytes of a token that its prefix key holds (csrc/hbm_loop.cu's kKeyBytes).
KEY_BYTES: int = 7


def initial_token_matrix(
    token_bytes_list: list[bytes], vocab_cap: int, byte_width: int
) -> tuple[np.ndarray, np.ndarray]:
    """Pack token byte strings into the device matrix layout.

    Returns (token_bytes [vocab_cap, byte_width] int32 padded with -1,
    token_len [vocab_cap] int32).
    """
    mat = np.full((vocab_cap, byte_width), BYTE_PAD, dtype=np.int32)
    lens = np.zeros((vocab_cap,), dtype=np.int32)
    for i, tb in enumerate(token_bytes_list):
        if len(tb) > byte_width:
            raise ValueError(
                f"token of {len(tb)} bytes exceeds byte_width={byte_width}"
            )
        arr = np.frombuffer(tb, dtype=np.uint8)
        mat[i, : len(arr)] = arr
        lens[i] = len(arr)
    return mat, lens


def initial_lex_ranks(token_bytes_list: list[bytes], vocab_cap: int) -> np.ndarray:
    """Dense lex rank of each initial token among all of them.

    Inactive slots (>= len(token_bytes_list)) are filled with -1.
    """
    order = sorted(range(len(token_bytes_list)), key=lambda i: token_bytes_list[i])
    ranks = np.full((vocab_cap,), -1, dtype=np.int32)
    for rank, idx in enumerate(order):
        ranks[idx] = rank
    return ranks


def rows_vs_query(
    token_bytes: torch.Tensor, query: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Compare every row of ``token_bytes`` [V, L] against one string [L].

    Returns (less, equal): bool [V] each, row < query and row == query under
    lexicographic byte-string order.
    """
    diff = token_bytes != query[None, :]
    any_diff = diff.any(dim=1)
    first = diff.int().argmax(dim=1)  # first differing position
    row_val = token_bytes.gather(1, first[:, None])[:, 0]
    less = any_diff & (row_val < query[first])
    return less, ~any_diff


def prefix_keys(rows: torch.Tensor) -> torch.Tensor:
    """The prefix key of each token row of ``rows`` [..., L] (int32 bytes,
    -1 padded): its first KEY_BYTES bytes big-endian in 9 bits each, byte
    + 1 or 0 past the token's end, then in the lowest bit whether the
    token is longer than KEY_BYTES bytes. A row of padding keys 0.

    As unsigned 64-bit integers, two keys that differ order as their
    tokens' byte strings do (a prefix first), and equal keys are equal
    strings unless both tokens are longer than KEY_BYTES bytes. Returns
    int64 [...] holding those bits, so a key whose first byte is 0xFF
    reads as negative. Takes a numpy array's rows through
    ``torch.from_numpy``.
    """
    head = rows[..., :KEY_BYTES].long() + 1
    key = torch.zeros(rows.shape[:-1], dtype=torch.int64, device=rows.device)
    for i in range(head.shape[-1]):
        key |= head[..., i] << (64 - 9 * (i + 1))
    if rows.shape[-1] > KEY_BYTES:
        key |= (rows[..., KEY_BYTES] != BYTE_PAD).long()
    return key


def concat_token_bytes(
    token_bytes: torch.Tensor,
    token_len: torch.Tensor,
    left: int | torch.Tensor,
    right: int | torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Concatenate the byte strings of token ids ``left`` and ``right``
    (ints or 0-d integer tensors).

    Returns (merged [L] int32 padded with -1, merged length as a 0-d
    tensor). Gathers only, so a device caller never waits on the host. The
    caller guarantees the concatenation fits in L (a merged token is a
    substring of a pre-token, whose byte length bounds the table width).
    """
    width = token_bytes.shape[1]
    if isinstance(left, torch.Tensor):
        pick = torch.stack([left.long(), right.long()])
    else:
        pick = torch.tensor([left, right], device=token_bytes.device)
    rows = token_bytes.index_select(0, pick)
    la, lb = token_len.index_select(0, pick).unbind()
    d = torch.arange(width, device=token_bytes.device)
    from_right = rows[1].gather(0, (d - la).clamp(0, width - 1))
    merged = torch.where(
        d < la, rows[0], torch.where(d < la + lb, from_right, BYTE_PAD)
    )
    return merged, la + lb


def insert_lex_rank(
    lex_rank: torch.Tensor,
    active_mask: torch.Tensor,
    less: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Insertion rank of a new string and the shifted existing ranks.

    Args:
        lex_rank: int32 [V]; dense ranks of active tokens (-1 inactive).
        active_mask: bool [V]; which slots hold live tokens.
        less: bool [V]; rows strictly below the new string.

    Returns:
        (new_ranks, insert_rank): ranks with every active rank >= insert_rank
        bumped by one; the new string's rank, a 0-d tensor.
    """
    insert_rank = (less & active_mask).sum().to(lex_rank.dtype)
    bumped = torch.where(
        active_mask & (lex_rank >= insert_rank), lex_rank + 1, lex_rank
    )
    return bumped, insert_rank


__all__ = [
    "BYTE_PAD",
    "initial_token_matrix",
    "initial_lex_ranks",
    "KEY_BYTES",
    "prefix_keys",
    "rows_vs_query",
    "concat_token_bytes",
    "insert_lex_rank",
]
