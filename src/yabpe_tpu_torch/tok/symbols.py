"""Extended-symbol tables of the native encoder.

A copy of yabpe_tpu/tok/symbols.py (the JAX package shares it with its
device encoder).

The per-word BPE loop works in an "extended symbol" space: ids 0..255 are
the single bytes, and each *reachable* merge product gets one id. A merge
(left_bytes, right_bytes) is "live" when both inputs are themselves
formable; the live table maps (left_sym, right_sym) -> (rank, product_sym)
with duplicate pairs keeping the last rank, matching the reference's
merge-rank dict construction (the reference library's
tokenizer.py:74-76).
"""

from __future__ import annotations

import numpy as np


def extended_symbol_tables(
    vocab: dict[bytes, int],
    merges: list[tuple[bytes, bytes]],
    unk_id: int,
) -> tuple[list[bytes], dict[tuple[int, int], tuple[int, int]], np.ndarray]:
    """Build (sym_bytes, live_pairs, out_ids) for an encoder.

    Returns:
        sym_bytes: extended symbol id -> byte string.
        live: (left_sym, right_sym) -> (rank, product_sym).
        out_ids: int32 [n_syms]; vocab id per symbol (unk_id when absent).
    """
    sym_of: dict[bytes, int] = {bytes([b]): b for b in range(256)}
    sym_bytes: list[bytes] = [bytes([b]) for b in range(256)]
    live: dict[tuple[int, int], tuple[int, int]] = {}
    for rank, (lb, rb) in enumerate(merges):
        left = sym_of.get(lb)
        right = sym_of.get(rb)
        if left is None or right is None:
            continue  # unreachable merge: its inputs can never be formed
        tok = lb + rb
        sym = sym_of.get(tok)
        if sym is None:
            sym = len(sym_bytes)
            sym_of[tok] = sym
            sym_bytes.append(tok)
        live[(left, right)] = (rank, sym)

    out_ids = np.array(
        [vocab.get(sb, unk_id) for sb in sym_bytes], dtype=np.int32
    )
    return sym_bytes, live, out_ids


__all__ = ["extended_symbol_tables"]
