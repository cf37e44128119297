"""Merge-record conversion (counterpart of yabpe_tpu/train/state.py:280)."""

from __future__ import annotations

import numpy as np

from yabpe_tpu_torch.core.vocab import Vocab


def merges_to_bytes(
    merges_ids: np.ndarray, base_vocab: Vocab
) -> tuple[Vocab, list[tuple[bytes, bytes]]]:
    """Convert the device merge record back to byte-string merges + vocab.

    Replays id-space merges on the host, growing a copy of the base vocab
    exactly as the device did (dedup included). Rows with a negative left
    id (steps never taken) end the record.
    """
    vocab = Vocab()
    for tok in base_vocab.tokens():
        vocab.add(tok)
    merges: list[tuple[bytes, bytes]] = []
    for left, right, new_sym in merges_ids:
        if left < 0:
            break
        lb = vocab.bytes_of(int(left))
        rb = vocab.bytes_of(int(right))
        got = vocab.add(lb + rb)
        if got != int(new_sym):
            raise AssertionError(
                f"host/device vocab divergence: merge {lb!r}+{rb!r} -> id {got} "
                f"on host but {int(new_sym)} on device"
            )
        merges.append((lb, rb))
    return vocab, merges


__all__ = ["merges_to_bytes"]
