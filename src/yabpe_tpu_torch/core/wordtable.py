"""Fixed-width padded word-frequency tables.

The device-resident representation of a corpus for training: each unique
pre-token is one row of int32 symbol ids, padded with ``PAD`` (-1) to a
common width, alongside its occurrence count. This replaces the reference's
``dict[tuple[bytes, ...], int]`` (its trainer.py:221-225) with an array
layout a device kernel can scan.

A key invariant that makes fixed shapes possible: applying BPE merges never
changes a word's underlying byte string, so distinct rows stay distinct and
row count / frequencies are constant over the whole merge loop — only the
symbol contents and active lengths change.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass

import numpy as np

PAD: int = -1


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass
class WordTable:
    """Padded unique-word table.

    Attributes:
        words: int32 [num_rows, width]; symbol ids, PAD-filled past each
            word's length and in padding rows.
        freqs: int64 [num_rows]; occurrence counts, 0 in padding rows.
        num_words: number of real (non-padding) rows.
        max_len: length in symbols of the longest real word.
    """

    words: np.ndarray
    freqs: np.ndarray
    num_words: int
    max_len: int

    @classmethod
    def from_counter(
        cls,
        counts: Counter[bytes] | dict[bytes, int],
        *,
        width: int | None = None,
        width_multiple: int = 16,
    ) -> "WordTable":
        """Build a table from {pre-token bytes: count}.

        Rows are sorted by byte string for a canonical, input-order-free
        layout (counts are commutative, so any order yields identical
        training results; sorting makes the array bit-deterministic). Row
        counts are bucketed to powers of two so differently-sized corpora
        reuse compiled programs.
        """
        items = sorted((w, c) for w, c in counts.items() if c > 0 and len(w) > 0)
        max_len = max((len(w) for w, _ in items), default=1)
        if width is None:
            width = _round_up(max(max_len, 2), width_multiple)
        elif width < max_len:
            raise ValueError(
                f"width={width} is smaller than longest pre-token ({max_len})"
            )
        # Bucket row counts: powers of two while small (compile reuse),
        # multiples of 1024 beyond that (bounded padding waste).
        if len(items) <= 2048:
            num_rows = 64
            while num_rows < len(items):
                num_rows *= 2
        else:
            num_rows = _round_up(len(items), 1024)

        words = np.full((num_rows, width), PAD, dtype=np.int32)
        freqs = np.zeros((num_rows,), dtype=np.int64)
        for i, (w, c) in enumerate(items):
            arr = np.frombuffer(w, dtype=np.uint8)
            words[i, : len(arr)] = arr
            freqs[i] = c
        return cls(words=words, freqs=freqs, num_words=len(items), max_len=max_len)

    def pad_rows_to(self, num_rows: int) -> "WordTable":
        """Return a copy padded to ``num_rows`` rows (for sharding)."""
        if num_rows < self.words.shape[0]:
            raise ValueError("cannot shrink a WordTable")
        if num_rows == self.words.shape[0]:
            return self
        words = np.full((num_rows, self.words.shape[1]), PAD, dtype=np.int32)
        words[: self.words.shape[0]] = self.words
        freqs = np.zeros((num_rows,), dtype=np.int64)
        freqs[: self.freqs.shape[0]] = self.freqs
        return WordTable(words, freqs, self.num_words, self.max_len)

    @property
    def width(self) -> int:
        return int(self.words.shape[1])

    @property
    def total_bytes(self) -> int:
        """Total corpus bytes represented (sum of len * freq)."""
        lengths = (self.words >= 0).sum(axis=1)
        return int((lengths * self.freqs).sum())


__all__ = ["WordTable", "PAD"]
