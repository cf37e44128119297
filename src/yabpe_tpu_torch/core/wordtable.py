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


def _byte_order(keys: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """The permutation that sorts words as Python sorts their ``bytes``.

    ``keys`` [n, cols] are each word's zero-padded bytes as big-endian
    8-byte integers. Sorts by the first column, then re-sorts only the runs
    still tied by each later column and finally by length, so a table with
    few long words costs about one column's sort. Raises ValueError when two
    words are equal.
    """
    n = lens.size
    first = keys[:, 0].astype(np.uint64)
    order = np.argsort(first)
    first = first[order]
    tied = first[1:] == first[:-1]  # tied[i]: sorted rows i and i + 1 equal so far
    for c in range(1, keys.shape[1] + 1):
        if not tied.any():
            return order
        # the rows of every run that is still tied, and their run's id
        pos = np.zeros(n, dtype=bool)
        pos[1:] |= tied
        pos[:-1] |= tied
        pos = np.flatnonzero(pos)
        run = np.concatenate(([0], np.cumsum(~tied)))[pos]
        rows = order[pos]
        key = keys[rows, c].astype(np.uint64) if c < keys.shape[1] else lens[rows]
        sub = np.lexsort((key, run))
        order[pos] = rows[sub]
        key = key[sub]
        tied = np.zeros(n - 1, dtype=bool)
        tied[pos[:-1][(run[1:] == run[:-1]) & (key[1:] == key[:-1])]] = True
    if tied.any():
        row = order[np.flatnonzero(tied)[0]]
        raise ValueError(f"word {keys[row].tobytes()[: lens[row]]!r} given twice")
    return order


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
        """Build a table from {pre-token bytes: count}: :meth:`from_raw`
        over the keys joined into one blob."""
        keys = list(counts)
        lens = np.fromiter(map(len, keys), dtype=np.int64, count=len(keys))
        freqs = np.fromiter(counts.values(), dtype=np.int64, count=len(keys))
        return cls.from_raw(
            b"".join(keys), lens, freqs, width=width, width_multiple=width_multiple
        )

    @classmethod
    def from_raw(
        cls,
        blob: bytes,
        lens: np.ndarray,
        counts: np.ndarray,
        *,
        width: int | None = None,
        width_multiple: int = 16,
    ) -> "WordTable":
        """Build a table from a raw word export: the words' bytes
        concatenated, their lengths and their counts, each word once (as
        pretok.ingest.count_pretokens_raw returns them).

        Words with a count <= 0 or no bytes are dropped. Rows are sorted by
        byte string, as Python orders ``bytes``, for a canonical,
        input-order-free layout (counts are commutative, so any order
        yields identical training results; sorting makes the array
        bit-deterministic). Row counts are bucketed to powers of two so
        differently-sized corpora reuse compiled programs. A word given
        twice raises ValueError.
        """
        data = np.frombuffer(blob, dtype=np.uint8)
        lens = np.asarray(lens, dtype=np.int64)
        counts = np.asarray(counts, dtype=np.int64)
        if int(lens.sum()) != data.size:
            raise ValueError(
                f"the lengths sum to {int(lens.sum())} bytes, the blob holds {data.size}"
            )
        keep = (counts > 0) & (lens > 0)
        if not keep.all():
            data = data[np.repeat(keep, lens)]
            lens, counts = lens[keep], counts[keep]
        n = lens.size
        max_len = int(lens.max()) if n else 1
        if width is None:
            width = _round_up(max(max_len, 2), width_multiple)
        elif width < max_len:
            raise ValueError(
                f"width={width} is smaller than longest pre-token ({max_len})"
            )
        # Bucket row counts: powers of two while small (compile reuse),
        # multiples of 1024 beyond that (bounded padding waste).
        if n <= 2048:
            num_rows = 64
            while num_rows < n:
                num_rows *= 2
        else:
            num_rows = _round_up(n, 1024)

        # each byte's word and its place in the word
        word_of = np.repeat(np.arange(n), lens)
        at = np.arange(data.size) - np.repeat(np.cumsum(lens) - lens, lens)
        # zero-padded 8-byte key columns, read as big-endian integers:
        # zero padding ties b"a" with b"a\0", which the length then orders
        cols = _round_up(max_len, 8) // 8
        padded = np.zeros((n, cols * 8), dtype=np.uint8)
        padded.reshape(-1)[word_of * (cols * 8) + at] = data
        order = _byte_order(padded.view(">u8"), lens)

        rank = np.empty(n, dtype=np.int64)
        rank[order] = np.arange(n)
        words = np.full((num_rows, width), PAD, dtype=np.int32)
        words.reshape(-1)[rank[word_of] * width + at] = data
        freqs = np.zeros((num_rows,), dtype=np.int64)
        freqs[:n] = counts[order]
        return cls(words=words, freqs=freqs, num_words=n, max_len=max_len)

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
