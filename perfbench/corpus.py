"""Seeded synthetic corpora for the benchmark, generated with NumPy.

The shape is that of a plain-English-like corpus over a synthetic lexicon:
lexicon words of 1-4 syllables (consonant, vowel, then a consonant with
probability 0.3), drawn by a Zipf law over the lexicon's rank (ranked by
length where the configuration gives ``word_letters``); sentences of
5-17 words, the first capitalised, closed by one of ``.,!?;``; after a
sentence ``"\\n<|endoftext|>\\n"`` (12 %), a space (70 %) or a newline
(18 %). Every draw comes from ``--seed``: one seed gives the same bytes on
any machine, whatever the number of worker threads.

A corpus is ``files`` files of about ``bytes / files`` bytes each. Each
file is made of segments of whole sentences of about ``SEGMENT_BYTES``;
segment ``s`` of file ``f`` draws from its own generator keyed on
``(seed, f, s)``, so segments are made on parallel threads and written in
order.

    python perfbench/corpus.py OUT_DIR SEED BYTES FILES LEXICON
"""

from __future__ import annotations

import os
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

CONSONANTS = np.frombuffer(b"bcdfghjklmnpqrstvwxz", dtype=np.uint8)
VOWELS = np.frombuffer(b"aeiouy", dtype=np.uint8)
PUNCT = [b".", b",", b"!", b"?", b";"]
SEGMENT_BYTES = 4 << 20
SENTENCES_PER_BATCH = 16384

ZIPF_EXPONENT = 1.0
SENTENCE_WORDS = (5, 17)
SEPARATORS = ((b"\n<|endoftext|>\n", 0.12), (b" ", 0.70), (b"\n", 0.18))

_LEXICON_TAG = 0x1E71C0
_SEGMENT_TAG = 0x5E6


def _seed_words(seed: int) -> list[int]:
    seed %= 1 << 64
    return [seed & 0xFFFFFFFF, seed >> 32]


def make_lexicon(n: int, seed: int, word_letters=None) -> list[bytes]:
    """``n`` distinct lowercase words, in the order first drawn.

    With ``word_letters``, the share of word tokens that have 1, 2, ...
    letters, the words are taken from four times as many and ranked so that
    under the Zipf law the word tokens have those shares: rank ``r`` takes
    the length at which the shares' running sum passes the Zipf mass of
    the ranks before ``r`` and half of its own (or the nearest length that
    has words left). Frequent words come out short, as in real text.
    """
    pool = _draw_words(n if word_letters is None else 4 * n, seed)
    if word_letters is None:
        return pool
    by_len: dict[int, list[bytes]] = {}
    for word in reversed(pool):
        by_len.setdefault(len(word), []).append(word)
    running = np.cumsum(word_letters) / np.sum(word_letters)
    mass = zipf_weights(n)
    mid = np.cumsum(mass) - mass / 2
    lengths = np.minimum(np.searchsorted(running, mid), len(word_letters) - 1) + 1
    out: list[bytes] = []
    for k in lengths.tolist():
        near = min((k2 for k2, ws in by_len.items() if ws), key=lambda k2: (abs(k2 - k), k2))
        out.append(by_len[near].pop())
    return out


def _draw_words(n: int, seed: int) -> list[bytes]:
    rng = np.random.default_rng(_seed_words(seed) + [_LEXICON_TAG])
    out: list[bytes] = []
    seen: set[bytes] = set()
    while len(out) < n:
        m = 2 * (n - len(out)) + 1024
        syllables = rng.integers(1, 5, size=m)
        cells = np.zeros((m, 4, 3), dtype=np.uint8)
        cells[:, :, 0] = CONSONANTS[rng.integers(0, len(CONSONANTS), size=(m, 4))]
        cells[:, :, 1] = VOWELS[rng.integers(0, len(VOWELS), size=(m, 4))]
        tail = CONSONANTS[rng.integers(0, len(CONSONANTS), size=(m, 4))]
        cells[:, :, 2] = np.where(rng.random((m, 4)) < 0.3, tail, 0)
        cells[np.arange(4)[None, :] >= syllables[:, None]] = 0
        for row in cells.reshape(m, 12):
            word = row.tobytes().replace(b"\0", b"")
            if word not in seen:
                seen.add(word)
                out.append(word)
                if len(out) == n:
                    break
    return out


def zipf_weights(n: int) -> np.ndarray:
    """The Zipf law's probability of each rank 1..n."""
    weights = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** ZIPF_EXPONENT
    return weights / weights.sum()


class PieceTable:
    """The byte pieces a corpus is concatenated from: each lexicon word
    bare, after a space and capitalised, then the punctuation, then the
    separators; with the Zipf law's cumulative distribution."""

    def __init__(self, lexicon: list[bytes]) -> None:
        n = len(lexicon)
        seps = [s for s, _ in SEPARATORS]
        pieces = (
            lexicon
            + [b" " + w for w in lexicon]
            + [w[:1].upper() + w[1:] for w in lexicon]
            + PUNCT
            + seps
        )
        self.n = n
        self.lens = np.array([len(p) for p in pieces], dtype=np.int64)
        self.starts = np.concatenate([[0], np.cumsum(self.lens)[:-1]])
        self.flat = np.frombuffer(b"".join(pieces), dtype=np.uint8)
        self.cum = np.cumsum(zipf_weights(n))
        self.sep_cum = np.cumsum([p for _, p in SEPARATORS])
        self.sep_cum /= self.sep_cum[-1]


def _segment(table: PieceTable, seed: int, f: int, s: int, target: int) -> bytes:
    """Whole sentences, at least ``target`` bytes of them."""
    rng = np.random.default_rng(_seed_words(seed) + [_SEGMENT_TAG, f, s])
    n = table.n
    parts: list[bytes] = []
    size = 0
    while size < target:
        S = SENTENCES_PER_BATCH
        nw = rng.integers(SENTENCE_WORDS[0], SENTENCE_WORDS[1] + 1, size=S)
        total = int(nw.sum())
        word = np.minimum(np.searchsorted(table.cum, rng.random(total)), n - 1)
        punct = rng.integers(0, len(PUNCT), size=S)
        sep = np.searchsorted(table.sep_cum, rng.random(S), side="right")
        per = nw + 2
        first = np.concatenate([[0], np.cumsum(per)[:-1]])
        word_first = np.concatenate([[0], np.cumsum(nw)[:-1]])
        within = np.arange(total) - np.repeat(word_first, nw)
        seq = np.empty(total + 2 * S, dtype=np.int64)
        seq[np.repeat(first, nw) + within] = np.where(within == 0, 2 * n + word, n + word)
        seq[first + nw] = 3 * n + punct
        seq[first + nw + 1] = 3 * n + len(PUNCT) + sep
        lens = table.lens[seq]
        ends = np.cumsum(lens)
        # stop at the first sentence that reaches the target
        sent_end = ends[first + nw + 1]
        cut = int(np.searchsorted(sent_end, target - size)) + 1
        if cut < S:
            m = int(first[cut])
            seq, lens, ends = seq[:m], lens[:m], ends[:m]
        out_start = ends - lens
        src = np.repeat(table.starts[seq] - out_start, lens) + np.arange(int(ends[-1]))
        chunk = table.flat[src].tobytes()
        parts.append(chunk)
        size += len(chunk)
    return b"".join(parts)


def generate(out_dir, seed: int, spec: dict) -> list[Path]:
    """Write the corpus ``spec`` (``bytes``, ``files``, ``lexicon`` and
    optionally ``word_letters``, see ``make_lexicon``) for ``seed`` into
    ``out_dir``. Returns the files in order."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    per_file = int(spec["bytes"]) // int(spec["files"])
    n_seg = max(1, -(-per_file // SEGMENT_BYTES))
    jobs = [
        (seed, f, s, per_file // n_seg + (1 if s < per_file % n_seg else 0))
        for f in range(int(spec["files"]))
        for s in range(n_seg)
    ]
    table = PieceTable(make_lexicon(int(spec["lexicon"]), seed, spec.get("word_letters")))
    workers = max(1, min(os.cpu_count() or 1, len(jobs)))
    paths = [out_dir / f"corpus_{f:03d}.txt" for f in range(int(spec["files"]))]
    handles = [open(p, "wb") for p in paths]
    try:
        # NumPy releases the interpreter lock in the large operations
        with ThreadPoolExecutor(workers) as pool:
            for job, data in zip(jobs, pool.map(lambda j: _segment(table, *j), jobs)):
                handles[job[1]].write(data)
        # written back to disk now, in the set-up, not during the window
        for h in handles:
            h.flush()
            os.fsync(h.fileno())
    finally:
        for h in handles:
            h.close()
    return paths


if __name__ == "__main__":
    out, seed, nbytes, files, lexicon = sys.argv[1:6]
    written = generate(out, int(seed), {"bytes": int(nbytes), "files": int(files),
                                        "lexicon": int(lexicon)})
    print(sum(p.stat().st_size for p in written), "bytes in", len(written), "files")
