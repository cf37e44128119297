"""GPT-2 pre-tokenisation in plain Python, with the standard library's ``re``.

The pattern is GPT-2's published one,

    's|'t|...| ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+

with ``\\p{L}``, ``\\p{N}`` and ``\\s`` spelled out as character classes:
letters and numbers by ``unicodedata``'s general category, white space as
Unicode's White_Space property. ``re`` then matches as the ``regex``
package does (leftmost alternative first, the same backtracking).

Two dialects of special tokens, as the reference library has them:

- training: the specials, in the configuration's order, are alternatives
  ahead of the GPT-2 pattern, so each is counted as a pre-token;
- encoding: the text is first split at the specials, longest first.

Training counts are per span: a file is cut into spans of
``chunk_size_bytes`` (backed off UTF-8 continuation bytes) and each span is
pre-tokenised alone, so a pre-token that straddles a cut counts as two.
"""

from __future__ import annotations

import multiprocessing
import os
import re
import sys
import unicodedata
from collections import Counter
from functools import lru_cache

WHITE_SPACE = (
    [(0x09, 0x0D), (0x20, 0x20), (0x85, 0x85), (0xA0, 0xA0), (0x1680, 0x1680),
     (0x2000, 0x200A), (0x2028, 0x2029), (0x202F, 0x202F), (0x205F, 0x205F),
     (0x3000, 0x3000)]
)


def _class(ranges) -> str:
    return "".join(
        re.escape(chr(a)) if a == b else f"{re.escape(chr(a))}-{re.escape(chr(b))}"
        for a, b in ranges
    )


def _category_ranges(prefix: str) -> list[tuple[int, int]]:
    out: list[tuple[int, int]] = []
    for cp in range(sys.maxunicode + 1):
        if unicodedata.category(chr(cp)).startswith(prefix):
            if out and out[-1][1] == cp - 1:
                out[-1] = (out[-1][0], cp)
            else:
                out.append((cp, cp))
    return out


@lru_cache(maxsize=None)
def gpt2_pattern() -> str:
    L = _class(_category_ranges("L"))
    N = _class(_category_ranges("N"))
    S = _class(WHITE_SPACE)
    return (
        rf"""'(?:[sdmt]|ll|ve|re)| ?[{L}]+| ?[{N}]+| ?[^{S}{L}{N}]+"""
        rf"""|[{S}]+(?![^{S}])|[{S}]+"""
    )


@lru_cache(maxsize=None)
def training_regex(specials: tuple[str, ...]) -> re.Pattern:
    alts = [re.escape(s) for s in specials] + [gpt2_pattern()]
    return re.compile("|".join(alts))


@lru_cache(maxsize=None)
def plain_regex() -> re.Pattern:
    return re.compile(gpt2_pattern())


def split_specials(text: str, specials) -> list[tuple[bool, str]]:
    """``text`` cut at the specials, longest first: (is_special, piece)."""
    if not specials:
        return [(False, text)] if text else []
    ordered = sorted(specials, key=len, reverse=True)
    parts = re.split("(" + "|".join(re.escape(s) for s in ordered) + ")", text)
    return [(i % 2 == 1, p) for i, p in enumerate(parts) if p]


def spans(path, chunk_size_bytes: int) -> list[tuple[int, int]]:
    """Byte spans of ``chunk_size_bytes``, each end backed off UTF-8
    continuation bytes."""
    data_len = os.path.getsize(path)
    out = []
    start = 0
    with open(path, "rb") as f:
        while start < data_len:
            end = min(start + chunk_size_bytes, data_len)
            if end < data_len:
                f.seek(end)
                pos = end
                while pos > start and (f.read(1)[0] & 0xC0) == 0x80:
                    pos -= 1
                    f.seek(pos)
                end = pos if pos > start else start + 1
            out.append((start, end))
            start = end
    return out


def count_span(job) -> Counter:
    path, start, end, specials = job
    with open(path, "rb") as f:
        f.seek(start)
        text = f.read(end - start).decode("utf-8")
    counts = Counter(training_regex(specials).findall(text))
    return Counter({w.encode("utf-8"): c for w, c in counts.items()})


def count_words(files, specials, chunk_size_bytes: int) -> Counter:
    """Pre-token counts of ``files`` in the training dialect."""
    jobs = [(str(p), a, b, tuple(specials)) for p in files for a, b in spans(p, chunk_size_bytes)]
    total: Counter = Counter()
    workers = min(os.cpu_count() or 1, len(jobs))
    if workers <= 1:
        for job in jobs:
            total.update(count_span(job))
        return total
    with multiprocessing.get_context("spawn").Pool(workers) as pool:
        for part in pool.imap_unordered(count_span, jobs):
            total.update(part)
    return total
