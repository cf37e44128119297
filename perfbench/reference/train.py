"""Byte-level BPE training in plain Python and NumPy: the benchmark's reference.

Semantics, as the reference library has them: the vocabulary starts with
the 256 single bytes (id = byte value), then the special tokens in order;
each step merges the pair of adjacent symbols with the highest count over
all words (weighted by the word's count), ties going to the
lexicographically greatest ``(left bytes, right bytes)``, applied leftmost
and without overlap in every word; the merged bytes get the next id unless
the vocabulary already holds them; training stops after ``vocab_size``
minus the base's size merges, or earlier when the best count is under
``min_frequency`` or no pair is left.

``train_bpe`` is incremental: an inverted index from each pair to the
words that may hold it, counts updated from the words a merge touches, and
a lazy heap. ``train_bpe_recount`` counts every pair again at every step,
the plain form that the tests hold ``train_bpe`` against.
"""

from __future__ import annotations

import heapq
from collections import Counter

import numpy as np


def _base(specials) -> tuple[list[bytes], dict[bytes, int]]:
    id_bytes = [bytes([b]) for b in range(256)]
    ids = {b: i for i, b in enumerate(id_bytes)}
    for s in specials:
        tok = s.encode("utf-8")
        if tok not in ids:
            ids[tok] = len(id_bytes)
            id_bytes.append(tok)
    return id_bytes, ids


def _tie_key(tok: bytes, tie: str) -> tuple:
    """A heap key whose ascending order is the tie-break's order: the
    greatest bytes first (``tie="greatest"``, the reference library's) or
    the least first (``"least"``, the control)."""
    if tie == "least":
        return tuple(tok) + (-1,)
    # reversed lexicographic order: a byte x as 256 - x, the end as 257
    return tuple(256 - x for x in tok) + (257,)


def train_bpe(word_counts, specials, vocab_size: int, min_frequency: int, *,
              tie: str = "greatest", stats: dict | None = None):
    """Returns (vocab {bytes: id}, merges [(left, right)]).

    ``stats``, if given, gets ``k2_bytes``: the bytes a merge loop has to
    move for these inputs, whatever implements it (the words' symbols and
    counts read once at 4 bytes each; for each merge, each word that holds
    the pair, 8 bytes a live symbol plus 4; the merge list written at 8
    bytes a merge), and ``words``, the number of unique words.
    """
    id_bytes, ids = _base(specials)
    num_merges = max(0, vocab_size - len(id_bytes))
    items = sorted((w, c) for w, c in word_counts.items() if c > 0 and w)
    V = len(id_bytes) + num_merges + 1
    n_words = len(items)
    ln = np.array([len(w) for w, _ in items], dtype=np.int64)
    cnt = np.array([c for _, c in items], dtype=np.int64)
    off = np.concatenate([[0], np.cumsum(ln)[:-1]]).astype(np.int64)
    sym = np.frombuffer(b"".join(w for w, _ in items), dtype=np.uint8).astype(np.int64)
    moved = 4 * int(ln.sum()) + 4 * n_words

    def gather(W: np.ndarray):
        """Positions of the words ``W``'s live symbols, each position's
        word (as an index into ``W``) and whether it has a right neighbour
        in its word."""
        L = ln[W]
        total = int(L.sum())
        first = np.concatenate([[0], np.cumsum(L)[:-1]])
        owner = np.repeat(np.arange(len(W)), L)
        within = np.arange(total) - first[owner]
        pos = off[W][owner] + within
        has_next = within < (L[owner] - 1)
        return pos, owner, within, has_next

    # initial pair counts and index
    pos, owner, _, has_next = gather(np.arange(n_words))
    p = pos[has_next]
    pair0 = sym[p] * V + sym[p + 1]
    w0 = owner[has_next]
    uniq, inv = np.unique(pair0, return_inverse=True)
    pc: dict[int, int] = dict(zip(uniq.tolist(), np.bincount(inv, weights=cnt[w0]).astype(np.int64).tolist()))
    order = np.lexsort((w0, pair0))
    sp, sw = pair0[order], w0[order]
    cuts = np.flatnonzero(np.diff(sp)) + 1
    index: dict[int, list[np.ndarray]] = {
        int(k): [np.unique(v)] for k, v in zip(sp[np.r_[0, cuts]] if len(sp) else [], np.split(sw, cuts))
    }
    del pos, owner, has_next, p, pair0, w0, uniq, inv, order, sp, sw

    keys = [_tie_key(t, tie) for t in id_bytes]
    heap = [(-c, keys[k // V], keys[k % V], k) for k, c in pc.items()]
    heapq.heapify(heap)

    merges: list[tuple[bytes, bytes]] = []
    while len(merges) < num_merges:
        best = None
        while heap:
            neg, _, _, k = heap[0]
            if pc.get(k, 0) == -neg:
                best = k
                break
            heapq.heappop(heap)
        if best is None or -heap[0][0] < min_frequency:
            break
        a, b = divmod(best, V)
        merged = id_bytes[a] + id_bytes[b]
        new = ids.get(merged)
        if new is None:
            new = ids[merged] = len(id_bytes)
            id_bytes.append(merged)
            keys.append(_tie_key(merged, tie))
        merges.append((id_bytes[a], id_bytes[b]))

        W = np.unique(np.concatenate(index.pop(best)))
        pos, owner, within, has_next = gather(W)
        s = sym[pos]
        nxt = np.where(has_next, sym[np.minimum(pos + 1, len(sym) - 1)], -1)
        hit = (s == a) & (nxt == b)
        if a == b:
            # in a run of hits, take the first and every second after it
            run_start = hit & ~np.r_[False, hit[:-1] & has_next[:-1]]
            idx = np.arange(len(hit))
            last_start = np.maximum.accumulate(np.where(run_start, idx, 0))
            hit &= ((idx - last_start) % 2) == 0
        touched = np.zeros(len(W), dtype=bool)
        touched[owner[hit]] = True
        sel = touched[owner]
        moved += int((8 * ln[W[touched]] + 4).sum())

        # old pairs of the touched words
        o_has = has_next & sel
        old_pair = s[o_has] * V + nxt[o_has]
        old_w = cnt[W[owner[o_has]]]
        # the touched words after the merge
        drop = np.zeros(len(s), dtype=bool)
        drop[np.flatnonzero(hit) + 1] = True
        s2 = np.where(hit, new, s)
        keep = sel & ~drop
        s2, o2 = s2[keep], owner[keep]
        new_len = np.bincount(o2, minlength=len(W))
        first2 = np.concatenate([[0], np.cumsum(new_len)[:-1]])
        within2 = np.arange(len(s2)) - first2[o2]
        sym[off[W][o2] + within2] = s2
        ln[W[touched]] = new_len[touched]
        n_has = within2 < (new_len[o2] - 1)
        new_pair = s2[:-1][n_has[:-1]] * V + s2[1:][n_has[:-1]]
        new_owner = o2[:-1][n_has[:-1]]
        new_w = cnt[W[new_owner]]

        allp = np.concatenate([old_pair, new_pair])
        if len(allp):
            uniq, inv = np.unique(allp, return_inverse=True)
            delta = np.bincount(inv, weights=np.concatenate([-old_w, new_w])).astype(np.int64)
            nz = np.flatnonzero(delta)
            for k, d in zip(uniq[nz].tolist(), delta[nz].tolist()):
                c = pc.get(k, 0) + d
                if c:
                    pc[k] = c
                    heapq.heappush(heap, (-c, keys[k // V], keys[k % V], k))
                else:
                    pc.pop(k, None)
        # index the pairs that hold the new symbol
        with_new = (new_pair // V == new) | (new_pair % V == new)
        if with_new.any():
            kp, kw = new_pair[with_new], W[new_owner[with_new]]
            order = np.lexsort((kw, kp))
            kp, kw = kp[order], kw[order]
            cuts = np.flatnonzero(np.diff(kp)) + 1
            for k, ws in zip(kp[np.r_[0, cuts]].tolist(), np.split(kw, cuts)):
                index.setdefault(k, []).append(ws)

    if stats is not None:
        stats["k2_bytes"] = moved + 8 * len(merges)
        stats["words"] = n_words
    return dict(ids), merges


def train_bpe_recount(word_counts, specials, vocab_size: int, min_frequency: int):
    """The same training, every pair counted again at every step."""
    id_bytes, ids = _base(specials)
    num_merges = max(0, vocab_size - len(id_bytes))
    words = [([bytes([x]) for x in w], c) for w, c in sorted(word_counts.items()) if c > 0]
    merges: list[tuple[bytes, bytes]] = []
    for _ in range(num_merges):
        counts: Counter = Counter()
        for syms, c in words:
            for i in range(len(syms) - 1):
                counts[(syms[i], syms[i + 1])] += c
        if not counts:
            break
        best = max(counts, key=lambda q: (counts[q], q))
        if counts[best] < min_frequency:
            break
        merged = best[0] + best[1]
        for syms, _ in words:
            i = 0
            while i < len(syms) - 1:
                if syms[i] == best[0] and syms[i + 1] == best[1]:
                    syms[i:i + 2] = [merged]
                i += 1
        merges.append(best)
        if merged not in ids:
            ids[merged] = len(id_bytes)
            id_bytes.append(merged)
    return dict(ids), merges
