"""Host oracle merge loop (pure Python, non-incremental).

Counterpart of yabpe_tpu/train/reference_loop.py: a deliberately simple
recount-from-scratch implementation of the exact BPE merge semantics of
the reference library (its trainer.py:216-302): highest pair count wins,
ties to the lexicographically greatest (left, right) byte-string tuple,
leftmost non-overlapping application, merged-bytes dedup against the
vocabulary, min-frequency early stop.

The trainer runs it for ``backend="numpy"``; tests hold the other routes
against it.
"""

from __future__ import annotations

from collections import Counter
from collections.abc import Mapping, Sequence

from yabpe_tpu_torch.core.vocab import Vocab


def train_merges_oracle(
    word_counts: Mapping[bytes, int],
    special_tokens: Sequence[str],
    vocab_size: int,
    min_frequency: int,
) -> tuple[Vocab, list[tuple[bytes, bytes]]]:
    """Run the merge loop on a pre-token frequency table.

    Returns the grown vocabulary and the ordered merge list.
    """
    vocab = Vocab.base(special_tokens)
    num_merges = max(0, vocab_size - len(vocab))

    words: list[tuple[list[bytes], int]] = [
        ([bytes([b]) for b in w], c) for w, c in sorted(word_counts.items()) if c > 0
    ]
    merges: list[tuple[bytes, bytes]] = []

    for _ in range(num_merges):
        counts: Counter[tuple[bytes, bytes]] = Counter()
        for syms, freq in words:
            for i in range(len(syms) - 1):
                counts[(syms[i], syms[i + 1])] += freq
        if not counts:
            break
        best = max(counts, key=lambda p: (counts[p], p))
        if counts[best] < min_frequency:
            break

        merged = best[0] + best[1]
        for syms, _ in words:
            i = 0
            out_i = 0
            n = len(syms)
            while i < n:
                if i + 1 < n and syms[i] == best[0] and syms[i + 1] == best[1]:
                    syms[out_i] = merged
                    i += 2
                else:
                    syms[out_i] = syms[i]
                    i += 1
                out_i += 1
            del syms[out_i:]

        merges.append(best)
        vocab.add(merged)

    return vocab, merges


__all__ = ["train_merges_oracle"]
