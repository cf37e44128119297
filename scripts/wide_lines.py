"""Lines whose one pre-token is 65-300 bytes long, from a fixed seed.

    python3 scripts/wide_lines.py OUT.txt [--lines 2000] [--seed 0]

Real text has such pre-tokens, because the GPT-2 pattern keeps a run of
punctuation, or of letters, as one: rules of dashes or equals signs,
ASCII art, long identifiers. No fixture of the repository has one longer
than 13 bytes. Each line is one of three kinds, in turn:

- a run of punctuation (``-=*#~_+.!?/|<>:;``, no quote, so no
  contraction splits it);
- a run of letters from a small alphabet (``abcdefgh``), so that pairs
  repeat inside it;
- a long word without digits, made of English-like syllables.

Lines are drawn from a pool of a third as many distinct tokens, so most
tokens occur several times and survive ``min_frequency=2``. K2 and K3
take words of at most 64 symbols and K1 takes any width, as the TPU
kernels do, so a corpus with these lines trains on K1 where its
admission takes the problem (about vocab 1000 or less) and on the
fallback engines (train/bigvocab.py, train/incremental.py) past it.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

PUNCT = list("-=*#~_+.!?/|<>:;")
LETTERS = list("abcdefgh")
SYLLABLES = [
    "anti", "dis", "establish", "ment", "arian", "ism", "super", "cali",
    "fragil", "istic", "expi", "ali", "docious", "pneumono", "ultra",
    "micro", "scopic", "silico", "volcano", "coniosis", "hippo", "poto",
    "monstro", "sesquip", "edalio", "phobia", "tion", "ness", "able",
]


def wide_token(rng: np.random.Generator, kind: int) -> str:
    """One 65-300-byte token of the given kind (0, 1 or 2)."""
    n = int(rng.integers(65, 301))
    if kind == 0:
        return "".join(rng.choice(PUNCT, size=n))
    if kind == 1:
        return "".join(rng.choice(LETTERS, size=n))
    word = ""
    while len(word) < n:
        word += SYLLABLES[int(rng.integers(len(SYLLABLES)))]
    return word[:n]


def wide_lines(n: int, seed: int = 0) -> list[str]:
    """``n`` lines, each one wide token."""
    rng = np.random.default_rng(seed)
    pool = [wide_token(rng, i % 3) for i in range(max(1, n // 3))]
    return [pool[int(rng.integers(len(pool)))] for _ in range(n)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out")
    ap.add_argument("--lines", type=int, default=2000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    with open(args.out, "w", encoding="utf-8") as f:
        f.write("\n".join(wide_lines(args.lines, args.seed)) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
