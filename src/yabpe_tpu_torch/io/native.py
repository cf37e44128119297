"""Native model serialization: vocab.json / merges.txt / special_tokens.json.

Byte-for-byte format parity with the reference
(the reference library's trainer.py:94-117 for save and tokenizer.py:106-150
for load):

- ``vocab.json``: {latin-1-decoded token bytes: id}, UTF-8 file, indent 2,
  ensure_ascii=False.
- ``merges.txt``: one "<left> <right>" latin-1-decoded line per merge;
  loading splits on the *first* space only and tolerates malformed lines
  (tokens containing a newline corrupt this format — a documented hazard the
  reference's tests accept; the JAX package's GPT-2 dialect avoids it).
- ``special_tokens.json``: JSON list of strings; optional on load.
"""

from __future__ import annotations

import json
from collections.abc import Mapping, Sequence
from pathlib import Path


def save_model(
    output_dir: str | Path,
    vocab: Mapping[bytes, int],
    merges: Sequence[tuple[bytes, bytes]],
    special_tokens: Sequence[str],
) -> None:
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)

    vocab_str = {tok.decode("latin-1"): idx for tok, idx in vocab.items()}
    with open(out / "vocab.json", "w", encoding="utf-8") as f:
        json.dump(vocab_str, f, ensure_ascii=False, indent=2)

    with open(out / "merges.txt", "w", encoding="utf-8") as f:
        for left, right in merges:
            f.write(f"{left.decode('latin-1')} {right.decode('latin-1')}\n")

    with open(out / "special_tokens.json", "w", encoding="utf-8") as f:
        json.dump(list(special_tokens), f, ensure_ascii=False, indent=2)


def load_model(
    model_dir: str | Path,
) -> tuple[dict[bytes, int], list[tuple[bytes, bytes]], list[str]]:
    path = Path(model_dir)

    with open(path / "vocab.json", encoding="utf-8") as f:
        vocab_str: dict[str, int] = json.load(f)
    vocab = {k.encode("latin-1"): v for k, v in vocab_str.items()}

    merges: list[tuple[bytes, bytes]] = []
    with open(path / "merges.txt", encoding="utf-8") as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            parts = line.split(" ", 1)
            if len(parts) == 2:
                merges.append(
                    (parts[0].encode("latin-1"), parts[1].encode("latin-1"))
                )

    special_tokens: list[str] = []
    special_file = path / "special_tokens.json"
    if special_file.exists():
        with open(special_file, encoding="utf-8") as f:
            special_tokens = json.load(f)

    return vocab, merges, special_tokens


__all__ = ["save_model", "load_model"]
