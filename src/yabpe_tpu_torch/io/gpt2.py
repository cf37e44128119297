"""GPT-2 model-file dialect: byte<->unicode remap, loaders, reconstruction.

A copy of yabpe_tpu/io/gpt2.py.

GPT-2-format files (`gpt2_vocab.json`, `gpt2_merges.txt`) store token bytes
through the printable-unicode remap published with the OpenAI GPT-2 encoder
(every byte maps to a printable codepoint; 188 printable bytes map to
themselves, the remaining 68 shift up by 256). The reference only converts
this dialect inside its test helpers (its tests/common.py:9-54 and
tests/test_tokenizer_gpt2.py:39-74); here it is a first-class model dialect.

Also provides the offline GPT-2 vocabulary reconstruction: ids 0-255 are the
byte tokens ordered by their remap codepoint, ids 256..256+M-1 are the merge
concatenations in merges-file order, and `<|endoftext|>` takes the final id
— byte-identical to the published 50,257-entry vocabulary. This matters in
offline installations, where tiktoken cannot fetch encodings.

The port adds the converse, :func:`derive_gpt2_merges`: the merges in rank
order from the vocabulary alone.
"""

from __future__ import annotations

import json
from functools import lru_cache
from pathlib import Path


@lru_cache(maxsize=1)
def byte_to_unicode() -> dict[int, str]:
    """The GPT-2 byte -> printable-unicode-character map."""
    keep = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    mapping: dict[int, str] = {b: chr(b) for b in keep}
    offset = 0
    for b in range(256):
        if b not in mapping:
            mapping[b] = chr(256 + offset)
            offset += 1
    return mapping


@lru_cache(maxsize=1)
def unicode_to_byte() -> dict[str, int]:
    return {c: b for b, c in byte_to_unicode().items()}


def encode_token(token: bytes) -> str:
    """bytes -> GPT-2 printable string."""
    b2u = byte_to_unicode()
    return "".join(b2u[b] for b in token)


def decode_token(token_str: str) -> bytes:
    """GPT-2 printable string -> bytes."""
    u2b = unicode_to_byte()
    return bytes(u2b[c] for c in token_str)


def load_gpt2_merges(path: str | Path) -> list[tuple[bytes, bytes]]:
    """Load a GPT-2-dialect merges file (one "left right" line per merge)."""
    merges: list[tuple[bytes, bytes]] = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.rstrip("\n")
            if not line or line.startswith("#version"):
                continue
            left, right = line.split(" ")
            merges.append((decode_token(left), decode_token(right)))
    return merges


def load_gpt2_vocab(path: str | Path) -> dict[bytes, int]:
    """Load a GPT-2-dialect vocab json ({printable token: id})."""
    with open(path, encoding="utf-8") as f:
        vocab_str: dict[str, int] = json.load(f)
    return {decode_token(k): v for k, v in vocab_str.items()}


def save_gpt2_vocab(path: str | Path, vocab: dict[bytes, int]) -> None:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(
            {encode_token(k): v for k, v in vocab.items()},
            f,
            ensure_ascii=False,
        )


def save_gpt2_merges(path: str | Path, merges: list[tuple[bytes, bytes]]) -> None:
    with open(path, "w", encoding="utf-8") as f:
        for left, right in merges:
            f.write(f"{encode_token(left)} {encode_token(right)}\n")


def reconstruct_gpt2_vocab(
    merges: list[tuple[bytes, bytes]],
    special_tokens: tuple[str, ...] = ("<|endoftext|>",),
) -> dict[bytes, int]:
    """Rebuild the full GPT-2 vocabulary from its merge list alone.

    Byte tokens are ordered by their remap codepoint; merge concatenations
    follow in file order; specials take the final ids. For the published
    50,000-merge file this reproduces the official 50,257-entry vocab.
    """
    b2u = byte_to_unicode()
    byte_order = sorted(range(256), key=lambda b: ord(b2u[b]))
    vocab: dict[bytes, int] = {}
    for i, b in enumerate(byte_order):
        vocab[bytes([b])] = i
    next_id = 256
    for left, right in merges:
        tok = left + right
        if tok not in vocab:
            vocab[tok] = next_id
            next_id += 1
    for sp in special_tokens:
        spb = sp.encode("utf-8")
        if spb not in vocab:
            vocab[spb] = next_id
            next_id += 1
    return vocab


def derive_gpt2_merges(vocab: dict[bytes, int]) -> list[tuple[bytes, bytes]]:
    """GPT-2's merges in rank order from its vocabulary: each token of id
    256 and up but `<|endoftext|>`, BPE-encoded with the merges derived so
    far, splits into exactly two parts, which are that rank's merge.
    Raises ValueError for a vocabulary that is not built that way."""
    ranks: dict[tuple[bytes, bytes], int] = {}
    merges: list[tuple[bytes, bytes]] = []
    for token, _ in sorted(vocab.items(), key=lambda kv: kv[1])[256:]:
        if token == b"<|endoftext|>":
            continue
        parts = [bytes([b]) for b in token]
        while len(parts) > 2:
            k = min(range(len(parts) - 1),
                    key=lambda i: ranks.get((parts[i], parts[i + 1]), len(ranks)))
            if (parts[k], parts[k + 1]) not in ranks:
                raise ValueError(f"gpt2: {token!r} has no known pair")
            parts[k:k + 2] = [parts[k] + parts[k + 1]]
        if len(parts) != 2:
            raise ValueError(f"gpt2: {token!r} does not split into two")
        ranks[(parts[0], parts[1])] = len(merges)
        merges.append((parts[0], parts[1]))
    return merges


__all__ = [
    "byte_to_unicode",
    "unicode_to_byte",
    "encode_token",
    "decode_token",
    "load_gpt2_merges",
    "load_gpt2_vocab",
    "save_gpt2_vocab",
    "save_gpt2_merges",
    "reconstruct_gpt2_vocab",
    "derive_gpt2_merges",
]
