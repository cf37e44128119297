"""Pre-tokenization regex patterns.

The GPT-2 pre-tokenization pattern is the canonical one published with the
OpenAI GPT-2 encoder. Counterpart of yabpe_tpu/pretok/patterns.py, with
one difference: the ``regex`` package is imported only inside the
functions that compile a pattern, so the port imports on a machine without
it. There the native scanner (yabpe_tpu_torch.native) does all ingestion
and all encoding.

Two special-token dialects:

- **Trainer dialect** (:func:`compile_trainer_pattern`): special tokens are
  prepended to the GPT-2 alternation *in config order* and matched by
  ``findall``, so each special becomes an ordinary pre-token whose raw
  UTF-8 bytes take part in training statistics.
- **Tokenizer dialect** (:func:`compile_special_splitter`): special tokens
  are compiled into a separate capturing split pattern sorted
  longest-first, so overlapping specials match greedily.
"""

from __future__ import annotations

from collections.abc import Sequence

# Canonical GPT-2 pre-tokenization pattern (OpenAI GPT-2 encoder.py).
GPT2_SPLIT_PATTERN: str = (
    r"""'(?:[sdmt]|ll|ve|re)| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"""
)


def compile_gpt2_pattern():
    """Compile the plain GPT-2 pre-tokenization pattern."""
    import regex

    return regex.compile(GPT2_SPLIT_PATTERN)


def compile_trainer_pattern(special_tokens: Sequence[str]):
    """Compile the trainer-side findall pattern.

    Specials are alternated ahead of the GPT-2 pattern in *config order*
    (not longest-first), matching the reference trainer's behavior.
    """
    import regex

    if not special_tokens:
        return compile_gpt2_pattern()
    escaped = "|".join(regex.escape(t) for t in special_tokens)
    return regex.compile(f"{escaped}|{GPT2_SPLIT_PATTERN}")


def compile_special_splitter(special_tokens: Sequence[str]):
    """Compile the tokenizer-side capturing split pattern (longest-first).

    Returns None when there are no special tokens.
    """
    if not special_tokens:
        return None
    import regex

    ordered = sorted(special_tokens, key=len, reverse=True)
    escaped = "|".join(regex.escape(t) for t in ordered)
    return regex.compile(f"({escaped})")


__all__ = [
    "GPT2_SPLIT_PATTERN",
    "compile_gpt2_pattern",
    "compile_special_splitter",
    "compile_trainer_pattern",
]
