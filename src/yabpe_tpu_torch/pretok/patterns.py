"""Pre-tokenization regex patterns (trainer dialect).

The GPT-2 pre-tokenization pattern is the canonical one published with the
OpenAI GPT-2 encoder. Counterpart of yabpe_tpu/pretok/patterns.py, with
one difference: the ``regex`` package is imported only inside the function
that compiles the pattern, so the port imports on a machine without it.
There the native scanner (yabpe_tpu_torch.native) does all ingestion.

Trainer dialect: special tokens are prepended to the GPT-2 alternation *in
config order* and matched by ``findall``, so each special becomes an
ordinary pre-token whose raw UTF-8 bytes take part in training statistics.
"""

from __future__ import annotations

from collections.abc import Sequence

# Canonical GPT-2 pre-tokenization pattern (OpenAI GPT-2 encoder.py).
GPT2_SPLIT_PATTERN: str = (
    r"""'(?:[sdmt]|ll|ve|re)| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"""
)


def compile_trainer_pattern(special_tokens: Sequence[str]):
    """Compile the trainer-side findall pattern.

    Specials are alternated ahead of the GPT-2 pattern in *config order*
    (not longest-first), matching the reference trainer's behavior.
    """
    import regex

    if not special_tokens:
        return regex.compile(GPT2_SPLIT_PATTERN)
    escaped = "|".join(regex.escape(t) for t in special_tokens)
    return regex.compile(f"{escaped}|{GPT2_SPLIT_PATTERN}")


__all__ = ["GPT2_SPLIT_PATTERN", "compile_trainer_pattern"]
