"""UTF-8-boundary-safe corpus chunking.

Splits a large file into byte spans that can be independently decoded as
UTF-8 and pre-tokenized by parallel workers. Behavioral parity target:
the reference library's trainer.py:139-144,172-198 (chunk ends are
backed off multi-byte UTF-8 continuation bytes so no character is split).

Beyond the reference, :func:`chunk_spans` optionally aligns chunk ends to a
*pre-token-safe* delimiter (a newline) when one is found near the boundary, so
that pre-tokens are never split across chunks; the reference accepts that
infidelity in training statistics at chunk edges. Parity-mode configs use one
giant chunk, which makes both schemes equivalent.
"""

from __future__ import annotations

from pathlib import Path

_CONTINUATION_MASK = 0b1100_0000
_CONTINUATION_TAG = 0b1000_0000

# How far back to scan for a newline when delimiter alignment is enabled.
_DELIM_WINDOW = 4096


def utf8_safe_end(window: bytes, pos: int) -> int:
    """Back ``pos`` off any UTF-8 continuation bytes within ``window``.

    Returns the largest index <= pos such that ``window[index]`` is not a
    continuation byte (i.e. a split there does not bisect a code point).
    """
    if pos >= len(window):
        return len(window)
    while pos > 0 and (window[pos] & _CONTINUATION_MASK) == _CONTINUATION_TAG:
        pos -= 1
    return pos


def chunk_spans(
    path: str | Path,
    chunk_size_bytes: int,
    *,
    align_to_newline: bool = False,
) -> list[tuple[int, int]]:
    """Compute (start, end) byte spans covering ``path`` exactly once.

    Each span ends on a UTF-8 character boundary. With ``align_to_newline``,
    spans additionally prefer to end just after a newline found within the
    last ``_DELIM_WINDOW`` bytes of the tentative boundary, so pre-tokens
    never straddle spans.
    """
    path = Path(path)
    file_size = path.stat().st_size
    if file_size == 0:
        return []
    if file_size <= chunk_size_bytes:
        return [(0, file_size)]

    spans: list[tuple[int, int]] = []
    with open(path, "rb") as f:
        start = 0
        while start < file_size:
            tentative = min(start + chunk_size_bytes, file_size)
            if tentative >= file_size:
                spans.append((start, file_size))
                break
            end = _adjust_end(f, start, tentative, align_to_newline)
            if end <= start:
                # Degenerate (e.g. >chunk_size of continuation bytes, which is
                # not valid UTF-8 anyway): advance by one byte to guarantee
                # progress; the decode step will raise a positioned error.
                end = start + 1
            spans.append((start, end))
            start = end
    return spans


def _adjust_end(f, start: int, tentative: int, align_to_newline: bool) -> int:
    if align_to_newline:
        win_start = max(start, tentative - _DELIM_WINDOW)
        f.seek(win_start)
        window = f.read(tentative - win_start)
        nl = window.rfind(b"\n")
        if nl >= 0:
            return win_start + nl + 1
    # UTF-8 backoff: examine the byte AT the tentative split (one past the
    # chunk) — if it is a continuation byte the split would bisect a code
    # point. A code point is at most 4 bytes, so a 5-byte window suffices.
    win_start = max(start, tentative - 4)
    f.seek(win_start)
    window = f.read(tentative - win_start + 1)
    return win_start + utf8_safe_end(window, tentative - win_start)


def read_span(path: str | Path, start: int, end: int) -> bytes:
    """Read bytes [start, end) of ``path``."""
    with open(path, "rb") as f:
        f.seek(start)
        return f.read(end - start)


def decode_span_utf8(data: bytes, path: str | Path, start: int) -> str:
    """Strict UTF-8 decode with a positioned error message on failure."""
    try:
        return data.decode("utf-8")
    except UnicodeDecodeError as e:
        raise ValueError(
            f"File {path} contains invalid UTF-8 at position {start + e.start}."
        ) from e


def ensure_exists(path: str | Path) -> Path:
    p = Path(path)
    if not p.exists():
        raise FileNotFoundError(f"File not found: {p}")
    return p


__all__ = [
    "utf8_safe_end",
    "chunk_spans",
    "read_span",
    "decode_span_utf8",
    "ensure_exists",
]
