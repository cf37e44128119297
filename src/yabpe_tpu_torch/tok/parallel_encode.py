"""Whole-file encoding in parallel, cut only where no pre-token can span.

Counterpart of yabpe_tpu/tok/parallel_encode.py. The result must equal
``encode(whole_file)`` exactly, so a file is cut only where no GPT-2
pre-token can span the cut: at a **non-whitespace -> whitespace
transition** (the cut character is whitespace, the character before it is
not), outside every special-token occurrence.

- No GPT-2 pre-token contains a non-ws -> ws transition (`` ?\\p{L}+``
  and its siblings take at most a leading space and stop at whitespace;
  the ``\\s+`` branches are all whitespace), so the transition is a
  pre-token boundary of the whole text.
- The left chunk ends at a non-whitespace character, whose last pre-token
  ends at the end of the buffer as it does mid-text.
- The right chunk starts with the whole whitespace run and what follows
  it, so the run is split as it is mid-text.

A cut inside or at the end of a whitespace run is not safe: ``\\s+(?!\\S)``
splits a run at the end of a buffer differently from the same run mid-text
(``"x\\n\\n" + "line"`` gives ``\\n\\n`` as one pre-token, the whole text
``\\n`` then ``\\n``). Where no safe transition lies near the target, the
chunk is extended forward to the next one or to the end of the file.

Whitespace is the pre-tokenizer's: the ``regex`` engine's Unicode ``\\s``,
which is the 25 code points of Unicode's White_Space property. The JAX
package asks ``regex``; the port, which runs where ``regex`` is absent,
holds the set itself (:data:`WHITESPACE`; ``str.isspace`` is not that set:
it also takes U+001C-001F).

With the native library, the workers are threads, each with its own
native encoder, whose ctypes calls release the GIL. Without it, a pool of
processes runs the tokenizer's regex path.
"""

from __future__ import annotations

import multiprocessing
import os
import re
import threading
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from pathlib import Path

import numpy as np

from yabpe_tpu_torch import native
from yabpe_tpu_torch.pretok import chunking

#: Unicode's White_Space code points: what the ``regex`` module's ``\s``
#: matches, and so what the GPT-2 pattern treats as whitespace.
WHITESPACE = frozenset(
    [*range(0x09, 0x0E), 0x20, 0x85, 0xA0, 0x1680, *range(0x2000, 0x200B),
     0x2028, 0x2029, 0x202F, 0x205F, 0x3000]
)
_ASCII_WS = frozenset(c for c in WHITESPACE if c < 128)
_SCAN_WINDOW = 65536

# Byte-level candidate prefilter: a safe cut's character is whitespace, so
# it starts with an ASCII whitespace byte or a UTF-8 lead byte (\xc2-\xf4,
# for the non-ASCII whitespace code points). The compiled class scans a
# window at C speed, so regions without whitespace pass in one call.
_CUT_CANDIDATE = re.compile(b"[" + bytes(sorted(_ASCII_WS)) + b"\xc2-\xf4]")

_WORKER_TOK = None


def _init_worker(vocab, merges, special_tokens):
    global _WORKER_TOK
    from yabpe_tpu_torch.tok.tokenizer import BBPETokenizer

    _WORKER_TOK = BBPETokenizer(vocab=vocab, merges=merges, special_tokens=special_tokens)


def _encode_span(path: str, start: int, end: int) -> np.ndarray:
    data = chunking.read_span(path, start, end)
    text = chunking.decode_span_utf8(data, path, start)
    return np.asarray(_WORKER_TOK.encode(text), dtype=np.int32)


def _char_len(b0: int) -> int:
    """UTF-8 sequence length implied by a lead byte (0 for continuations)."""
    if b0 < 0x80:
        return 1
    if b0 < 0xC0:
        return 0
    if b0 < 0xE0:
        return 2
    if b0 < 0xF0:
        return 3
    return 4


def _is_ws_at(buf: bytes, r: int) -> bool | None:
    """Whitespace-ness of the character starting at ``buf[r]``.

    None when ``r`` is not a character start or the character is truncated
    or malformed (such positions are never safe cuts).
    """
    b0 = buf[r]
    if b0 < 0x80:
        return b0 in _ASCII_WS
    n = _char_len(b0)
    if n == 0 or r + n > len(buf):
        return None
    try:
        ch = buf[r : r + n].decode("utf-8")
    except UnicodeDecodeError:
        return None
    return ord(ch) in WHITESPACE


def _prev_is_nonws(buf: bytes, r: int) -> bool:
    """True iff a complete non-whitespace character ends at ``buf[r-1]``."""
    s = r - 1
    lim = max(0, r - 4)
    while s >= lim and (buf[s] & 0xC0) == 0x80:
        s -= 1
    if s < 0:
        return False
    n = _char_len(buf[s])
    if n == 0 or s + n != r:
        return False
    return _is_ws_at(buf, s) is False


def _inside_special(window: bytes, pos: int, specials: list[bytes]) -> bool:
    for sp in specials:
        lo = max(0, pos - len(sp) + 1)
        if sp in window[lo : pos + len(sp) - 1]:
            return True
    return False


def _is_safe_cut(buf: bytes, r: int, specials: list[bytes]) -> bool:
    return (
        _is_ws_at(buf, r) is True
        and _prev_is_nonws(buf, r)
        and not _inside_special(buf, r, specials)
    )


def safe_cut_points(
    path: str | Path, target_chunk: int, special_tokens: list[str]
) -> list[tuple[int, int]]:
    """Byte spans whose boundaries no pre-token or special can span.

    Every cut sits on a non-ws -> ws transition outside special-token
    occurrences, and a chunk is extended forward where no such transition
    lies near its target end, so ``concat(encode(span))`` equals
    ``encode(whole_file)``.
    """
    path = Path(path)
    size = path.stat().st_size
    if size <= target_chunk:
        return [(0, size)] if size else []

    specials = [s.encode("utf-8") for s in special_tokens]
    # Context margin: enough bytes past a candidate to decode the cut
    # character (<= 4 bytes) and to see a straddling special occurrence.
    margin = max(4, max((len(s) for s in specials), default=0))

    spans: list[tuple[int, int]] = []
    with open(path, "rb") as f:
        start = 0
        while start < size:
            tentative = min(start + target_chunk, size)
            if tentative >= size:
                spans.append((start, size))
                break
            cut = _find_safe_cut(f, start, tentative, size, specials, margin)
            if cut is None:
                spans.append((start, size))
                break
            spans.append((start, cut))
            start = cut
    return spans


def _find_safe_cut(
    f, start: int, tentative: int, size: int, specials: list[bytes], margin: int
) -> int | None:
    """The largest safe cut in (start, tentative], else the smallest one past
    ``tentative`` (forward extension), else None (the rest is one span)."""
    win_lo = max(start + 1, tentative - _SCAN_WINDOW)
    buf_lo = max(0, win_lo - margin)
    f.seek(buf_lo)
    buf = f.read(min(tentative + margin, size) - buf_lo)
    candidates = [
        m.start()
        for m in _CUT_CANDIDATE.finditer(buf, win_lo - buf_lo, tentative - buf_lo + 1)
    ]
    for r in reversed(candidates):
        if _is_safe_cut(buf, r, specials):
            return buf_lo + r
    pos = tentative + 1
    while pos < size:
        win_hi = min(size, pos + _SCAN_WINDOW)
        buf_lo = max(0, pos - margin)
        f.seek(buf_lo)
        buf = f.read(min(win_hi + margin, size) - buf_lo)
        for m in _CUT_CANDIDATE.finditer(buf, pos - buf_lo, win_hi - buf_lo):
            if _is_safe_cut(buf, m.start(), specials):
                return buf_lo + m.start()
        pos = win_hi
    return None


def encode_file_parallel(
    path: str | Path,
    vocab: dict[bytes, int],
    merges: list[tuple[bytes, bytes]],
    special_tokens: list[str],
    *,
    max_workers: int | None = None,
    chunk_bytes: int = 4 * 1024 * 1024,
    symbol_tables=None,
    encoder_pool: "EncoderPool | None" = None,
) -> np.ndarray:
    """Encode a whole file exactly, over worker threads (native library) or
    a pool of processes (without it). Returns int32 ids.

    ``symbol_tables`` optionally carries the caller's (live, out_ids)
    extended-symbol tables, so that repeated calls skip rebuilding them;
    ``encoder_pool`` an :class:`EncoderPool` whose native encoders keep
    their word caches across calls.
    """
    path = chunking.ensure_exists(path)
    spans = safe_cut_points(path, chunk_bytes, special_tokens)
    if not spans:
        return np.zeros((0,), dtype=np.int32)
    if max_workers is None:
        max_workers = min(os.cpu_count() or 1, 16)

    if native.available():
        return _encode_spans_threaded(
            path, spans, vocab, merges, special_tokens, max_workers,
            symbol_tables, encoder_pool,
        )

    # Without the native library: the regex path, in processes (the GIL
    # holds a thread pool to one core).
    if max_workers <= 1 or len(spans) < 4:
        _init_worker(vocab, merges, special_tokens)
        return np.concatenate([_encode_span(str(path), s, e) for s, e in spans])
    with ProcessPoolExecutor(
        max_workers=max_workers,
        mp_context=multiprocessing.get_context("spawn"),
        initializer=_init_worker,
        initargs=(vocab, merges, special_tokens),
    ) as pool:
        futures = [pool.submit(_encode_span, str(path), s, e) for s, e in spans]
        return np.concatenate([f.result() for f in futures])


class EncoderPool:
    """Native encoders whose word caches stay warm across encode_file calls;
    without one, every call pays the corpus's unique-word BPE again.

    The pool is bound to one (live, out_ids) pair of symbol tables, checked
    by identity at every claim: a pool reused with other vocab or merges
    would encode with the wrong ranks. ``claim`` hands the whole pool to one
    encode_file call at a time; a concurrent call finds it empty and builds
    encoders of its own, so no native handle is shared between threads
    within a call.
    """

    def __init__(self) -> None:
        self._encoders: list[native.NativeEncoder] = []
        self._tables: tuple | None = None
        self._lock = threading.Lock()

    def __len__(self) -> int:
        with self._lock:
            return len(self._encoders)

    def claim(self, live, out_ids) -> list:
        with self._lock:
            if self._tables is None:
                self._tables = (live, out_ids)
            elif self._tables[0] is not live or self._tables[1] is not out_ids:
                raise ValueError(
                    "EncoderPool is bound to different symbol tables; use a "
                    "fresh pool per (vocab, merges)"
                )
            claimed, self._encoders = self._encoders, []
            return claimed

    def release(self, encoders: list) -> None:
        with self._lock:
            self._encoders.extend(encoders)

    def clear_caches(self) -> None:
        with self._lock:
            for enc in self._encoders:
                enc.cache_clear()


def _encode_spans_threaded(
    path: Path,
    spans: list[tuple[int, int]],
    vocab: dict[bytes, int],
    merges: list[tuple[bytes, bytes]],
    special_tokens: list[str],
    max_workers: int,
    symbol_tables=None,
    encoder_pool: EncoderPool | None = None,
) -> np.ndarray:
    """Threads with one native encoder each.

    With ``encoder_pool``, the threads take the pool's encoders by index
    (growing the claimed list as needed) and give them back afterwards,
    not closed.
    """
    if symbol_tables is not None:
        live, out_ids = symbol_tables
    else:
        from yabpe_tpu_torch.tok.symbols import extended_symbol_tables

        _, live, out_ids = extended_symbol_tables(vocab, merges, vocab.get(b"[UNK]", 0))
    sp_bytes = [s.encode("utf-8") for s in sorted(special_tokens, key=len, reverse=True)]
    sp_ids = [vocab.get(b, -1) for b in sp_bytes]

    local = threading.local()
    owned: list[native.NativeEncoder] = []
    claimed = encoder_pool.claim(live, out_ids) if encoder_pool is not None else []
    enc_lock = threading.Lock()
    next_idx = [0]

    def encoder() -> native.NativeEncoder:
        e = getattr(local, "enc", None)
        if e is None:
            with enc_lock:
                if encoder_pool is not None:
                    i = next_idx[0]
                    next_idx[0] += 1
                    while len(claimed) <= i:
                        claimed.append(native.NativeEncoder(live, out_ids))
                    e = claimed[i]
                else:
                    e = native.NativeEncoder(live, out_ids)
                    owned.append(e)
            local.enc = e
        return e

    def work(span: tuple[int, int]) -> np.ndarray:
        data = chunking.read_span(path, span[0], span[1])
        if native.utf8_invalid_at(data) >= 0:
            chunking.decode_span_utf8(data, path, span[0])  # raises, positioned
        return encoder().encode_text(data, sp_bytes, sp_ids)

    workers = min(max_workers, os.cpu_count() or 1)
    try:
        if workers <= 1 or len(spans) == 1:
            parts = [work(sp) for sp in spans]
        else:
            with ThreadPoolExecutor(max_workers=workers) as pool:
                parts = list(pool.map(work, spans))
    finally:
        for e in owned:
            e.close()
        if encoder_pool is not None:
            encoder_pool.release(claimed)
    return np.concatenate(parts)


__all__ = ["EncoderPool", "WHITESPACE", "encode_file_parallel", "safe_cut_points"]
