"""ctypes binding to the native (C++) pre-tokenizer and host merge loop.

Counterpart of yabpe_tpu/native/__init__.py, cut to what the port calls:
the GPT-2 pre-token scanner and word-frequency counter
(:class:`NativeCounter`, with the unique-word id scan of the device
encoder), the strict UTF-8 validator, the special-token
finder, the host merge loop (:func:`train_host_raw`) and the per-word BPE
encoder of the tokenizer (:class:`NativeEncoder`). The library is
compiled from ``native/yabpe_native.cpp`` at the repository root, unchanged,
with g++ into this package's own build directory on first use.

A failed build raises :class:`NativeBuildError` from :func:`load`. Only
callers that have a second path of their own (the numpy oracle's ingest)
ask :func:`available` first; the device route calls :func:`load` and fails
loudly.

ctypes releases the GIL for the duration of each native call, so the
ingest layer's thread pool gets true host-core parallelism here.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np

_REPO = Path(__file__).resolve().parents[3]
_NATIVE_DIR = _REPO / "native"
_SRC = _NATIVE_DIR / "yabpe_native.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "_build" / "native"
_SO_PATH = _BUILD_DIR / "libyabpe_native.so"

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

_P_I32 = ctypes.POINTER(ctypes.c_int32)
_P_I64 = ctypes.POINTER(ctypes.c_int64)


class NativeBuildError(RuntimeError):
    """The native library could not be compiled or loaded."""


def _stale() -> bool:
    if not _SO_PATH.exists():
        return True
    so_mtime = _SO_PATH.stat().st_mtime
    return any(
        p.stat().st_mtime > so_mtime
        for p in (_SRC, _NATIVE_DIR / "gen_tables.py", _NATIVE_DIR / "unicode_tables.h")
        if p.exists()
    )


def _build() -> None:
    """Compile the library, serialized across processes by a file lock."""
    if not _SRC.exists():
        raise NativeBuildError(f"native source not found: {_SRC}")
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(_BUILD_DIR / "build.lock", "w") as lock_file:
        fcntl.flock(lock_file, fcntl.LOCK_EX)
        if not _stale():  # another process built it while we waited
            return
        tables = _NATIVE_DIR / "unicode_tables.h"
        if not tables.exists():
            # gen_tables.py needs the ``regex`` package.
            _run([sys.executable, str(_NATIVE_DIR / "gen_tables.py")])
        tmp = _SO_PATH.with_suffix(f".tmp{os.getpid()}.so")
        _run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
             "-o", str(tmp), str(_SRC)]
        )
        tmp.replace(_SO_PATH)


def _run(cmd: list[str]) -> None:
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    except subprocess.CalledProcessError as e:
        raise NativeBuildError(
            f"{' '.join(cmd)} failed with code {e.returncode}:\n{e.stderr}"
        ) from e
    except OSError as e:
        raise NativeBuildError(f"{cmd[0]} could not run: {e}") from e


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed. Raises NativeBuildError."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        if _stale():
            _build()
        try:
            lib = ctypes.CDLL(str(_SO_PATH))
        except OSError as e:
            raise NativeBuildError(f"cannot load {_SO_PATH}: {e}") from e

        lib.yabpe_pretok_offsets.restype = ctypes.c_int64
        lib.yabpe_pretok_offsets.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, _P_I32, ctypes.c_int64,
        ]
        lib.yabpe_utf8_validate.restype = ctypes.c_int64
        lib.yabpe_utf8_validate.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        lib.yabpe_pretok_word_ids.restype = ctypes.c_int64
        lib.yabpe_pretok_word_ids.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64, _P_I32,
            ctypes.c_int64,
        ]
        lib.yabpe_pretok_word_ids_specials.restype = ctypes.c_int64
        lib.yabpe_pretok_word_ids_specials.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p,
            _P_I32, ctypes.c_int32, _P_I32, ctypes.c_int64,
        ]
        lib.yabpe_find_specials.restype = ctypes.c_int64
        lib.yabpe_find_specials.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p, _P_I32,
            ctypes.c_int32, _P_I64, _P_I32, ctypes.c_int64,
        ]
        lib.yabpe_counter_new.restype = ctypes.c_void_p
        lib.yabpe_counter_new.argtypes = []
        lib.yabpe_counter_free.restype = None
        lib.yabpe_counter_free.argtypes = [ctypes.c_void_p]
        lib.yabpe_counter_add.restype = None
        lib.yabpe_counter_add.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
            ctypes.c_char_p, _P_I32, ctypes.c_int32,
        ]
        lib.yabpe_counter_add_table.restype = None
        lib.yabpe_counter_add_table.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, _P_I32, _P_I64, ctypes.c_int64,
        ]
        lib.yabpe_counter_merge.restype = None
        lib.yabpe_counter_merge.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.yabpe_counter_unique.restype = ctypes.c_int64
        lib.yabpe_counter_unique.argtypes = [ctypes.c_void_p]
        lib.yabpe_counter_total_bytes.restype = ctypes.c_int64
        lib.yabpe_counter_total_bytes.argtypes = [ctypes.c_void_p]
        lib.yabpe_counter_export.restype = None
        lib.yabpe_counter_export.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, _P_I32, _P_I64,
        ]
        lib.yabpe_encoder_new.restype = ctypes.c_void_p
        lib.yabpe_encoder_new.argtypes = [
            ctypes.POINTER(ctypes.c_uint64), _P_I32, _P_I32, ctypes.c_int64,
            _P_I32, ctypes.c_int32,
        ]
        lib.yabpe_encoder_free.restype = None
        lib.yabpe_encoder_free.argtypes = [ctypes.c_void_p]
        lib.yabpe_encode_text.restype = ctypes.c_int64
        lib.yabpe_encode_text.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p,
            _P_I32, _P_I32, ctypes.c_int32, _P_I32, ctypes.c_int64,
        ]
        lib.yabpe_encode_segment.restype = ctypes.c_int64
        lib.yabpe_encode_segment.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64, _P_I32,
            ctypes.c_int64,
        ]
        lib.yabpe_encoder_cache_info.restype = None
        lib.yabpe_encoder_cache_info.argtypes = [
            ctypes.c_void_p, _P_I64, _P_I64, _P_I64,
        ]
        lib.yabpe_encoder_cache_clear.restype = None
        lib.yabpe_encoder_cache_clear.argtypes = [ctypes.c_void_p]
        lib.yabpe_train.restype = ctypes.c_void_p
        lib.yabpe_train.argtypes = [
            ctypes.c_char_p, _P_I32, _P_I64, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int64,
        ]
        lib.yabpe_train_num_merges.restype = ctypes.c_int32
        lib.yabpe_train_num_merges.argtypes = [ctypes.c_void_p]
        lib.yabpe_train_merges.restype = None
        lib.yabpe_train_merges.argtypes = [ctypes.c_void_p, _P_I32]
        lib.yabpe_train_num_syms.restype = ctypes.c_int32
        lib.yabpe_train_num_syms.argtypes = [ctypes.c_void_p]
        lib.yabpe_train_syms_total_bytes.restype = ctypes.c_int64
        lib.yabpe_train_syms_total_bytes.argtypes = [ctypes.c_void_p]
        lib.yabpe_train_export_syms.restype = None
        lib.yabpe_train_export_syms.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, _P_I32,
        ]
        lib.yabpe_train_free.restype = None
        lib.yabpe_train_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    """True when the library builds and loads."""
    try:
        load()
    except NativeBuildError:
        return False
    return True


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(_P_I32)


def utf8_invalid_at(data: bytes) -> int:
    """Byte offset of the first invalid UTF-8 sequence, or -1 if valid.

    Matches CPython's strict decoder acceptance (surrogates, overlongs,
    truncation and > U+10FFFF all rejected).
    """
    return int(load().yabpe_utf8_validate(data, len(data)))


def pretok_offsets(data: bytes) -> np.ndarray:
    """Token end byte-offsets of ``data`` under the GPT-2 split pattern.

    ``data`` must be valid UTF-8 and hold no special tokens.
    """
    n = len(data)
    ends = np.empty(max(n, 1), dtype=np.int32)  # tokens are >= 1 byte
    count = load().yabpe_pretok_offsets(data, n, _i32p(ends), n)
    return ends[:count]


def find_specials(
    data: bytes, specials_longest_first: list[bytes]
) -> tuple[np.ndarray, np.ndarray]:
    """Non-overlapping special-token occurrences (tokenizer dialect).

    ``specials_longest_first`` must be sorted longest-first. Returns
    (start offsets int64, special indices int32) in document order.
    """
    sp = specials_longest_first
    lens = (ctypes.c_int32 * max(len(sp), 1))(*[len(b) for b in sp])
    min_len = min((len(b) for b in sp if b), default=1)
    cap = len(data) // max(min_len, 1) + 1
    starts = np.empty(cap, dtype=np.int64)
    ids = np.empty(cap, dtype=np.int32)
    count = load().yabpe_find_specials(
        data, len(data), b"".join(sp), lens, len(sp),
        starts.ctypes.data_as(_P_I64), _i32p(ids), cap,
    )
    return starts[:count], ids[:count]


def train_host_raw(
    blob: bytes,
    lens: np.ndarray,
    counts: np.ndarray,
    num_merges: int,
    min_frequency: int,
) -> list[tuple[bytes, bytes]]:
    """Run the native host BPE merge loop over a raw exported word table.

    Exact reference semantics (argmax with lexicographically greatest
    tie-break, leftmost merge scan, dedup branch). Returns the learned
    merges as byte-string pairs.
    """
    lib = load()
    lens = np.ascontiguousarray(lens, dtype=np.int32)
    counts = np.ascontiguousarray(counts, dtype=np.int64)
    handle = lib.yabpe_train(
        blob, _i32p(lens), counts.ctypes.data_as(_P_I64), len(lens),
        num_merges, min_frequency,
    )
    try:
        n_merges = lib.yabpe_train_num_merges(handle)
        merges = np.empty((max(n_merges, 1), 2), dtype=np.int32)
        lib.yabpe_train_merges(handle, _i32p(merges))
        n_syms = lib.yabpe_train_num_syms(handle)
        total = lib.yabpe_train_syms_total_bytes(handle)
        sym_blob = ctypes.create_string_buffer(max(int(total), 1))
        sym_lens = np.empty(max(n_syms, 1), dtype=np.int32)
        lib.yabpe_train_export_syms(handle, sym_blob, _i32p(sym_lens))
    finally:
        lib.yabpe_train_free(handle)
    syms: list[bytes] = []
    off = 0
    raw = sym_blob.raw
    for length in sym_lens[:n_syms].tolist():
        syms.append(raw[off : off + length])
        off += length
    return [
        (syms[left], syms[right]) for left, right in merges[:n_merges].tolist()
    ]


class NativeEncoder:
    """Per-word BPE encoder handle (extended-symbol space, cached).

    ``live`` maps (left symbol, right symbol) to (merge rank, product
    symbol) and ``out_ids`` gives each extended symbol's vocab id, as
    ``tok.symbols.extended_symbol_tables`` builds them.
    """

    def __init__(
        self,
        live: dict[tuple[int, int], tuple[int, int]],
        out_ids: np.ndarray,
    ) -> None:
        self._lib = load()
        keys = np.array(
            [(np.uint64(sl) << np.uint64(32)) | np.uint64(sr) for sl, sr in live],
            dtype=np.uint64,
        )
        ranks = np.array([r for r, _ in live.values()], dtype=np.int32)
        news = np.array([s for _, s in live.values()], dtype=np.int32)
        out32 = np.ascontiguousarray(out_ids, dtype=np.int32)
        self._h: int | None = self._lib.yabpe_encoder_new(
            keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            _i32p(ranks), _i32p(news), len(keys), _i32p(out32), len(out32),
        )
        self._specials_cache: dict = {}

    def _prepared_specials(
        self, special_bytes: list[bytes], special_ids: list[int]
    ):
        """The per-call-constant ctypes argument block, cached by the list
        *values* (so fresh-but-equal lists hit the cache, and a caller
        mutating a list in place never gets a stale block)."""
        key = (tuple(special_bytes), tuple(special_ids))
        prep = self._specials_cache.get(key)
        if prep is None:
            n_sp = len(special_bytes)
            sp_lens = (ctypes.c_int32 * max(n_sp, 1))(
                *[len(b) for b in special_bytes]
            )
            sp_ids = (ctypes.c_int32 * max(n_sp, 1))(
                *[i if i is not None else -1 for i in special_ids]
            )
            prep = (b"".join(special_bytes), sp_lens, sp_ids, n_sp)
            if len(self._specials_cache) >= 64:
                self._specials_cache.clear()
            self._specials_cache[key] = prep
        return prep

    def encode_text(
        self,
        data: bytes,
        special_bytes: list[bytes],
        special_ids: list[int],
    ) -> np.ndarray:
        """Split on specials (longest-first order expected) and encode the
        whole text in one native pass. ``special_ids[i]`` is the vocab id
        written for ``special_bytes[i]`` (-1 drops it)."""
        assert self._h is not None
        n = len(data)
        out = np.empty(max(n + 1, 1), dtype=np.int32)
        sp_blob, sp_lens, sp_ids, n_sp = self._prepared_specials(
            special_bytes, special_ids
        )
        count = self._lib.yabpe_encode_text(
            self._h, data, n, sp_blob, sp_lens, sp_ids, n_sp, _i32p(out),
            len(out),
        )
        return out[:count]

    def encode_segment(self, data: bytes) -> np.ndarray:
        """Pre-tokenize and BPE-encode a special-free UTF-8 segment."""
        assert self._h is not None
        n = len(data)
        out = np.empty(max(n, 1), dtype=np.int32)
        count = self._lib.yabpe_encode_segment(self._h, data, n, _i32p(out), n)
        return out[:count]

    def cache_info(self) -> tuple[int, int, int]:
        """(hits, misses, cached words)."""
        assert self._h is not None
        hits, misses, size = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int64()
        self._lib.yabpe_encoder_cache_info(
            self._h, ctypes.byref(hits), ctypes.byref(misses), ctypes.byref(size)
        )
        return hits.value, misses.value, size.value

    def cache_clear(self) -> None:
        assert self._h is not None
        self._lib.yabpe_encoder_cache_clear(self._h)

    def close(self) -> None:
        if self._h is not None:
            self._lib.yabpe_encoder_free(self._h)
            self._h = None

    def __del__(self) -> None:
        try:
            self.close()
        except Exception:
            pass


class NativeCounter:
    """Word-frequency counter handle over the native scanner."""

    def __init__(self, special_tokens: tuple[str, ...] = ()) -> None:
        self._lib = load()
        self._h: int | None = self._lib.yabpe_counter_new()
        sp = [t.encode("utf-8") for t in special_tokens]
        self._special_bytes = b"".join(sp)
        self._special_lens = (ctypes.c_int32 * max(len(sp), 1))(
            *[len(b) for b in sp]
        )
        self._n_specials = len(sp)

    def add(self, data: bytes) -> None:
        """Pre-tokenize valid-UTF-8 ``data`` and accumulate counts."""
        assert self._h is not None
        self._lib.yabpe_counter_add(
            self._h, data, len(data),
            self._special_bytes, self._special_lens, self._n_specials,
        )

    def add_word_ids(self, data: bytes) -> np.ndarray:
        """Pre-tokenize ``data`` (no specials) and return each occurrence's
        unique-word id, registering new words in this counter."""
        assert self._h is not None
        n = len(data)
        out = np.empty(max(n, 1), dtype=np.int32)
        count = self._lib.yabpe_pretok_word_ids(self._h, data, n, _i32p(out), n)
        return out[:count]

    def add_word_ids_specials(self, data: bytes) -> np.ndarray:
        """Tokenizer-dialect pre-tokenization of ``data`` with this
        counter's special tokens, in one native pass: a pre-token
        occurrence yields its unique-word id (registered here), a special
        occurrence ``-(1 + special_index)``, the index into the
        constructor's order of the specials (longest-first expected)."""
        assert self._h is not None
        n = len(data)
        out = np.empty(max(n, 1), dtype=np.int32)
        count = self._lib.yabpe_pretok_word_ids_specials(
            self._h, data, n, self._special_bytes, self._special_lens,
            self._n_specials, _i32p(out), n,
        )
        return out[:count]

    def export_words(self) -> list[bytes]:
        """The unique words in insertion (id) order."""
        words, lens, _ = self.export()
        out: list[bytes] = []
        off = 0
        for length in lens.tolist():
            out.append(words[off : off + length])
            off += length
        return out

    def add_table(self, blob: bytes, lens: np.ndarray, counts: np.ndarray) -> None:
        """Fold in a raw exported word table (another process's, in
        ``dist/ingest.py``): its words in order, each with its count."""
        assert self._h is not None
        lens = np.ascontiguousarray(lens, dtype=np.int32)
        counts = np.ascontiguousarray(counts, dtype=np.int64)
        self._lib.yabpe_counter_add_table(
            self._h, blob, _i32p(lens), counts.ctypes.data_as(_P_I64), len(lens)
        )

    def merge(self, other: "NativeCounter") -> None:
        assert self._h is not None and other._h is not None
        self._lib.yabpe_counter_merge(self._h, other._h)

    def export(self) -> tuple[bytes, np.ndarray, np.ndarray]:
        """(concatenated word bytes, lengths int32, counts int64)."""
        assert self._h is not None
        n = self._lib.yabpe_counter_unique(self._h)
        total = self._lib.yabpe_counter_total_bytes(self._h)
        words = ctypes.create_string_buffer(max(int(total), 1))
        lens = np.empty(max(int(n), 1), dtype=np.int32)
        counts = np.empty(max(int(n), 1), dtype=np.int64)
        self._lib.yabpe_counter_export(
            self._h, words, _i32p(lens), counts.ctypes.data_as(_P_I64)
        )
        return words.raw[: int(total)], lens[: int(n)], counts[: int(n)]

    def close(self) -> None:
        if self._h is not None:
            self._lib.yabpe_counter_free(self._h)
            self._h = None

    def __del__(self) -> None:
        try:
            self.close()
        except Exception:
            pass


__all__ = [
    "NativeBuildError",
    "NativeCounter",
    "NativeEncoder",
    "available",
    "find_specials",
    "load",
    "pretok_offsets",
    "train_host_raw",
    "utf8_invalid_at",
]
