"""Host-memory tuning for lazily-provisioned hosts.

Counterpart of yabpe_tpu/utils/hostmem.py. Some VM hosts provide
anonymous memory lazily at slow first-touch rates; glibc by default mmaps
large allocations and returns them to the OS on free, so every fresh
numpy array re-pays the first-touch cost. Two counters:

- :func:`tune_malloc` keeps freed memory in the glibc arena (no mmap for
  large allocations, never trim), so pages fault at most once per process.
- :func:`warm_heap` pre-faults arena pages through a single
  ``MADV_HUGEPAGE``-hinted block, which is faster than faulting the same
  memory 4 KiB at a time later.

Both are no-ops when glibc is unavailable and can be disabled with
``YABPE_NO_MALLOC_TUNE=1``.
"""

from __future__ import annotations

import ctypes
import os
import threading

_M_TRIM_THRESHOLD = -1
_M_MMAP_MAX = -4
_M_ARENA_MAX = -8
_MADV_HUGEPAGE = 14
_HUGE_PAGE = 2 * 1024 * 1024

_lock = threading.Lock()
_tuned = False
_warmed_bytes = 0


def _libc() -> ctypes.CDLL | None:
    try:
        return ctypes.CDLL("libc.so.6", use_errno=True)
    except OSError:
        return None


def tune_malloc() -> bool:
    """Route large allocations through the arena and never trim it.

    Idempotent and cheap. Opt-in from bulk entry points only (the
    trainer), deliberately NOT at package import, so host applications
    that merely import yabpe_tpu_torch keep glibc's default allocator
    behavior. Returns True when the tuning was applied.
    """
    global _tuned
    if _tuned:
        return True
    if os.environ.get("YABPE_NO_MALLOC_TUNE"):
        return False
    with _lock:
        if _tuned:
            return True
        libc = _libc()
        if libc is None or not hasattr(libc, "mallopt"):
            return False
        libc.mallopt(_M_MMAP_MAX, 0)
        libc.mallopt(_M_TRIM_THRESHOLD, 1 << 31)
        # Single arena: worker threads reuse the main arena's already-
        # faulted pages instead of growing private mmap'd heaps. Our hot
        # paths allocate rarely (tables grow by doubling), so arena lock
        # contention is negligible.
        libc.mallopt(_M_ARENA_MAX, 1)
        _tuned = True
        return True


def warm_heap(mb: int) -> int:
    """Pre-fault ``mb`` MiB of arena heap (huge-page hinted), then free it
    back into the arena so later large allocations reuse warm pages.

    The warmed amount is cumulative: asking for no more than is already
    warm is a no-op. Returns the number of bytes newly faulted.
    """
    global _warmed_bytes
    if os.environ.get("YABPE_NO_MALLOC_TUNE"):
        return 0
    if not tune_malloc():
        return 0
    want = mb * 1024 * 1024
    with _lock:
        if want <= _warmed_bytes:
            return 0
        n = want - _warmed_bytes
        libc = _libc()
        assert libc is not None
        libc.malloc.restype = ctypes.c_void_p
        ptr = libc.malloc(ctypes.c_size_t(n))
        if not ptr:
            return 0
        aligned = (ptr + _HUGE_PAGE - 1) // _HUGE_PAGE * _HUGE_PAGE
        tail = n - (aligned - ptr)
        if tail > 0:
            libc.madvise(
                ctypes.c_void_p(aligned), ctypes.c_size_t(tail), _MADV_HUGEPAGE,
            )
        libc.memset(ctypes.c_void_p(ptr), 0, ctypes.c_size_t(n))
        libc.free(ctypes.c_void_p(ptr))
        _warmed_bytes = want
        return n


__all__ = ["tune_malloc", "warm_heap"]
