"""Host-memory tuning for lazily-provisioned hosts.

Counterpart of yabpe_tpu/utils/hostmem.py, cut to :func:`tune_malloc`.
Some VM hosts provide anonymous memory lazily at slow first-touch rates;
glibc by default mmaps large allocations and returns them to the OS on
free, so every fresh numpy array re-pays the first-touch cost.
:func:`tune_malloc` keeps freed memory in the glibc arena (no mmap for
large allocations, never trim), so pages fault at most once per process.
It is a no-op when glibc is unavailable and can be disabled with
``YABPE_NO_MALLOC_TUNE=1``.
"""

from __future__ import annotations

import ctypes
import os
import threading

_M_TRIM_THRESHOLD = -1
_M_MMAP_MAX = -4
_M_ARENA_MAX = -8

_lock = threading.Lock()
_tuned = False


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


__all__ = ["tune_malloc"]
