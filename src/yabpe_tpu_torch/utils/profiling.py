"""Profiling: the in-process tracer of the training path, and its exporter.

The tracer is on only while a ``torch.profiler`` session records; there
is no other switch. Off, :func:`span` costs one attribute read and a
branch and records nothing, and :func:`count` adds nothing. On:

- ``with span(name, **attrs) as s:`` records the span's name, start and
  end, its parent (the innermost open span of this thread, or ``parent=``,
  the record a ``with span(...)`` gave, for a span on a worker thread) and
  ``train``, the id of its root span: every span under one
  ``yabpe.train`` (one ``BBPETrainer.train`` call) shares that id. On the
  main thread a span also opens a ``torch.profiler.record_function`` of
  its name, so it lands in the profiler's trace beside the kernels; its
  start and end are stamped around that range on the trace's clock
  (``time.time_ns``, which kineto's events are given in). Worker threads'
  ranges are not recorded by the profiler: their spans live here only.
- ``count(name, n)`` adds to a counter of the innermost open span's
  training.

:func:`spans` and :func:`counters` read what was recorded without
clearing it. The store holds at most ``MAX_SPANS`` spans and counts what
it drops (:func:`dropped`). Span names are ``yabpe.*`` and hold no ``#``.

:func:`maybe_trace` records a region with ``torch.profiler`` (CPU
activity, and CUDA activity where a card is present) and writes it as a
Chrome trace (``chrome://tracing``, Perfetto) into ``trace_dir``, with the
tracer's spans and counters of the region beside it (``spans.json``).
"""

from __future__ import annotations

import contextlib
import itertools
import json
import threading
import time
from pathlib import Path

import torch.autograd.profiler as _autograd_profiler

#: Spans kept in memory; past it a span is dropped and counted.
MAX_SPANS = 1_000_000


#: The span of a tracer that is off: records nothing, gives None.
_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("tracer", "rec", "range")

    def __init__(self, tracer: Tracer, rec: dict) -> None:
        self.tracer, self.rec, self.range = tracer, rec, None

    def __enter__(self) -> dict:
        self.rec["start_ns"] = time.time_ns()
        if threading.current_thread() is threading.main_thread():
            from torch.profiler import record_function

            self.range = record_function(self.rec["name"])
            self.range.__enter__()
        self.tracer._stack().append(self.rec)
        return self.rec

    def __exit__(self, *exc) -> bool:
        self.tracer._stack().pop()
        if self.range is not None:
            self.range.__exit__(*exc)
        self.rec["end_ns"] = time.time_ns()
        self.tracer._keep(self.rec)
        return False


class Tracer:
    """Spans and counters of the running process, kept in memory."""

    def __init__(self, max_spans: int = MAX_SPANS) -> None:
        self.max_spans = max_spans
        self._spans: list[dict] = []
        self._counters: dict[int, dict[str, int]] = {}
        self._dropped = 0
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        self._local = threading.local()

    def _stack(self) -> list[dict]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def span(self, name: str, parent: dict | None = None, **attrs):
        """A context manager that records ``name`` while the profiler
        records; gives the span's record (None when off)."""
        if not _autograd_profiler._is_profiler_enabled:
            return _OFF
        if parent is None:
            stack = self._stack()
            parent = stack[-1] if stack else None
        span_id = next(self._ids)
        rec = {
            "name": name, "id": span_id,
            "parent": parent["id"] if parent else None,
            "train": parent["train"] if parent else span_id,
            "thread": threading.get_ident(), "attrs": attrs,
        }
        return _Span(self, rec)

    def count(self, name: str, n: int) -> None:
        """Add ``n`` to the counter ``name`` of the open training."""
        if not _autograd_profiler._is_profiler_enabled:
            return
        stack = self._stack()
        train = stack[-1]["train"] if stack else 0
        with self._lock:
            mine = self._counters.setdefault(train, {})
            mine[name] = mine.get(name, 0) + int(n)

    def _keep(self, rec: dict) -> None:
        with self._lock:
            if len(self._spans) < self.max_spans:
                self._spans.append(rec)
            else:
                self._dropped += 1

    def spans(self) -> list[dict]:
        """The closed spans, oldest end first (not cleared)."""
        with self._lock:
            return list(self._spans)

    def counters(self) -> dict[int, dict[str, int]]:
        """Counters by training id (0: outside any span; not cleared)."""
        with self._lock:
            return {k: dict(v) for k, v in self._counters.items()}

    def dropped(self) -> int:
        return self._dropped


def enabled() -> bool:
    """Whether the tracer is on: a torch.profiler session records."""
    return _autograd_profiler._is_profiler_enabled


_TRACER = Tracer()
span = _TRACER.span
count = _TRACER.count
spans = _TRACER.spans
counters = _TRACER.counters
dropped = _TRACER.dropped


@contextlib.contextmanager
def maybe_trace(trace_dir: str | None):
    """Record a region with torch.profiler when ``trace_dir`` is set, and
    write ``trace_dir/trace.json`` and the tracer's spans and counters of
    the region, worker threads' spans included, to
    ``trace_dir/spans.json``."""
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(trace_dir)
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.time_ns()
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(out / "trace.json"))
    mine = [s for s in spans() if s["start_ns"] >= t0]
    trains = {s["train"] for s in mine}
    (out / "spans.json").write_text(json.dumps({
        "spans": mine,
        "counters": {str(k): v for k, v in counters().items() if k in trains},
        "dropped": dropped(),
    }))


__all__ = [
    "MAX_SPANS", "Tracer", "count", "counters", "dropped", "enabled", "maybe_trace", "span",
    "spans",
]
