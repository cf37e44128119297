"""Profiling utilities: torch.profiler traces and step metric counters.

Counterpart of yabpe_tpu/utils/profiling.py: :func:`maybe_trace` records
a region with ``torch.profiler`` (CPU activity, and CUDA activity where a
card is present) and writes it as a Chrome trace (``chrome://tracing``,
Perfetto) into ``trace_dir``; :class:`StepMetrics` is the JAX module's,
as it is.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from pathlib import Path


@contextlib.contextmanager
def maybe_trace(trace_dir: str | None):
    """Record a region with torch.profiler when ``trace_dir`` is set, and
    write ``trace_dir/trace.json``."""
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
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(out / "trace.json"))


@dataclass
class StepMetrics:
    """Accumulates named phase timings and byte counts."""

    phases: dict[str, float] = field(default_factory=dict)
    counters: dict[str, float] = field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.phases[name] = self.phases.get(name, 0.0) + (
                time.perf_counter() - t0
            )

    def add(self, name: str, value: float) -> None:
        self.counters[name] = self.counters.get(name, 0.0) + value

    def throughput(self, bytes_counter: str, phase: str) -> float:
        secs = self.phases.get(phase, 0.0)
        return self.counters.get(bytes_counter, 0.0) / max(secs, 1e-9)

    def as_dict(self) -> dict[str, float]:
        out = {f"seconds/{k}": v for k, v in self.phases.items()}
        out.update({f"count/{k}": v for k, v in self.counters.items()})
        return out


__all__ = ["maybe_trace", "StepMetrics"]
