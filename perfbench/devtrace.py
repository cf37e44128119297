"""The device trace of a ``--trace 1`` run, from ``torch.profiler``, reduced.

The harness wraps its window in a user annotation named ``WINDOW`` and
each call it makes into the program in one named after the call
(``train#3``). ``reduce`` turns the raw events into:

- ``window_s``: the annotated window's length;
- ``busy_s``: the union of the intervals in which a kernel, copy or
  memset ran on the card, inside the window;
- ``kernels``: device seconds by name (every device operation), and
  ``device``, the operations' (start, end, name) in the window;
- ``calls``: the annotations of the harness's calls, in order;
- ``idle_gaps``: the longest gaps with nothing on the card, each named by
  the call and the innermost host operation that covered its middle.
"""

from __future__ import annotations

import re
from collections import defaultdict

WINDOW = "perfbench.window"
# K2 (csrc/hbm_loop.cu): its kernels, by the identifiers in their names
K2_KERNELS = ("step_kernel", "apply_kernel")


class Event:
    __slots__ = ("name", "on_device", "start", "end", "kind")

    def __init__(self, name: str, on_device: bool, start: int, end: int, kind: str) -> None:
        self.name, self.on_device, self.start, self.end, self.kind = name, on_device, start, end, kind


def start():
    from torch.profiler import ProfilerActivity, profile

    import torch

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def stop(prof) -> list[Event]:
    """Stop the profiler and read its events without building PyTorch's
    per-event tables, which take minutes at a million kernels."""
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    results = prof.profiler.kineto_results
    out = []
    for e in results.events():
        dev = str(e.device_type()).endswith("CUDA")
        s = e.start_ns()
        kind = "user_annotation" if e.is_user_annotation() else ""
        out.append(Event(e.name(), dev, s, s + e.duration_ns(), kind))
    return out


def _union(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    merged: list[list[int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def _short(name: str, n: int = 80) -> str:
    return name if len(name) <= n else name[: n - 3] + "..."


def reduce(events: list[Event], top: int = 10) -> dict:
    windows = [e for e in events if e.name == WINDOW and not e.on_device]
    if not windows:
        raise RuntimeError("the trace holds no window annotation")
    w0, w1 = windows[0].start, windows[0].end
    # the card's own copies of the harness's annotations are not work
    device = [(max(e.start, w0), min(e.end, w1), e.name) for e in events
              if e.on_device and e.kind != "user_annotation" and e.end > w0 and e.start < w1]
    busy = _union([(s, e) for s, e, _ in device if e > s])
    kernels: dict[str, float] = defaultdict(float)
    for s, e, name in device:
        kernels[name] += (e - s) / 1e9

    host = sorted((e for e in events if not e.on_device and e.name != WINDOW
                   and e.end > w0 and e.start < w1), key=lambda e: e.start)
    calls = [e for e in host if e.kind == "user_annotation" and "#" in e.name]
    gaps = []
    edge = w0
    for s, e in busy + [(w1, w1)]:
        if s > edge:
            gaps.append((edge, s))
        edge = max(edge, e)
    gaps.sort(key=lambda g: g[0] - g[1])
    idle = []
    for g0, g1 in gaps[:top]:
        mid = (g0 + g1) // 2
        cover = [e for e in host if e.start <= mid < e.end]
        call = next((e.name for e in cover if e in calls), "between calls")
        ops = [e for e in cover if e not in calls]
        inner = min(ops, key=lambda e: e.end - e.start).name if ops else "host code outside torch"
        idle.append([f"{call}: {_short(inner, 60)}", (g1 - g0) / 1e9])
    busy_s = sum(e - s for s, e in busy) / 1e9
    ops = sorted(kernels.items(), key=lambda kv: -kv[1])
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": busy_s,
        "kernels": dict(kernels),
        "device": device,
        "calls": [c.name for c in calls],
        "device_ops": [[_short(n), s] for n, s in ops[:top]],
        "idle_gaps": idle,
    }


def kernel_seconds(trace: dict | None, names) -> float | None:
    """Device seconds in which a kernel named by one of ``names`` ran: an
    identifier of the kernel's (demangled) name, whatever its namespace,
    template arguments or parameters. The union of their intervals, since
    a kernel launched with programmatic dependent launch starts before
    the one it waits for has ended."""
    if not trace:
        return None
    wanted = set(names)
    mine: dict[str, bool] = {}
    spans = []
    for s, e, name in trace["device"]:
        hit = mine.get(name)
        if hit is None:
            hit = mine[name] = bool(wanted & set(re.findall(r"\w+", name)))
        if hit:
            spans.append((s, e))
    return sum(e - s for s, e in _union(spans)) / 1e9 if spans else None
