"""The program's own spans and counters, grouped by training.

The port's tracer (``yabpe_tpu_torch/utils/profiling.py``) records while
``torch.profiler`` records, so a ``--trace 1`` run's window fills it: per
``BBPETrainer.train`` call one ``yabpe.train`` span, the spans under it
(each with that span's id as ``train``) and K2's counters. The readers of
``metrics/`` take them from the tracer's memory in this process, after the
window. A program without the tracer gives nothing, and every reader then
returns None.
"""

from __future__ import annotations


def tracer_records():
    """(spans, counters by training id) from the program's tracer, or None
    where the program has none."""
    try:
        from yabpe_tpu_torch.utils import profiling

        return profiling.spans(), profiling.counters()
    except (ImportError, AttributeError):
        return None


def trainings(rec: dict) -> list[dict] | None:
    """One ``{"spans": [...], "counters": {...}}`` per traced training, in
    order: the last as many as the window ran (``rec["trainings"]``), or
    None."""
    got = tracer_records()
    if got is None:
        return None
    spans, counters = got
    by_train: dict[int, list[dict]] = {}
    for s in spans:
        by_train.setdefault(s["train"], []).append(s)
    roots = sorted(s["id"] for s in spans if s["name"] == "yabpe.train" and s["id"] == s["train"])
    n = len(rec.get("trainings") or roots)
    runs = [{"spans": by_train[t], "counters": counters.get(t, {})} for t in roots[-n:]] if n else []
    return runs or None


def seconds(span: dict) -> float:
    return (span["end_ns"] - span["start_ns"]) / 1e9


def mean_span_s(rec: dict, name: str) -> float | None:
    """Mean seconds a training spends in spans named ``name``, over the
    trainings that have one."""
    per = [sum(seconds(s) for s in r["spans"] if s["name"] == name)
           for r in trainings(rec) or [] if any(s["name"] == name for s in r["spans"])]
    return sum(per) / len(per) if per else None


def counter_sum(runs: list[dict] | None, name: str) -> int | None:
    """A counter summed over ``runs``, or None where none has it."""
    have = [r["counters"][name] for r in runs or [] if name in r["counters"]]
    return sum(have) if have else None


def union(intervals) -> list[tuple[int, int]]:
    merged: list[list[int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def idle_pct(intervals, busy) -> float | None:
    """Share of the union of ``intervals`` that the union of ``busy``
    (start, end) pairs leaves uncovered, in percent."""
    spans, busy = union(intervals), union(busy)
    total = sum(e - s for s, e in spans)
    if not total:
        return None
    covered, j = 0, 0
    for s, e in spans:
        while j < len(busy) and busy[j][1] <= s:
            j += 1
        k = j
        while k < len(busy) and busy[k][0] < e:
            covered += min(e, busy[k][1]) - max(s, busy[k][0])
            k += 1
    return 100.0 * (1.0 - covered / total)
