"""Mean merge seconds of the window's trainings (``last_stats["merge_seconds"]``):
the device route's host set-up, the merge kernel's calls and merges_to_bytes."""


def read(rec):
    runs = rec.get("trainings") or []
    return sum(r["merge_s"] for r in runs) / len(runs) if runs else None
