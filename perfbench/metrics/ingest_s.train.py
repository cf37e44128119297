"""Mean ingest seconds of the window's trainings (``last_stats["ingest_seconds"]``):
pretok/ingest.py over the native scanner."""


def read(rec):
    runs = rec.get("trainings") or []
    return sum(r["ingest_s"] for r in runs) / len(runs) if runs else None
