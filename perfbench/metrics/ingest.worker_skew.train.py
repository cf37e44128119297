"""Ingest's imbalance: per training, the slowest ``yabpe.ingest.worker`` span (the program's,
one a scanner thread) over the workers' mean, then averaged over the trainings. 1 is even."""

from spans import seconds, trainings


def read(rec):
    skews = []
    for run in trainings(rec) or []:
        ws = [seconds(s) for s in run["spans"] if s["name"] == "yabpe.ingest.worker"]
        if ws and sum(ws) > 0:
            skews.append(max(ws) * len(ws) / sum(ws))
    return sum(skews) / len(skews) if skews else None
