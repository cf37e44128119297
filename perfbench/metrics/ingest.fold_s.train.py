"""Mean seconds a training spends in the program's span ``yabpe.ingest.fold``: the workers'
counters folded into one and exported, on one thread."""

from spans import mean_span_s


def read(rec):
    return mean_span_s(rec, "yabpe.ingest.fold")
