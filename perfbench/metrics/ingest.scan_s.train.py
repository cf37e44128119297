"""Mean seconds a training spends in the program's span ``yabpe.ingest.scan``: the native
scanner's threads, from the first submit until every worker has returned."""

from spans import mean_span_s


def read(rec):
    return mean_span_s(rec, "yabpe.ingest.scan")
