"""Mean seconds a training spends in the program's span ``yabpe.route.decode``:
``merges_to_bytes``, the merge record turned into byte pairs."""

from spans import mean_span_s


def read(rec):
    return mean_span_s(rec, "yabpe.route.decode")
