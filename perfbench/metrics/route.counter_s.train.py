"""Mean seconds a training spends in the program's span ``yabpe.route.counter``:
``counter_from_raw``, the exported word table turned into a Counter of byte strings."""

from spans import mean_span_s


def read(rec):
    return mean_span_s(rec, "yabpe.route.counter")
