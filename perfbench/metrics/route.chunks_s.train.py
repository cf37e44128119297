"""Mean seconds a training spends in the program's span ``yabpe.route.chunks``:
``hbm_driver.run_chunks`` whole, K2's launches with a host sync a chunk and the record's copy."""

from spans import mean_span_s


def read(rec):
    return mean_span_s(rec, "yabpe.route.chunks")
