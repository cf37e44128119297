"""Rows K2's select read exactly a live step, over the window's trainings: the program's
counters ``k2.rows_verified`` over ``k2.steps`` (``HbmState.stats``, read at each chunk's sync
while tracing)."""

from spans import counter_sum, trainings


def read(rec):
    runs = trainings(rec)
    steps, rows = counter_sum(runs, "k2.steps"), counter_sum(runs, "k2.rows_verified")
    return rows / steps if steps and rows is not None else None
