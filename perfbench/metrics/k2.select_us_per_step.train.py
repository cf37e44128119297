"""Microseconds of K2's select (bound passes and verifies, by the step kernel's own timer) a
live step, over the window's trainings: the program's counters ``k2.select_ns`` over
``k2.steps``."""

from spans import counter_sum, trainings


def read(rec):
    runs = trainings(rec)
    steps, ns = counter_sum(runs, "k2.steps"), counter_sum(runs, "k2.select_ns")
    return ns / steps / 1000.0 if steps and ns is not None else None
