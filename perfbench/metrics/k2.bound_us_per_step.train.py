"""Microseconds of K2's bound passes (the select's pass over row_max and lex_rank of every live
row, by the step kernel's own timer) a live step, over the window's trainings: the program's
counters ``k2.bound_ns`` over ``k2.steps``. Its work grows with the vocabulary."""

from spans import counter_sum, trainings


def read(rec):
    runs = trainings(rec)
    steps, ns = counter_sum(runs, "k2.steps"), counter_sum(runs, "k2.bound_ns")
    return ns / steps / 1000.0 if steps and ns is not None else None
