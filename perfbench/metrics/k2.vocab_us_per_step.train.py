"""Microseconds of K2's vocab phases (the dedup compare and lex-rank insertion over every live
id, then the vocab update and the record, by the step kernel's own timer) a live step, over the
window's trainings: the program's counters ``k2.vocab_ns`` over ``k2.steps``. Their work grows
with the vocabulary."""

from spans import counter_sum, trainings


def read(rec):
    runs = trainings(rec)
    steps, ns = counter_sum(runs, "k2.steps"), counter_sum(runs, "k2.vocab_ns")
    return ns / steps / 1000.0 if steps and ns is not None else None
