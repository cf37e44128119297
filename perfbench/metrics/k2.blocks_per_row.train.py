"""Column blocks of 1,024 counts that K2's verify read in full a verified row, over the window's
trainings: the program's counters ``k2.blocks_read`` over ``k2.rows_verified``
(``HbmState.stats``, read at each chunk's sync while tracing). A port whose verify reads whole
rows publishes no ``k2.blocks_read`` and reads as nothing."""

from spans import counter_sum, trainings


def read(rec):
    runs = trainings(rec)
    rows, blocks = counter_sum(runs, "k2.rows_verified"), counter_sum(runs, "k2.blocks_read")
    return blocks / rows if rows and blocks is not None else None
