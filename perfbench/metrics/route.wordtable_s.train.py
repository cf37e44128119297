"""Mean seconds a training spends in the program's span ``yabpe.route.wordtable``:
``WordTable.from_counter``, the Counter turned into the padded numpy word table."""

from spans import mean_span_s


def read(rec):
    return mean_span_s(rec, "yabpe.route.wordtable")
