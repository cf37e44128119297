"""Mean seconds a training spends in the program's span ``yabpe.route.state``:
``hbm_driver.admit`` and ``state_from_numpy``, K2's state built on the card, host-to-device
copies included."""

from spans import mean_span_s


def read(rec):
    return mean_span_s(rec, "yabpe.route.state")
