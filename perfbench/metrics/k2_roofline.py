"""K2's share of its roofline: the least time for the bytes that these inputs
need (counted by the plain reference, reference/train.py's ``k2_bytes``) at
the HBM peak, over K2's device time per training. Bound by bytes."""

from devtrace import K2_KERNELS, kernel_seconds
from roofline import bytes_roofline_pct


def read(rec):
    runs = rec.get("trainings") or []
    s = kernel_seconds(rec.get("trace"), K2_KERNELS)
    nbytes = (rec.get("reference") or {}).get("k2_bytes")
    if not s or not runs or not nbytes:
        return None
    return bytes_roofline_pct(nbytes, s / len(runs))
