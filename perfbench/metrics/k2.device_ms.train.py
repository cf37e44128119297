"""Device milliseconds of K2 (csrc/hbm_loop.cu) per training, from the trace."""

from devtrace import K2_KERNELS, kernel_seconds


def read(rec):
    runs = rec.get("trainings") or []
    s = kernel_seconds(rec.get("trace"), K2_KERNELS)
    return 1000.0 * s / len(runs) if s and runs else None
