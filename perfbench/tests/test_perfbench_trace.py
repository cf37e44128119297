"""The reduction of a device trace to busy time, kernels and idle gaps."""

import devtrace
from devtrace import Event


def test_reduce_unions_device_time_and_names_the_gaps():
    ms = 1_000_000
    events = [
        Event(devtrace.WINDOW, False, 0, 100 * ms, "user_annotation"),
        Event("train#0", False, 0, 60 * ms, "user_annotation"),
        Event("train#1", False, 60 * ms, 100 * ms, "user_annotation"),
        Event("aten::copy_", False, 70 * ms, 75 * ms, ""),
        Event("void (anonymous namespace)::step_kernel(int*)", True, 10 * ms, 30 * ms, ""),
        Event("apply_kernel(int*)", True, 20 * ms, 40 * ms, ""),  # overlaps the step
        Event("Memcpy HtoD", True, 95 * ms, 105 * ms, ""),  # cut at the window's end
        Event("before", True, -5 * ms, -1 * ms, ""),  # outside the window
        Event("train#0", True, 5 * ms, 50 * ms, "user_annotation"),  # the card's copy
    ]
    r = devtrace.reduce(events)
    assert r["window_s"] == 0.1
    assert abs(r["busy_s"] - 0.035) < 1e-12
    # the union of the two overlapping kernels, not the sum of their times
    assert abs(devtrace.kernel_seconds(r, ("step_kernel", "apply_kernel")) - 0.03) < 1e-12
    assert abs(devtrace.kernel_seconds(r, ("apply_kernel",)) - 0.02) < 1e-12
    assert devtrace.kernel_seconds(r, ("fused_kernel",)) is None
    assert r["calls"] == ["train#0", "train#1"]
    (g0, s0), (g1, s1) = r["idle_gaps"]
    assert abs(s0 - 0.055) < 1e-12 and g0 == "train#1: host code outside torch"
    assert abs(s1 - 0.01) < 1e-12 and g1 == "train#0: host code outside torch"
    gap = devtrace.reduce(events + [Event("aten::empty", False, 66 * ms, 68 * ms, "")])["idle_gaps"]
    assert gap[0][0] == "train#1: aten::empty"
    assert r["device_ops"][0][0].startswith("void (anonymous namespace)::step_kernel")
