"""The readers of the program's spans and counters (``spans.py`` and its metrics), on
synthetic spans and device intervals, against values computed by hand."""

import sys
import types

import pytest
from conftest import ROOT

import run
import spans

MS = 1_000_000
S = 1000 * MS


def _span(sid, name, train, start, end, parent=None, **attrs):
    return {"name": name, "id": sid, "parent": parent, "train": train, "start_ns": start,
            "end_ns": end, "thread": 1, "attrs": attrs}


def _training(root, t0, route, ingest, workers, chunks):
    """A training's spans: ``route`` and ``ingest`` map a step to seconds, laid end to end
    from ``t0``; ``chunks`` gives yabpe.route.chunks' interval."""
    out = [_span(root, "yabpe.train", root, t0, t0 + 100 * S)]
    t, sid = t0, root
    for name, sec in list(ingest.items()) + list(route.items()):
        sid += 1
        out.append(_span(sid, name, root, t, t + int(sec * S), parent=root))
        t += int(sec * S)
    for i, sec in enumerate(workers):
        sid += 1
        out.append(_span(sid, "yabpe.ingest.worker", root, t0, t0 + int(sec * S), worker=i))
    sid += 1
    out.append(_span(sid, "yabpe.route.chunks", root, *chunks, parent=root))
    return out


TRAIN_A = _training(
    1, 0, {"yabpe.route.counter": 1.0, "yabpe.route.wordtable": 2.0, "yabpe.route.state": 0.5,
           "yabpe.route.decode": 0.25},
    {"yabpe.ingest.scan": 0.5, "yabpe.ingest.fold": 0.125}, [1.0, 1.0, 2.0], (0, 100 * MS))
TRAIN_B = _training(
    20, 1000 * S, {"yabpe.route.counter": 2.0, "yabpe.route.wordtable": 4.0,
                   "yabpe.route.state": 1.5, "yabpe.route.decode": 0.75},
    {"yabpe.ingest.scan": 1.5, "yabpe.ingest.fold": 0.375}, [3.0, 3.0], (200 * MS, 300 * MS))
COUNTERS = {1: {"k2.steps": 100, "k2.rows_verified": 2500, "k2.select_ns": 300_000},
            20: {"k2.steps": 300, "k2.rows_verified": 4500, "k2.select_ns": 900_000},
            0: {"k2.steps": 10**6}}  # outside any training: never read
DEVICE = [(50 * MS, 150 * MS, "step_kernel"),  # half of A's chunks
          (200 * MS, 225 * MS, "apply_kernel"), (210 * MS, 230 * MS, "Memcpy DtoH")]
REC = {"trainings": [{}, {}], "trace": {"device": DEVICE}}


@pytest.fixture
def records(monkeypatch):
    """Put synthetic spans and counters in the tracer's place: an older training from before
    the window (root id -10) and the window's two."""
    old = _training(-10, -5000 * S, {"yabpe.route.counter": 99.0}, {}, [], (0, 1))
    got = {"spans": old + TRAIN_A + TRAIN_B, "counters": dict(COUNTERS)}
    monkeypatch.setattr(spans, "tracer_records", lambda: (got["spans"], got["counters"]))
    return got


def read(name, rec=REC):
    return run.load_reader(ROOT, name)(rec)


@pytest.mark.parametrize("name, want", [
    ("route.counter_s.train", 1.5), ("route.wordtable_s.train", 3.0),
    ("route.state_s.train", 1.0), ("route.decode_s.train", 0.5),
    ("route.chunks_s.train", 0.1), ("ingest.scan_s.train", 1.0), ("ingest.fold_s.train", 0.25),
    # A: 2 over the mean 4/3; B: 3 over 3
    ("ingest.worker_skew.train", (1.5 + 1.0) / 2),
    ("k2.verified_rows_per_step.train", 7000 / 400),
    ("k2.select_us_per_step.train", 1_200_000 / 400 / 1000),
    # A: 50 of 100 ms idle; B: 70 of 100 ms (its kernels overlap)
    ("route.chunks_idle_pct.train", 100 * (50 + 70) / 200),
])
def test_each_reader_against_a_hand_computed_value(records, name, want):
    assert read(name) == pytest.approx(want, rel=1e-12)


def test_only_the_windows_trainings_are_read(records):
    rec = {**REC, "trainings": [{}]}
    assert read("route.counter_s.train", rec) == pytest.approx(2.0)
    assert read("k2.select_us_per_step.train", rec) == pytest.approx(3.0)
    assert read("route.chunks_idle_pct.train", rec) == pytest.approx(70.0)


def test_idle_share_of_a_span_half_covered_by_a_kernel():
    assert spans.idle_pct([(0, 100)], [(50, 150)]) == pytest.approx(50.0)
    assert spans.idle_pct([(0, 100), (50, 120)], [(-10, 10), (60, 70), (65, 80)]) \
        == pytest.approx(100 * (120 - 10 - 20) / 120)
    assert spans.idle_pct([], [(0, 1)]) is None


def test_a_wrapped_select_timer_reads_as_its_difference(records):
    """K2's STAT_NS_* slots are int32s that wrap: the program takes each difference
    modulo 2^32, so a chunk that crosses the wrap still reads its own nanoseconds."""
    from yabpe_tpu_torch.kernels import hbm_loop
    from yabpe_tpu_torch.train import hbm_driver

    before, after = [0] * hbm_loop.N_STATS, [0] * hbm_loop.N_STATS
    bound = hbm_loop.STAT_NS_BOUND
    before[bound], after[bound] = 2**31 - 400_000, -(2**31) + 200_000
    before[hbm_loop.STAT_NS_VERIFY], after[hbm_loop.STAT_NS_VERIFY] = -5, 299_995
    done0, done1 = [0] * hbm_loop.N_SCALARS, [0] * hbm_loop.N_SCALARS
    done1[hbm_loop.NUM_DONE] = 300
    got = hbm_driver.k2_counters((done0, before), (done1, after))
    assert got["k2.select_ns"] == 900_000 and got["k2.steps"] == 300
    records["counters"][20] = {**COUNTERS[20], **got}
    assert read("k2.select_us_per_step.train") == pytest.approx(1_200_000 / 400 / 1000)


def test_a_program_without_the_tracer_reads_as_nothing(monkeypatch):
    """A port whose utils/profiling.py has no tracer (one older than it): no reader raises."""
    bare = types.ModuleType("yabpe_tpu_torch.utils.profiling")
    monkeypatch.setitem(sys.modules, "yabpe_tpu_torch.utils.profiling", bare)
    import yabpe_tpu_torch.utils

    monkeypatch.setattr(yabpe_tpu_torch.utils, "profiling", bare, raising=False)
    assert spans.tracer_records() is None
    names = ["route.counter_s.train", "route.wordtable_s.train", "route.state_s.train",
             "route.chunks_s.train", "route.decode_s.train", "route.chunks_idle_pct.train",
             "ingest.scan_s.train", "ingest.fold_s.train", "ingest.worker_skew.train",
             "k2.verified_rows_per_step.train", "k2.select_us_per_step.train"]
    for name in names:
        assert read(name) is None, name


def test_no_traced_training_reads_as_nothing(monkeypatch):
    monkeypatch.setattr(spans, "tracer_records", lambda: ([], {}))
    assert spans.trainings({"trainings": [{}]}) is None
    assert read("route.counter_s.train") is None
    assert read("k2.verified_rows_per_step.train") is None
