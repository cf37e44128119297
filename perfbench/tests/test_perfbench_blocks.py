"""The reader of K2's blocks read a verified row (``k2.blocks_per_row.train``) on synthetic
counters against values computed by hand, and its entry in BENCHMARK.json."""

import json

import pytest
from conftest import ROOT
from test_perfbench_spans import COUNTERS, REC, TRAIN_A, TRAIN_B, read

import run
import spans

NAME = "k2.blocks_per_row.train"
CELLS = ["owt-32k.train", "tinystories-10k.train", "deepseek-llm-100k.train"]
WITH_BLOCKS = {1: {**COUNTERS[1], "k2.blocks_read": 3000},
               20: {**COUNTERS[20], "k2.blocks_read": 5400}}


@pytest.fixture
def records(monkeypatch):
    """The window's two trainings of test_perfbench_spans, their counters holding k2.blocks_read."""
    got = {"spans": TRAIN_A + TRAIN_B, "counters": {**COUNTERS, **WITH_BLOCKS}}
    monkeypatch.setattr(spans, "tracer_records", lambda: (got["spans"], got["counters"]))
    return got


def test_the_entry_reads_k2_in_every_training_cell():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (m,) = [m for m in bench["per_layer"] if m["name"] == NAME]
    assert bench["per_layer"][-1] is m  # appended, the accepted entries before it
    k2 = next(x for x in bench["per_layer"] if x["name"] == "k2.bound_us_per_step.train")
    assert (m["unit"], m["better"], m["source"]) == ("blocks", "lower", "program_counter")
    assert (m["layer"], m["moves"]) == (k2["layer"], "train_bytes_per_s")
    assert m["workloads"] == CELLS
    for cell in CELLS:
        _, _, _, metrics = run.load_cell(ROOT, cell)
        assert NAME in {x["name"] for x in metrics["per_layer"]}, cell


def test_a_hand_computed_value(records):
    # blocks over rows verified in both trainings: (3000 + 5400) / (2500 + 4500)
    assert read(NAME) == pytest.approx(8400 / 7000, rel=1e-12)


def test_only_the_windows_trainings_are_read(records):
    assert read(NAME, {**REC, "trainings": [{}]}) == pytest.approx(5400 / 4500, rel=1e-12)


def test_a_program_without_the_counter_reads_as_nothing(records):
    """A port whose verify reads whole rows (one older than k2.blocks_read): the reader gives
    nothing, and the rows-verified reader beside it still reads."""
    records["counters"] = dict(COUNTERS)
    assert read(NAME) is None
    assert read("k2.verified_rows_per_step.train") == pytest.approx(7000 / 400)


def test_no_rows_verified_reads_as_nothing(records):
    for t in (1, 20):
        records["counters"][t] = {"k2.steps": 10, "k2.blocks_read": 0}
    assert read(NAME) is None


def test_no_tracer_or_no_traced_training_reads_as_nothing(monkeypatch):
    monkeypatch.setattr(spans, "tracer_records", lambda: None)
    assert read(NAME) is None
    monkeypatch.setattr(spans, "tracer_records", lambda: ([], {}))
    assert read(NAME) is None


def test_the_counter_from_the_programs_stats(records):
    """k2.blocks_read is the kernel's blocks-read slot, modulo 2^32, and the reader divides it by
    the rows verified."""
    from yabpe_tpu_torch.kernels import hbm_loop
    from yabpe_tpu_torch.train import hbm_driver

    before, after = [0] * hbm_loop.N_STATS, [0] * hbm_loop.N_STATS
    slot = hbm_loop.STAT_BLOCKS_READ
    before[slot], after[slot] = 2**31 - 400, -(2**31) + 5000
    before[hbm_loop.STAT_VERIFIED], after[hbm_loop.STAT_VERIFIED] = 0, 4500
    done0, done1 = [0] * hbm_loop.N_SCALARS, [0] * hbm_loop.N_SCALARS
    done1[hbm_loop.NUM_DONE] = 300
    got = hbm_driver.k2_counters((done0, before), (done1, after))
    assert got["k2.blocks_read"] == 5400 and got["k2.rows_verified"] == 4500
    records["counters"][20] = {**COUNTERS[20], **got}
    assert read(NAME) == pytest.approx(8400 / 7000, rel=1e-12)
