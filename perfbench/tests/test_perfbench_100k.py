"""The deepseek-llm-100k configuration and its cell in BENCHMARK.json, and the readers of K2's
bound and vocabulary counters (``k2.bound_ns``, ``k2.vocab_ns``) on synthetic spans against
values computed by hand."""

import json

import pytest
from conftest import ROOT
from test_perfbench_spans import COUNTERS, REC, TRAIN_A, TRAIN_B, read

import run
import spans

CELL = "deepseek-llm-100k.train"
NEW = ["k2.bound_us_per_step.train", "k2.vocab_us_per_step.train"]
OLD_K2 = ("k2.steps", "k2.rows_verified", "k2.select_ns")
WITH_NEW = {1: {**COUNTERS[1], "k2.bound_ns": 120_000, "k2.vocab_ns": 500_000},
            20: {**COUNTERS[20], "k2.bound_ns": 280_000, "k2.vocab_ns": 1_100_000}}


@pytest.fixture(scope="module")
def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.fixture
def records(monkeypatch):
    """The window's two trainings of test_perfbench_spans, their counters holding the new two."""
    got = {"spans": TRAIN_A + TRAIN_B, "counters": {**COUNTERS, **WITH_NEW}}
    monkeypatch.setattr(spans, "tracer_records", lambda: (got["spans"], got["counters"]))
    return got


def test_the_100k_configuration_and_its_cell(bench):
    """DeepSeek LLM's tokenizer: 100,001 ids (256 bytes, 99,744 merges, one special) over
    owt-32k's corpus, every cut under ``reduced``, and its cell in every list of the metrics
    that read the device route and K2 (route.counter_s.train's span is gone)."""
    entry = next(c for c in bench["configs"] if c["name"] == "deepseek-llm-100k")
    config = json.loads((ROOT / entry["file"]).read_text())
    owt = json.loads((ROOT / "perfbench" / "configs" / "owt-32k.json").read_text())
    assert config["trainer"] == {"vocab_size": 100_001, "special_tokens": ["<|endoftext|>"],
                                 "min_frequency": 1}
    assert config["corpus"] == owt["corpus"]
    assert set(entry["reduced"]) == set(config["reduced"]) == {"corpus_bytes", "special_tokens"}
    assert "2401.02954" in entry["source"] and "2401.02954" in config["source"]
    (w,) = [w for w in bench["workloads"] if w["name"] == CELL]
    assert (w["config"], w["traffic"], w["chips"]) == ("deepseek-llm-100k", "train", 1)
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert CELL in e2e["train_bytes_per_s"]["workloads"]
    for m in bench["per_layer"]:
        if m["name"] == "route.counter_s.train":
            assert CELL not in m["workloads"]
        else:
            assert CELL in m["workloads"], m["name"]
    _, _, _, metrics = run.load_cell(ROOT, CELL)
    names = {m["name"] for m in metrics["per_layer"]}
    assert {"k2_roofline", "k2.device_ms.train", *NEW} <= names


@pytest.mark.parametrize("name, want", [
    ("k2.bound_us_per_step.train", 400_000 / 400 / 1000),
    ("k2.vocab_us_per_step.train", 1_600_000 / 400 / 1000),
])
def test_each_new_reader_against_a_hand_computed_value(records, name, want):
    assert read(name) == pytest.approx(want, rel=1e-12)


def test_only_the_windows_trainings_are_read_by_the_new_readers(records):
    rec = {**REC, "trainings": [{}]}
    assert read("k2.bound_us_per_step.train", rec) == pytest.approx(280_000 / 300 / 1000)
    assert read("k2.vocab_us_per_step.train", rec) == pytest.approx(1_100_000 / 300 / 1000)


@pytest.mark.parametrize("name", NEW)
def test_a_program_without_the_new_counters_reads_as_nothing(records, name):
    """A port whose K2 publishes only k2.steps, k2.rows_verified and k2.select_ns (one older
    than k2.bound_ns and k2.vocab_ns): the new readers give nothing, the old ones still read."""
    for t in (1, 20):
        records["counters"][t] = {k: v for k, v in COUNTERS[t].items() if k in OLD_K2}
    assert read(name) is None
    assert read("k2.select_us_per_step.train") == pytest.approx(1_200_000 / 400 / 1000)


@pytest.mark.parametrize("name", NEW)
def test_no_tracer_or_no_traced_training_reads_as_nothing(monkeypatch, name):
    monkeypatch.setattr(spans, "tracer_records", lambda: None)
    assert read(name) is None
    monkeypatch.setattr(spans, "tracer_records", lambda: ([], {}))
    assert read(name) is None


def test_the_new_counters_from_the_programs_stats(records):
    """k2.bound_ns is the bound passes' slot and k2.vocab_ns the compare's and the vocab
    update's, each taken modulo 2^32 like k2.select_ns, and the readers divide them by the
    live steps."""
    from yabpe_tpu_torch.kernels import hbm_loop
    from yabpe_tpu_torch.train import hbm_driver

    before, after = [0] * hbm_loop.N_STATS, [0] * hbm_loop.N_STATS
    before[hbm_loop.STAT_NS_BOUND], after[hbm_loop.STAT_NS_BOUND] = 2**31 - 100_000, -(2**31) + 180_000
    before[hbm_loop.STAT_NS_COMPARE], after[hbm_loop.STAT_NS_COMPARE] = 5, 600_005
    before[hbm_loop.STAT_NS_VOCAB], after[hbm_loop.STAT_NS_VOCAB] = -(2**31), -(2**31) + 500_000
    done0, done1 = [0] * hbm_loop.N_SCALARS, [0] * hbm_loop.N_SCALARS
    done1[hbm_loop.NUM_DONE] = 300
    got = hbm_driver.k2_counters((done0, before), (done1, after))
    assert got["k2.bound_ns"] == 280_000 and got["k2.vocab_ns"] == 1_100_000
    records["counters"][20] = {**WITH_NEW[20], **got}
    assert read("k2.bound_us_per_step.train") == pytest.approx(400_000 / 400 / 1000)
    assert read("k2.vocab_us_per_step.train") == pytest.approx(1_600_000 / 400 / 1000)
