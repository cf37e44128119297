"""The port's tracer (utils/profiling.py) and the spans and counters of a
training.

A training on the device route takes K2's plain twin here (``device="cpu"``,
``use_fused_kernel=False``), in spans small enough that ingest runs on
several worker threads. The file imports neither JAX nor the JAX package;
its CUDA case also runs on a card, without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_tracing.py
"""

from __future__ import annotations

import json
import os
import threading
import time
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from yabpe_tpu_torch import BBPETrainer, BBPETrainerConfig
from yabpe_tpu_torch.core.vocab import Vocab
from yabpe_tpu_torch.kernels import hbm_loop
from yabpe_tpu_torch.pretok import ingest
from yabpe_tpu_torch.train import hbm_driver
from yabpe_tpu_torch.utils import profiling

FILES = [Path(__file__).resolve().parent / "data" / "large.txt"]
SPECIALS = ["<|endoftext|>"]
CHUNK = 4096

#: Every span of a K2 training and its parent's name.
TREE = {
    "yabpe.train": None,
    "yabpe.ingest": "yabpe.train",
    "yabpe.ingest.scan": "yabpe.ingest",
    "yabpe.ingest.worker": "yabpe.ingest.scan",
    "yabpe.ingest.fold": "yabpe.ingest",
    "yabpe.merge": "yabpe.train",
    "yabpe.route.wordtable": "yabpe.merge",
    "yabpe.route.state": "yabpe.merge",
    "yabpe.route.chunks": "yabpe.merge",
    "yabpe.k2.chunk": "yabpe.route.chunks",
    "yabpe.route.decode": "yabpe.merge",
}
ROUTE = ("wordtable", "state", "chunks", "decode")


def _config(device: str = "cpu") -> BBPETrainerConfig:
    return BBPETrainerConfig(
        vocab_size=400, special_tokens=SPECIALS, min_frequency=1, device=device,
        use_fused_kernel=False, chunk_size_bytes=CHUNK, merge_chunk_size=64,
    )


def _workers() -> int:
    tasks = ingest._spans(FILES, CHUNK, False)
    return min(8, os.cpu_count() or 1, len(tasks))


def _training(spans: list[dict]) -> list[dict]:
    """The spans of the last traced training."""
    root = max(s["id"] for s in spans if s["name"] == "yabpe.train")
    return [s for s in spans if s["train"] == root]


@pytest.fixture(scope="module")
def traced():
    """One training under torch.profiler: (trainer, its spans, the
    profiler's events of yabpe.* ranges as (name, start_ns, end_ns))."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer = BBPETrainer(_config())
        trainer.train(FILES)
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events() if e.name().startswith("yabpe.")]
    return trainer, _training(profiling.spans()), events


def test_without_the_profiler_a_training_records_nothing():
    before, counters = len(profiling.spans()), profiling.counters()
    assert not profiling.enabled()
    trainer = BBPETrainer(_config())
    trainer.train(FILES)
    assert trainer.route == "K2"
    assert len(profiling.spans()) == before
    assert profiling.counters() == counters


def test_a_traced_training_records_the_tree(traced):
    trainer, spans, _ = traced
    assert trainer.route == "K2"
    assert {s["name"] for s in spans} == set(TREE)
    by_id = {s["id"]: s for s in spans}
    (root,) = [s for s in spans if s["name"] == "yabpe.train"]
    for s in spans:
        assert s["train"] == root["id"]
        if TREE[s["name"]] is None:
            assert s["parent"] is None
            continue
        parent = by_id[s["parent"]]
        assert parent["name"] == TREE[s["name"]], s
        assert parent["start_ns"] <= s["start_ns"] <= s["end_ns"] <= parent["end_ns"], s
    names = [s["name"] for s in spans]
    for once in set(TREE) - {"yabpe.ingest.worker", "yabpe.k2.chunk"}:
        assert names.count(once) == 1, once
    workers = sorted(s["attrs"]["worker"] for s in spans if s["name"] == "yabpe.ingest.worker")
    assert workers == list(range(_workers())) and len(workers) > 1
    chunks = [s["attrs"]["start"] for s in spans if s["name"] == "yabpe.k2.chunk"]
    assert chunks == list(range(0, 64 * len(chunks), 64)) and len(chunks) > 1


def test_route_spans_account_for_merge_seconds(traced):
    trainer, spans, _ = traced
    route = sum((s["end_ns"] - s["start_ns"]) / 1e9 for s in spans
                if s["name"] in {f"yabpe.route.{r}" for r in ROUTE})
    merge = trainer.last_stats["merge_seconds"]
    assert abs(route - merge) <= 0.05 * merge, (route, merge)
    (ing,) = [s for s in spans if s["name"] == "yabpe.ingest"]
    assert (ing["end_ns"] - ing["start_ns"]) / 1e9 >= trainer.last_stats["ingest_seconds"]


def test_main_thread_spans_are_in_the_profiler_trace_on_its_clock(traced):
    _, spans, events = traced
    main = [s for s in spans if s["thread"] == threading.main_thread().ident]
    assert {s["name"] for s in main} == set(TREE) - {"yabpe.ingest.worker"}
    for name in {s["name"] for s in main}:
        mine = sorted((s["start_ns"], s["end_ns"]) for s in main if s["name"] == name)
        theirs = sorted((s, e) for n, s, e in events if n == name)[-len(mine):]
        assert len(theirs) == len(mine), name
        for (s0, e0), (s1, e1) in zip(mine, theirs):
            assert abs(s0 - s1) < 1_000_000 and abs(e0 - e1) < 1_000_000, (name, s0 - s1, e0 - e1)
    # worker threads' ranges are not recorded: their spans live in memory only
    assert not [n for n, _, _ in events if n == "yabpe.ingest.worker"] or _workers() == 1


def test_span_names_hold_no_hash(traced):
    _, spans, _ = traced
    assert all(s["name"].startswith("yabpe.") and "#" not in s["name"] for s in spans)


def test_the_twin_leaves_k2_counters_absent(traced):
    _, spans, _ = traced
    assert not profiling.counters().get(spans[0]["train"], {})


def test_maybe_trace_writes_spans_beside_the_trace(tmp_path):
    with profiling.maybe_trace(str(tmp_path)):
        BBPETrainer(_config()).train(FILES)
    assert (tmp_path / "trace.json").is_file()
    out = json.loads((tmp_path / "spans.json").read_text())
    names = [s["name"] for s in out["spans"]]
    assert names.count("yabpe.train") == 1 and set(names) == set(TREE)
    assert names.count("yabpe.ingest.worker") == _workers()
    assert out["dropped"] == 0


def test_the_store_is_bounded_and_counts_what_it_drops():
    tracer = profiling.Tracer(max_spans=2)
    with profile(activities=[ProfilerActivity.CPU]):
        with tracer.span("yabpe.a") as a:
            for i in range(3):
                with tracer.span("yabpe.b", i=i):
                    tracer.count("n", 2)
        assert a is not None
    assert [s["name"] for s in tracer.spans()] == ["yabpe.b", "yabpe.b"]
    assert tracer.dropped() == 2
    assert tracer.counters() == {a["id"]: {"n": 6}}
    with tracer.span("yabpe.off") as off:
        tracer.count("n", 1)
    assert off is None and tracer.dropped() == 2 and tracer.counters()[a["id"]] == {"n": 6}


def test_a_worker_span_takes_its_parent_explicitly():
    tracer = profiling.Tracer()
    with profile(activities=[ProfilerActivity.CPU]):
        with tracer.span("yabpe.root") as root:
            with tracer.span("yabpe.child") as child:
                def work():
                    with tracer.span("yabpe.w", parent=child, worker=0):
                        time.sleep(0.001)
                t = threading.Thread(target=work)
                t.start()
                t.join(timeout=30)
            assert not t.is_alive()
    (w,) = [s for s in tracer.spans() if s["name"] == "yabpe.w"]
    assert w["parent"] == child["id"] and w["train"] == root["id"]
    assert w["thread"] != threading.main_thread().ident and w["attrs"] == {"worker": 0}


def test_k2_counters_take_stat_differences_modulo_2_32():
    stats0 = [0] * hbm_loop.N_STATS
    stats1 = [0] * hbm_loop.N_STATS
    stats0[hbm_loop.STAT_NS_BOUND], stats1[hbm_loop.STAT_NS_BOUND] = 2**31 - 100, -(2**31) + 50
    stats0[hbm_loop.STAT_NS_VERIFY], stats1[hbm_loop.STAT_NS_VERIFY] = 10, 30
    stats0[hbm_loop.STAT_VERIFIED], stats1[hbm_loop.STAT_VERIFIED] = 5, 405
    stats0[hbm_loop.STAT_REPLAYED], stats1[hbm_loop.STAT_REPLAYED] = 0, 3
    stats0[hbm_loop.STAT_NS_COMPARE], stats1[hbm_loop.STAT_NS_COMPARE] = 2**31 - 1, -(2**31) + 6
    stats0[hbm_loop.STAT_NS_VOCAB], stats1[hbm_loop.STAT_NS_VOCAB] = 7, 17
    stats0[hbm_loop.STAT_NS_STEP], stats1[hbm_loop.STAT_NS_STEP] = 0, 10**6  # read by none
    stats0[hbm_loop.STAT_BLOCKS_READ], stats1[hbm_loop.STAT_BLOCKS_READ] = 2**31 - 3, -(2**31) + 600
    stats0[hbm_loop.STAT_TIE_ROWS], stats1[hbm_loop.STAT_TIE_ROWS] = -2, 9
    scalars0, scalars1 = [0] * hbm_loop.N_SCALARS, [0] * hbm_loop.N_SCALARS
    scalars0[hbm_loop.NUM_DONE], scalars1[hbm_loop.NUM_DONE] = 100, 150
    got = hbm_driver.k2_counters((scalars0, stats0), (scalars1, stats1))
    assert got == {"k2.steps": 47, "k2.rows_verified": 400, "k2.blocks_read": 603,
                   "k2.tie_rows": 11, "k2.select_ns": 150 + 20, "k2.bound_ns": 150,
                   "k2.vocab_ns": 7 + 10}


@pytest.mark.cuda
def test_k2_counters_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    trainer = BBPETrainer(_config("cuda"))
    trainer.train(FILES)  # build and warm outside the trace
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        trainer = BBPETrainer(_config("cuda"))
        model = trainer.train(FILES)
    assert trainer.route == "K2"
    spans = _training(profiling.spans())
    got = profiling.counters()[spans[0]["train"]]
    assert got["k2.steps"] == len(model.merges)
    assert got["k2.rows_verified"] > 0 and got["k2.select_ns"] > 0
    assert 0 < got["k2.bound_ns"] < got["k2.select_ns"] and got["k2.vocab_ns"] > 0
    assert got["k2.blocks_read"] >= got["k2.rows_verified"]
    # the dedup compare reads a token row only on a prefix-key tie: at each
    # step, a live token longer than 7 bytes whose first 7 bytes are those
    # of a merged string longer than 7 bytes
    toks, ties = list(Vocab.base(SPECIALS).tokens()), 0
    for a, b in model.merges:
        merged = a + b
        if len(merged) > 7:
            ties += sum(len(t) > 7 and t[:7] == merged[:7] for t in toks)
        if merged not in toks:
            toks.append(merged)
    assert got["k2.tie_rows"] == ties
