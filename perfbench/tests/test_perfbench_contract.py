"""BENCHMARK.json against the benchmark's contract, and the harness's
files found by name."""

import ast
import json
import os
import re
import subprocess
import sys

import pytest
from conftest import PERFBENCH, ROOT

import run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_keys_names_and_units(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "perfbench/run.py"] and bench["paths"] == ["perfbench"]
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and LINE.match(c["source"]) and LINE.match(c["why"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and LINE.match(w["why"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert LINE.match(m["layer"])
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in bench[k]]
    assert len({n for n in names}) == len(names)


def test_run_seconds_fits_a_full_check(bench):
    rs = bench["run_seconds"]
    assert 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_every_cell_finds_its_files_and_metrics(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    used = set()
    for w in bench["workloads"]:
        cell, config, traffic, metrics = run.load_cell(ROOT, w["name"])
        used.add(cell["config"])
        assert traffic["kind"] in __import__("jobs").JOBS
        entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
        assert entry["file"].startswith("perfbench/")
        assert set(entry["reduced"]) == set(config["reduced"])
        names = {m["name"] for m in metrics["end_to_end"]}
        assert "setup_s" in names and len(names) >= 2, w["name"]
        assert metrics["per_layer"], w["name"]
        for m in metrics["per_layer"]:
            assert callable(run.load_reader(ROOT, m["name"]))
            # the metric's cells report the end-to-end metric it moves
            assert m["moves"] in e2e and m["moves"] in names, (m["name"], w["name"])
    assert used == {c["name"] for c in bench["configs"]}


def test_roofline_and_layers(bench):
    for m in bench["per_layer"]:
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"
    layers = {}
    for m in bench["per_layer"]:
        layers.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values()), layers


def test_a_new_config_and_metric_are_picked_up_by_name(tiny_root):
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    cfg = json.loads((tiny_root / "perfbench" / "tests" / "data" / "tiny.json").read_text())
    cfg["trainer"]["vocab_size"] = 300
    (tiny_root / "perfbench" / "configs" / "added.json").write_text(json.dumps(cfg))
    (tiny_root / "perfbench" / "metrics" / "trainings_in_window.py").write_text(
        "def read(rec):\n    return float(len(rec.get('trainings') or [])) or None\n")
    bench["configs"].append({"name": "added", "source": "test", "why": "test", "reduced": [],
                             "file": "perfbench/configs/added.json"})
    bench["workloads"].append({"name": "added.train", "config": "added", "traffic": "train",
                               "chips": 1, "why": "test"})
    bench["end_to_end"][0]["workloads"].append("added.train")
    bench["per_layer"].append({"name": "trainings_in_window", "unit": "1", "better": "higher",
                               "source": "host_clock", "layer": "Harness",
                               "moves": "train_bytes_per_s", "workloads": ["added.train"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    result = run.run_cell("added.train", 7, 0.5, True, device="cpu", root=tiny_root)
    assert result["correct"]
    assert result["metrics"]["trainings_in_window"]["value"] >= 1


def _imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_nothing_imports_jax_or_the_jax_package():
    files = sorted(PERFBENCH.rglob("*.py"))
    assert files
    for path in files:
        names = set(_imports(path))
        assert not names & set(run.FORBIDDEN), (path, names & set(run.FORBIDDEN))
        if "reference" in path.relative_to(PERFBENCH).parts:
            assert "yabpe_tpu_torch" not in names, path
    # by whole top-level names: the port's name begins with the JAX package's
    assert "yabpe_tpu_torch".split(".")[0] not in run.FORBIDDEN


def test_without_cuda_the_run_fails_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "owt-32k.train",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, env=env, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "no result" in p.stderr
