"""The harness's modules import one another by their top-level names, as
``perfbench/run.py`` sets them up: put ``perfbench/`` and the port's
``src/`` on the path."""

import shutil
import sys
from pathlib import Path

import pytest

PERFBENCH = Path(__file__).resolve().parents[1]
ROOT = PERFBENCH.parent
for _p in (str(PERFBENCH), str(ROOT / "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    """A checkout-like root: a copy of ``perfbench/`` and the CPU-sized
    benchmark of ``tests/data/BENCHMARK.json``."""
    root = tmp_path / "root"
    shutil.copytree(PERFBENCH, root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (root / "perfbench" / "tests" / "data").mkdir(parents=True)
    for name in ("BENCHMARK.json", "tiny.json"):
        shutil.copy(PERFBENCH / "tests" / "data" / name, root / "perfbench" / "tests" / "data" / name)
    shutil.move(root / "perfbench" / "tests" / "data" / "BENCHMARK.json", root / "BENCHMARK.json")
    return root
