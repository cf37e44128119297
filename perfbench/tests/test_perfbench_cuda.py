"""A short run of each cell on the card (marked ``cuda``; skips without
one). On the GPU machine:

    python -m pytest -m cuda perfbench/tests/test_perfbench_cuda.py
"""

import json

import pytest
from conftest import ROOT

import run

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_a_short_run_on_the_card_is_correct(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    result = run.run_cell(workload, 2**31 + 99, 2.0, False)
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
