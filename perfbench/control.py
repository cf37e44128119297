#!/usr/bin/env python3
"""The controls of the benchmark's correctness check, at a cell's own size.

    python3 perfbench/control.py --workload NAME --seeds 1 2 3

For each seed it makes the cell's corpus and puts the plain reference, with
one guarantee broken, in the program's place, then reads the numbers that
a run compares:

the merge loop with ties broken towards the least ``(left, right)``
instead of the greatest (``merges_wrong``, ``vocab_wrong`` against the
reference).

A control has to come out as not correct: some number above its limit
(0). The benchmark's own runs never run it. One JSON line a seed.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

from corpus import generate  # noqa: E402
from jobs import DEFAULT_CHUNK, model_diff  # noqa: E402
from reference import pretok  # noqa: E402
from reference import train as ref_train  # noqa: E402
from run import ROOT, load_cell  # noqa: E402


def control(workload: str, seed: int, root: Path = ROOT) -> dict:
    _, config, _, _ = load_cell(root, workload)
    kw = config["trainer"]
    specials = list(kw.get("special_tokens", []))
    work = Path(tempfile.gettempdir()) / f"perfbench-control-{workload}-{seed}"
    shutil.rmtree(work, ignore_errors=True)
    t0 = time.perf_counter()
    try:
        files = generate(work, seed, config["corpus"])
        counts = pretok.count_words(files, specials, kw.get("chunk_size_bytes", DEFAULT_CHUNK))
        args = (counts, specials, kw["vocab_size"], kw.get("min_frequency", 2))
        vocab, merges = ref_train.train_bpe(*args)
        c_vocab, c_merges = ref_train.train_bpe(*args, tie="least")
        m_off, v_off = model_diff(c_vocab, c_merges, vocab, merges)
        out = {"workload": workload, "seed": seed, "merges_wrong": m_off, "vocab_wrong": v_off}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    for seed in args.seeds:
        print(json.dumps(control(args.workload, seed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
