"""Benchmark CLI (``yabpe-torch-bench``): runs the repo-root harness
``bench_torch.py``.

Counterpart of yabpe_tpu/cli/bench.py, which runs ``bench.py``. Kept thin
so that the harness (repo root, one JSON line last on stdout) stays the
one source of truth. It needs a checkout of the repository and a CUDA
device; the harness has no CPU mode.
"""

from __future__ import annotations

import runpy
import sys
from pathlib import Path

#: The harness, three levels above this file (src/yabpe_tpu_torch/cli/).
HARNESS = Path(__file__).resolve().parents[3] / "bench_torch.py"


def main() -> int:
    import argparse

    parser = argparse.ArgumentParser(
        prog="yabpe-torch-bench",
        description=(
            "Run the port's benchmark harness on the GPU (training and "
            "encode legs; prints one JSON headline line last on stdout, "
            "details to stderr)."
        ),
    )
    parser.parse_args()
    if not HARNESS.exists():
        print("bench_torch.py not found (installed package without repo checkout)",
              file=sys.stderr)
        return 1
    runpy.run_path(str(HARNESS), run_name="__main__")
    return 0


if __name__ == "__main__":
    sys.exit(main())
