#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port (``src/yabpe_tpu_torch``) on NVIDIA GPUs.

    python3 perfbench/run.py --workload NAME --seed N --seconds S --trace 0|1

Run from the root of a checkout. ``BENCHMARK.json`` names the cell: its
configuration (``perfbench/configs/<config>.json``), its traffic mix
(``perfbench/traffic/<traffic>.json``, whose ``kind`` picks a job of
``jobs.py``) and its metrics (``perfbench/metrics/<metric>.py``, one
reader each). A run:

1. exits 2, printing no result, without a CUDA device or with fewer
   devices than the cell asks for;
2. set-up: generates the corpus from ``--seed`` into ``$TMPDIR``, loads or
   builds the port's kernels and native library (in the checkout's
   ``src/yabpe_tpu_torch/_build/``), and runs the job's warm-up;
3. window: the job's calls back to back until ``--seconds`` have passed,
   under ``torch.profiler`` with ``--trace 1``;
4. check: reads the peak device memory, frees the program's state, and
   holds what the window's calls returned against the plain reference
   (``perfbench/reference/``);
5. prints each number compared with its limit as the last lines of
   stderr, and one JSON line last on stdout: the cell's end-to-end metrics
   (``--trace 0``) or per-layer metrics (``--trace 1``).

It exits 3, printing no result, if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
for _p in (str(HERE), str(ROOT / "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

FORBIDDEN = ("jax", "jaxlib", "flax", "yabpe_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, whole, is JAX's or the JAX
    package's (``yabpe_tpu_torch`` is not ``yabpe_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def load_cell(root: Path, workload: str) -> tuple[dict, dict, dict, dict]:
    """(cell, configuration, traffic, the cell's metrics
    {"end_to_end": [...], "per_layer": [...]}) for ``workload``."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: {sorted(cells)}")
    cell = cells[workload]
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((root / entry["file"]).read_text())
    traffic = json.loads((root / "perfbench" / "traffic" / f"{cell['traffic']}.json").read_text())

    def mine(m: dict) -> bool:
        return workload in m.get("workloads", [workload])

    metrics = {k: [m for m in bench[k] if mine(m)] for k in ("end_to_end", "per_layer")}
    return cell, config, traffic, metrics


def load_reader(root: Path, name: str):
    path = root / "perfbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


class NoDevice(RuntimeError):
    pass


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", root: Path = ROOT, workdir: Path | None = None) -> dict:
    """One run of a cell; returns the result line as a dict. ``device``
    other than "cuda" skips the look for a card (for the CPU tests)."""
    import jobs

    cell, config, traffic, metrics = load_cell(root, workload)
    import torch

    on_card = device.startswith("cuda")
    if on_card:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            raise NoDevice(f"needs {cell['chips']} CUDA device(s); "
                           f"available: {torch.cuda.is_available()}, "
                           f"count: {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    import yabpe_tpu_torch  # noqa: F401  (fail before any set-up without the program)

    import devtrace
    import roofline

    workdir = Path(workdir or Path(tempfile.gettempdir()) / f"perfbench-{workload}-{seed}")
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    job = jobs.JOBS[traffic["kind"]](config, traffic, seed, workdir, device)
    try:
        job.setup()
        setup_s = time.perf_counter() - T_START
        log(f"setup {setup_s:.3f} s (corpus {job.records['corpus_bytes']} bytes in "
            f"{job.records['corpus_s']:.3f} s)")
        prof = devtrace.start() if trace else None
        with jobs.annotate(devtrace.WINDOW):
            job.window(seconds)
        events = devtrace.stop(prof) if trace else None
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        e2e = job.end_to_end()
        for i, r in enumerate(job.records["trainings"]):
            log(f"training {i}: {json.dumps(r)}")
        job.release()
        t0 = time.perf_counter()
        checks = job.check()
        log(f"reference check {time.perf_counter() - t0:.3f} s")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    card = {"platform": "gpu" if on_card else device,
            "kind": torch.cuda.get_device_name(0) if on_card else device,
            "count": cell["chips"], "memory_peak_bytes": int(peak),
            "power_limit_w": roofline.power_limit_w() if on_card else None}
    out: dict = {}
    if trace:
        reduced = devtrace.reduce(events)
        del events
        card["busy_s"], card["window_s"] = reduced["busy_s"], reduced["window_s"]
        rec = {**job.records, "trace": reduced, "power_limit_w": card["power_limit_w"]}
        values = {}
        for m in metrics["per_layer"]:
            v = load_reader(root, m["name"])(rec)
            if v is not None:
                values[m["name"]] = {"value": v, "unit": m["unit"]}
        out["metrics"] = values
        out["breakdown"] = {"device_ops": reduced["device_ops"], "idle_gaps": reduced["idle_gaps"]}
    else:
        values = {**e2e, "setup_s": setup_s}
        out["metrics"] = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                          for m in metrics["end_to_end"] if m["name"] in values}
    failed = int(job.records.get("failed_calls", 0))
    attempted = len(job.records["trainings"])
    result = {
        "correct": all(v <= limit for _, v, limit in checks),
        "attempted": attempted,
        "failed": failed,
        **out,
        "device": card,
        "checks": {name: {"value": v, "limit": limit} for name, v, limit in checks},
    }
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    except NoDevice as e:
        log(f"perfbench: {e}; no result")
        return 2
    found = forbidden_modules()
    if found:
        log(f"perfbench: loaded {found} (JAX or the JAX package); no result")
        return 3
    for name, c in result["checks"].items():
        log(f"check {name} = {c['value']} (limit {c['limit']})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
