"""The port's benchmark harness (bench_torch.py) and its CLI on the CPU.

The harness's legs run here with ``device="cpu"`` (the kernels' plain
twins): the headline leg's function on the 5 MB realistic fixture, cut
from vocab 1000 to 300 to keep the test short, must give the native
loop's and the JAX trainer's merges on the K2 route, and the encode leg
GPT-2's ids through the device batch and the host encoder. The script
itself has no CPU mode: on this host, which has no CUDA device, it must
exit non-zero and print no JSON line.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys

import pytest

import bench_torch
from yabpe_tpu import BBPETrainer as JaxTrainer
from yabpe_tpu import BBPETrainerConfig as JaxConfig
from yabpe_tpu_torch.cli import bench as bench_cli

from .common import LOCAL_FIXTURES, REPO

#: The headline leg cut in vocab (1000 in the harness), stated here.
VOCAB = 300


def test_headline_leg_matches_native_and_jax():
    real = LOCAL_FIXTURES / "bench_5M_realistic.txt"
    assert bench_torch.REAL_5M == real
    leg = bench_torch.train_leg(real, "train_real5m", vocab_size=VOCAB, reps=1, device="cpu")
    assert leg["device"]["route"] == "K2"
    assert leg["native"]["route"] == "native"
    assert leg["device"]["merges"] == leg["native"]["merges"] == VOCAB - 257
    assert leg["device"]["peak_device_bytes"] is None
    assert leg["device"]["bytes_per_s"] > 0 and leg["native"]["bytes_per_s"] > 0

    from yabpe_tpu_torch import BBPETrainer, BBPETrainerConfig

    kw = dict(vocab_size=VOCAB, min_frequency=1, max_workers=8, chunk_size_bytes=1 << 20,
              special_tokens=["<|endoftext|>"], align_chunks_to_newline=True)
    device = BBPETrainer(BBPETrainerConfig(**kw, device="cpu"))
    native = BBPETrainer(BBPETrainerConfig(**kw, use_native_loop=True))
    want = JaxTrainer(JaxConfig(**kw)).train([real])
    got = device.train([real])
    assert device.route == "K2"
    assert got.merges == native.train([real]).merges == want.merges
    assert got.vocab == want.vocab


def test_train_leg_raises_when_the_device_differs(monkeypatch):
    """A device run that differs from the native loop fails the leg."""
    from yabpe_tpu_torch.train import trainer as trainer_mod

    real_train = trainer_mod.BBPETrainer.train

    def skewed(self, files):
        model = real_train(self, files)
        if self.route == "K2":
            model.merges[-1] = (b"x", b"y")
        return model

    monkeypatch.setattr(trainer_mod.BBPETrainer, "train", skewed)
    with pytest.raises(bench_torch.BenchFailure, match="merges differ"):
        bench_torch.train_leg(bench_torch.REAL_5M, "train_real5m", vocab_size=260, reps=1,
                              device="cpu")


def test_encode_leg_matches_host_encode():
    leg = bench_torch.encode_leg(device="cpu")
    assert leg["batch_device"]["tokens"] > 1_000_000
    assert leg["host_encode_real"]["tokens"] > 1_000_000
    assert leg["batch_device"]["peak_device_bytes"] is None


def test_result_line_has_bench_py_keys():
    """The last line has exactly the four keys of bench.py's, its metric
    name, and the headline against the native loop of the same leg."""
    leg = {"device": {"bytes_per_s": 3_000_000.26}, "native": {"bytes_per_s": 1_500_000.0}}
    line = bench_torch.result_line(leg)
    source = (REPO / "bench.py").read_text(encoding="utf-8")
    worker = source[source.index("def _worker"):source.index("def _cross_round_compare")]
    jax_keys = set(re.findall(r'^\s+"(\w+)": ', worker, re.M))
    assert set(line) == jax_keys == {"metric", "value", "unit", "vs_baseline"}
    assert f'"metric": "{line["metric"]}"' in source
    assert line == {
        "metric": "train_bpe_realistic5MB_vocab1000_bytes_per_s",
        "value": 3000000.3,
        "unit": "bytes/s",
        "vs_baseline": 2.0,
    }
    assert json.loads(json.dumps(line)) == line


def test_script_without_cuda_exits_nonzero_without_a_line():
    out = subprocess.run(
        [sys.executable, str(REPO / "bench_torch.py")],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    assert not any(ln.strip().startswith("{") for ln in out.stdout.splitlines()), out.stdout
    assert "no CUDA device" in out.stderr


def test_cli_returns_1_without_the_harness(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(bench_cli, "HARNESS", tmp_path / "bench_torch.py")
    monkeypatch.setattr(sys, "argv", ["yabpe-torch-bench"])
    assert bench_cli.main() == 1
    assert "bench_torch.py not found" in capsys.readouterr().err


def test_cli_runs_the_harness_as_main(monkeypatch, tmp_path):
    assert bench_cli.HARNESS == REPO / "bench_torch.py"
    harness = tmp_path / "bench_torch.py"
    harness.write_text(
        "import pathlib\n"
        "if __name__ == '__main__':\n"
        f"    pathlib.Path({str(tmp_path / 'ran')!r}).write_text(__name__)\n"
    )
    monkeypatch.setattr(bench_cli, "HARNESS", harness)
    monkeypatch.setattr(sys, "argv", ["yabpe-torch-bench"])
    assert bench_cli.main() == 0
    assert (tmp_path / "ran").read_text() == "__main__"
