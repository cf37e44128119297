"""The port's training CLI (yabpe_tpu_torch.cli.train_bpe) against the JAX
package's (yabpe_tpu.cli.train_bpe) on tests/data/large.txt: the saved
model files must be byte-identical."""

from __future__ import annotations

import json

import pytest
import torch

from yabpe_tpu.cli import train_bpe as jax_cli
from yabpe_tpu_torch.cli import train_bpe

from .common import DATA

FILES = ("vocab.json", "merges.txt", "special_tokens.json")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize(
    "flags",
    [
        ["--engine", "native"],
        ["--engine", "device"],
        ["--engine", "device", "--data-shards", "2", "--vocab-shards", "2"],
    ],
    ids=["native", "device", "data2_vocab2"],
)
def test_cli_writes_the_jax_cli_files(tmp_path, capsys, flags):
    common = [str(DATA / "large.txt"), "--vocab-size", "400", "--min-frequency", "2",
              "--max-workers", "1", *flags]
    assert train_bpe.main([*common, "-o", str(tmp_path / "port"), "--device", "cpu"]) == 0
    assert "BPE training complete" in capsys.readouterr().out
    assert jax_cli.main([*common, "-o", str(tmp_path / "jax")]) == 0
    for name in FILES:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes(), name
    assert len(json.loads((tmp_path / "port" / "vocab.json").read_text())) == 400


def test_cli_profile_dir_writes_a_trace(tmp_path, capsys):
    out = tmp_path / "model"
    trace = tmp_path / "trace"
    assert train_bpe.main([
        str(DATA / "sample.txt"), "--vocab-size", "300", "--min-frequency", "1",
        "--max-workers", "1", "--device", "cpu", "-o", str(out), "--profile-dir", str(trace),
    ]) == 0
    capsys.readouterr()
    events = json.loads((trace / "trace.json").read_text())["traceEvents"]
    assert events and all((out / name).exists() for name in FILES)


def test_parser_takes_the_ports_flags():
    args = train_bpe.build_parser().parse_args(["x.txt"])
    assert (args.backend, args.device, args.vocab_shards) == ("torch", "cuda", 1)
    for dropped in ("--ingest-processes", "--count-strategy"):
        with pytest.raises(SystemExit):
            train_bpe.build_parser().parse_args(["x.txt", dropped, "dense"])
