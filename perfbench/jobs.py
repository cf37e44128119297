"""The jobs a traffic mix can ask for, each with its set-up, its window and
the reference check of what its window produced.

A traffic file (``traffic/<name>.json``) names its job by ``kind`` and
gives its parameters; a configuration file (``configs/<name>.json``) gives
the trainer's settings and the corpus. Nothing here knows a cell by name.

- ``train``: one warm-up training in the set-up, then trainings of the
  corpus back to back, each a new ``BBPETrainer(config).train(files)`` on
  the default route.

Each job keeps what its window's calls returned, and ``check`` holds it
against the plain reference (``reference/``) once the window has closed.
"""

from __future__ import annotations

import time
from pathlib import Path

from corpus import generate
from reference import pretok as ref_pretok
from reference import train as ref_train

DEFAULT_CHUNK = 8 * 1024 * 1024


def annotate(name: str):
    from torch.profiler import record_function

    return record_function(name)


def _sync(device: str) -> None:
    import torch

    if device.startswith("cuda"):
        torch.cuda.synchronize()


def model_diff(vocab, merges, want_vocab, want_merges) -> tuple[int, int]:
    """(merges that differ by position, vocab entries that differ)."""
    n = max(len(merges), len(want_merges))
    merges_off = sum(1 for i in range(n)
                     if i >= len(merges) or i >= len(want_merges) or merges[i] != want_merges[i])
    vocab_off = len(set(vocab.items()) ^ set(want_vocab.items()))
    return merges_off, vocab_off


class TrainJob:
    def __init__(self, config: dict, traffic: dict, seed: int, workdir: Path, device: str) -> None:
        self.config, self.seed = config, seed
        self.workdir, self.device = workdir, device
        self.trainer_kw = dict(config["trainer"])
        self.specials = list(self.trainer_kw.get("special_tokens", []))
        self.files: list[Path] = []
        self.records: dict = {}

    def trainer_config(self):
        from yabpe_tpu_torch import BBPETrainerConfig

        return BBPETrainerConfig(**self.trainer_kw, device=self.device)

    def setup(self) -> None:
        from yabpe_tpu_torch import BBPETrainer

        t0 = time.perf_counter()
        self.files = generate(self.workdir / "corpus", self.seed, self.config["corpus"])
        self.records["corpus_s"] = time.perf_counter() - t0
        self.records["corpus_bytes"] = sum(p.stat().st_size for p in self.files)
        BBPETrainer(self.trainer_config()).train(self.files)
        _sync(self.device)

    def window(self, seconds: float) -> None:
        from yabpe_tpu_torch import BBPETrainer

        runs, models = [], []
        t_start = time.perf_counter()
        while time.perf_counter() - t_start < seconds:
            i = len(runs)
            with annotate(f"train#{i}"):
                t0 = time.perf_counter()
                trainer = BBPETrainer(self.trainer_config())
                model = trainer.train(self.files)
                _sync(self.device)
                t1 = time.perf_counter()
            st = trainer.last_stats
            runs.append({"start": t0, "end": t1, "route": trainer.route,
                         "ingest_s": st["ingest_seconds"], "merge_s": st["merge_seconds"],
                         "merges": len(model.merges)})
            models.append((model.vocab, model.merges))
        self.records["trainings"] = runs
        self.models = models

    def end_to_end(self) -> dict:
        runs = self.records["trainings"]
        span = runs[-1]["end"] - runs[0]["start"]
        return {"train_bytes_per_s": len(runs) * self.records["corpus_bytes"] / span}

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        import gc

        gc.collect()
        if self.device.startswith("cuda"):
            import torch

            torch.cuda.empty_cache()

    def check(self) -> list[tuple[str, float, float]]:
        kw, stats = self.trainer_kw, {}
        counts = ref_pretok.count_words(self.files, self.specials,
                                        kw.get("chunk_size_bytes", DEFAULT_CHUNK))
        want_vocab, want_merges = ref_train.train_bpe(
            counts, self.specials, kw["vocab_size"], kw.get("min_frequency", 2), stats=stats)
        self.records["reference"] = stats
        merges_off = vocab_off = wrong = 0
        for vocab, merges in self.models:
            m, v = model_diff(vocab, merges, want_vocab, want_merges)
            merges_off += m
            vocab_off += v
            wrong += bool(m or v)
        self.records["failed_calls"] = wrong
        return [
            ("merges_wrong", merges_off, 0),
            ("vocab_wrong", vocab_off, 0),
        ]


JOBS = {"train": TrainJob}
