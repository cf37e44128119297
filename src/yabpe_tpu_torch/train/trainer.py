"""Training orchestration: files -> ingestion -> merge loop -> model.

Counterpart of yabpe_tpu/train/trainer.py, with the reference library's
public surface (BBPETrainer.train/save, empty-corpus short-circuit, input
validation). Routing, which in this slice of the port is explicit:

- ``backend="numpy"``: the host oracle (train/reference_loop.py);
- ``use_native_loop=True``: the native C++ host merge loop;
- otherwise the device route on ``config.device``: with ``data_shards`` >
  1 and ``use_hbm_kernel=True``, the data-sharded loop
  (dist/hbm_sharded.py, the replay kernel kernels/replay_emit.py on every
  word shard); with one shard, the small-vocabulary kernel
  (kernels/fused_loop.py) for problems within its admission
  (:meth:`BBPETrainer._should_use_fused`), the large-vocabulary kernel
  (kernels/hbm_loop.py) for the rest.

Every route gives the same merges. The JAX package's crossover model was
measured on a TPU and is not carried over; measurements on the GPU will
set the default. The device route never falls back: no CUDA device, a
failed build of the native scanner or of the kernel, or a problem past
the kernel's limits raises; where the JAX trainer restarts a problem that
the data-sharded loop rejects on its XLA sharded loop, which is not
ported, this one lets the error rise.
"""

from __future__ import annotations

import time
from collections.abc import Sequence
from pathlib import Path

import numpy as np

from yabpe_tpu_torch.core.vocab import Vocab
from yabpe_tpu_torch.core.wordtable import WordTable
from yabpe_tpu_torch.io.native import save_model
from yabpe_tpu_torch.pretok.ingest import count_pretokens, count_pretokens_raw
from yabpe_tpu_torch.train.config import BBPETrainerConfig
from yabpe_tpu_torch.train.model import BBPEModel
from yabpe_tpu_torch.train.reference_loop import train_merges_oracle
from yabpe_tpu_torch.utils.logging import get_logger

_LOG = get_logger(__name__)


class BBPETrainer:
    """Byte-level BPE trainer with a device-resident merge loop."""

    def __init__(self, config: BBPETrainerConfig | None = None) -> None:
        self.config: BBPETrainerConfig = config or BBPETrainerConfig()
        self._vocab: dict[bytes, int] = {}
        self._merges: list[tuple[bytes, bytes]] = []
        self.last_stats: dict[str, float] = {}
        #: The data-sharded loop's ``stats_out`` for the last train() that
        #: ran it (epochs, fallbacks, ...), else empty.
        self.loop_stats: dict = {}

    def train(self, files: Sequence[str | Path]) -> BBPEModel:
        """Train a BBPE model from one or more UTF-8 text files."""
        if not files:
            raise ValueError("At least one file must be provided")
        cfg = self.config
        self._check_config()
        self.loop_stats = {}

        # Training owns this process's hot allocation path: opt in to the
        # arena-friendly glibc tuning here (NOT at library import).
        from yabpe_tpu_torch.utils.hostmem import tune_malloc

        tune_malloc()

        base = Vocab.base(cfg.special_tokens)
        num_merges = max(0, cfg.vocab_size - len(base))
        ingest_args = dict(
            chunk_size_bytes=cfg.chunk_size_bytes,
            max_workers=cfg.max_workers,
            align_to_newline=cfg.align_chunks_to_newline,
        )

        raw = counter = None
        t0 = time.perf_counter()
        if cfg.backend == "numpy":
            counter = count_pretokens(
                files, cfg.special_tokens, require_native=False, **ingest_args
            )
        else:
            raw = count_pretokens_raw(files, cfg.special_tokens, **ingest_args)
        t_ingest = time.perf_counter() - t0

        if raw is not None:
            blob, lens, counts = raw
            n_unique = len(lens)
            corpus_bytes = int(np.dot(lens.astype(np.int64), counts))
        else:
            n_unique = len(counter)
            corpus_bytes = sum(len(w) * c for w, c in counter.items())

        if n_unique == 0:
            self._vocab = base.as_bytes_to_id()
            self._merges = []
            return BBPEModel(
                vocab=self._vocab, merges=[], special_tokens=list(cfg.special_tokens)
            )

        t0 = time.perf_counter()
        if cfg.backend == "numpy":
            vocab, merges = train_merges_oracle(
                counter, cfg.special_tokens, cfg.vocab_size, cfg.min_frequency
            )
        elif cfg.use_native_loop:
            from yabpe_tpu_torch import native

            merges = (
                native.train_host_raw(
                    blob, lens, counts, num_merges, cfg.min_frequency
                )
                if num_merges > 0
                else []
            )
            vocab = Vocab()
            for tok in base.tokens():
                vocab.add(tok)
            for left, right in merges:
                vocab.add(left + right)
        else:
            from yabpe_tpu_torch.pretok.ingest import counter_from_raw

            vocab, merges = self._train_device(
                counter_from_raw(blob, lens, counts), base
            )
        t_merge = time.perf_counter() - t0

        self.last_stats = {
            "ingest_seconds": t_ingest,
            "merge_seconds": t_merge,
            "corpus_bytes": float(corpus_bytes),
            "unique_pretokens": float(n_unique),
            "num_merges": float(len(merges)),
            "bytes_per_second": corpus_bytes / max(t_ingest + t_merge, 1e-9),
        }
        _LOG.info(
            "trained %d merges in %.3fs (ingest %.3fs, %.2f MB/s end-to-end)",
            len(merges),
            t_merge,
            t_ingest,
            self.last_stats["bytes_per_second"] / 1e6,
        )

        self._vocab = vocab.as_bytes_to_id()
        self._merges = merges
        return BBPEModel(
            vocab=self._vocab,
            merges=self._merges,
            special_tokens=list(cfg.special_tokens),
        )

    def _check_config(self) -> None:
        """Raise for what this slice of the port does not cover."""
        cfg = self.config
        if cfg.backend not in ("torch", "numpy"):
            raise ValueError(f"unknown backend {cfg.backend!r}")
        if (cfg.vocab_shards or 1) > 1:
            raise NotImplementedError(
                "vocabulary-sharded training (vocab_shards > 1) is not "
                "ported yet (ROADMAP.md, queue 1 item 9: distributed)"
            )
        if (cfg.data_shards or 1) > 1 and cfg.use_hbm_kernel is not True:
            raise NotImplementedError(
                "data_shards > 1 runs only the data-sharded kernel loop "
                "(use_hbm_kernel=True); the XLA sharded loop is not ported "
                "yet (ROADMAP.md, queue 1 item 9: distributed)"
            )
        if cfg.checkpoint_dir:
            raise NotImplementedError(
                "checkpoint_dir is not ported yet (ROADMAP.md, queue 1 "
                "item 6: checkpoint and resume)"
            )

    def _train_device(
        self, counter, base: Vocab
    ) -> tuple[Vocab, list[tuple[bytes, bytes]]]:
        import torch

        from yabpe_tpu_torch.train import state as train_state
        from yabpe_tpu_torch.train.fused_driver import run_fused_merge_loop
        from yabpe_tpu_torch.train.hbm_driver import run_hbm_merge_loop

        cfg = self.config
        device = torch.device(cfg.device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "BBPETrainerConfig.device is 'cuda' but CUDA is not "
                "available; pass device='cpu' to run the device route on "
                "the CPU"
            )
        num_merges = max(0, cfg.vocab_size - len(base))
        if num_merges == 0:
            return base, []
        vocab_cap = max(cfg.vocab_size, len(base))
        table_bytes = 4 * vocab_cap * vocab_cap
        if table_bytes > cfg.max_pair_table_bytes:
            raise ValueError(
                f"dense pair table would need {table_bytes} bytes for "
                f"vocab_cap={vocab_cap}; raise max_pair_table_bytes or lower "
                "vocab_size"
            )
        table = WordTable.from_counter(counter)
        if (cfg.data_shards or 1) > 1:
            self._check_hbm_sharded(table, vocab_cap)
            from yabpe_tpu_torch.dist.hbm_sharded import (
                run_hbm_sharded_merge_loop,
            )

            spec = cfg.spec_merges_per_round
            merges_ids = run_hbm_sharded_merge_loop(
                table,
                base,
                vocab_cap=vocab_cap,
                num_merges=num_merges,
                min_frequency=cfg.min_frequency,
                data_shards=cfg.data_shards,
                spec_batch=spec if spec > 1 else 16,
                cps=cfg.hbm_sharded_cps,
                device=device,
                stats_out=self.loop_stats,
            )
            return train_state.merges_to_bytes(merges_ids, base)
        run = (
            run_fused_merge_loop
            if self._should_use_fused(table, vocab_cap)
            else run_hbm_merge_loop
        )
        merges_ids = run(
            table,
            base,
            vocab_cap=vocab_cap,
            num_merges=num_merges,
            min_frequency=cfg.min_frequency,
            chunk_size=cfg.merge_chunk_size,
            device=device,
        )
        return train_state.merges_to_bytes(merges_ids, base)

    def _check_hbm_sharded(self, table: WordTable, vocab_cap: int) -> None:
        """Raise ValueError for a problem past the data-sharded loop's
        limits, as the JAX trainer's ``_should_use_hbm_sharded`` does for
        ``use_hbm_kernel=True``; this trainer runs in one process."""
        from yabpe_tpu_torch.dist.hbm_sharded import hbm_sharded_applicable

        if not hbm_sharded_applicable(
            int(table.words.shape[0]),
            int(table.words.shape[1]),
            vocab_cap,
            data_shards=self.config.data_shards,
        ):
            raise ValueError(
                "use_hbm_kernel=True with data_shards > 1 but the problem "
                "exceeds the sharded-HBM loop's limits (vocab <= 63488, "
                "word width <= 64, per-shard log plan)"
            )

    def _should_use_fused(self, table: WordTable, vocab_cap: int) -> bool:
        """Route a device problem to the small-vocabulary kernel.

        Counterpart of the JAX trainer's ``_should_use_fused``, with the
        same admission (``fused_applicable``, copied verbatim) so that both
        packages send the same problems to this kernel. ``False`` never
        takes it; ``True`` takes it or raises ValueError past the
        admission. Unlike the JAX package, auto (``None``) does not ask
        for a TPU: there the test keeps the Pallas kernel off backends
        where it would run interpreted, while here the kernel is the
        device route's own, on the card or as its plain twin on the CPU.
        """
        from yabpe_tpu_torch.train.fused_driver import fused_applicable

        cfg = self.config
        if cfg.use_fused_kernel is False:
            return False
        fits = fused_applicable(
            int(table.words.shape[0]),
            int(table.words.shape[1]),
            vocab_cap,
            max(table.width, 2),
        )
        if cfg.use_fused_kernel is True and not fits:
            raise ValueError(
                "use_fused_kernel=True but the problem exceeds the "
                "kernel's VMEM budget"
            )
        return fits

    def save(self, output_dir: str | Path) -> None:
        """Persist the trained model to disk (native latin-1 dialect)."""
        if not self._vocab:
            raise ValueError("Model has not been trained yet. Call train() first.")
        save_model(output_dir, self._vocab, self._merges, self.config.special_tokens)


__all__ = ["BBPETrainer"]
