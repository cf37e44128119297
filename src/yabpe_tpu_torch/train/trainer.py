"""Training orchestration: files -> ingestion -> merge loop -> model.

Counterpart of yabpe_tpu/train/trainer.py, with the reference library's
public surface (BBPETrainer.train/save, empty-corpus short-circuit, input
validation). Routing, which in the port is explicit:

- ``backend="numpy"``: the host oracle (train/reference_loop.py);
- ``use_native_loop=True``: the native C++ host merge loop;
- otherwise the device route on ``config.device``. With ``data_shards``
  > 1, as the JAX trainer routes (``:186-240``): the kernel-sharded loop
  (dist/hbm_sharded.py, the replay kernel kernels/replay_emit.py on every
  word shard; route ``"sharded"``) with ``use_hbm_kernel=True`` and within
  its limits (:meth:`BBPETrainer._should_use_hbm_sharded`), else the
  sharded loop of dist/sharded.py over ``data_shards`` x ``vocab_shards``
  (route ``"sharded_loop"``), which also takes over, from the start, a run
  that the kernel-sharded loop rejects mid-run (HbmShardedUnsupported).
  With one shard, as the JAX trainer's ``_run_single_device``
  (``:329-444``) routes, in this order:
  1. the small-vocabulary kernel K1 (kernels/fused_loop.py) for problems
     within its admission and its own limits (``hbm_driver.kernel_limits
     (..., fused=True)``: pair mass below 2^31, any word width),
     without ``checkpoint_dir`` (:meth:`BBPETrainer._should_use_fused`);
  2. the large-vocabulary kernel K2 (kernels/hbm_loop.py) for problems
     within the kernels' limits (``hbm_driver.kernel_limits``: vocab <=
     131,072, words of at most 64 symbols, pair mass below 2^31);
  3. past them, the bigvocab engine (train/bigvocab.py) at vocab > 2048,
  4. else the incremental engine (train/incremental.py); both are the JAX
     package's XLA engines in torch ops, on the same device.

Under ``torch.distributed`` with more than one process (the backend is
the one the process group was initialized with, dist/mesh.py), ingest
goes through dist/ingest.py (each process reads its share of the files,
the tables are unioned on every process) and the sharded loops spread
their data shards over the processes.

The route is chosen before the run and logged (``route`` keeps it). Every
route gives the same merges. The JAX package's crossover model was
measured on a TPU and is not carried over; measurements on the GPU will
set the default. The device route never falls back to the CPU: no CUDA
device, a failed build of the native scanner or of a kernel, or a state
past the device's free memory raises.

While the tracer records (utils/profiling.py), a training is a
``yabpe.train`` span, with ``yabpe.ingest`` and ``yabpe.merge`` under it
over the intervals of ``last_stats["ingest_seconds"]`` and
``["merge_seconds"]``, and the device route's steps under the latter:
``yabpe.route.wordtable`` (the padded table built from the scanner's raw
export, core/wordtable.py), ``.state`` and ``.chunks`` (train/hbm_driver.py)
and ``.decode``.

``checkpoint_dir`` saves the merge record every ``checkpoint_every_chunks``
chunks and resumes from it (train/checkpoint.py) on K2 (its replay mode),
the engines and both sharded loops; a checkpointed run never takes K1,
as in the JAX trainer.
"""

from __future__ import annotations

import time
from collections.abc import Sequence
from pathlib import Path

import numpy as np

from yabpe_tpu_torch.core.vocab import Vocab
from yabpe_tpu_torch.core.wordtable import WordTable
from yabpe_tpu_torch.dist.mesh import process_info
from yabpe_tpu_torch.io.native import save_model
from yabpe_tpu_torch.pretok.ingest import count_pretokens, count_pretokens_raw
from yabpe_tpu_torch.train.config import HOST_PAIR_TABLE_BYTES, BBPETrainerConfig
from yabpe_tpu_torch.train.model import BBPEModel
from yabpe_tpu_torch.train.reference_loop import train_merges_oracle
from yabpe_tpu_torch.utils.logging import get_logger
from yabpe_tpu_torch.utils.profiling import span

_LOG = get_logger(__name__)


class BBPETrainer:
    """Byte-level BPE trainer with a device-resident merge loop."""

    def __init__(self, config: BBPETrainerConfig | None = None) -> None:
        self.config: BBPETrainerConfig = config or BBPETrainerConfig()
        self._vocab: dict[bytes, int] = {}
        self._merges: list[tuple[bytes, bytes]] = []
        self.last_stats: dict[str, float] = {}
        #: The sharded loops' ``stats_out`` for the last train() that ran
        #: one (epochs, fallbacks, host syncs, ...), else empty.
        self.loop_stats: dict = {}
        #: The merge loop the last train() took: "oracle", "native", "K1",
        #: "K2", "sharded" (the kernel-sharded loop), "sharded_loop" (the
        #: data x vocab sharded loop), "bigvocab" or "incremental" (""
        #: before any).
        self.route: str = ""

    def train(self, files: Sequence[str | Path]) -> BBPEModel:
        """Train a BBPE model from one or more UTF-8 text files."""
        with span("yabpe.train"):
            return self._train(files)

    def _train(self, files: Sequence[str | Path]) -> BBPEModel:
        if not files:
            raise ValueError("At least one file must be provided")
        cfg = self.config
        self._check_config()
        self.loop_stats = {}
        self.route = ""

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
        with span("yabpe.ingest"):
            t0 = time.perf_counter()
            if cfg.backend == "numpy":
                counter = count_pretokens(
                    files, cfg.special_tokens, require_native=False,
                    use_processes=cfg.ingest_processes, **ingest_args
                )
            elif process_info()[0] > 1:
                # each process ingests its share of the files; the tables are
                # unioned identically on every process (dist/ingest.py)
                from yabpe_tpu_torch.dist.ingest import count_pretokens_global

                raw = count_pretokens_global(files, cfg.special_tokens, **ingest_args)
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

        with span("yabpe.merge"):
            t0 = time.perf_counter()
            if cfg.backend == "numpy":
                self.route = "oracle"
                vocab, merges = train_merges_oracle(
                    counter, cfg.special_tokens, cfg.vocab_size, cfg.min_frequency
                )
            elif cfg.use_native_loop:
                from yabpe_tpu_torch import native

                self.route = "native"
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
                vocab, merges = self._train_device(raw, base)
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
        cfg = self.config
        if cfg.backend not in ("torch", "numpy"):
            raise ValueError(f"unknown backend {cfg.backend!r}")

    def _train_device(
        self, raw: tuple[bytes, np.ndarray, np.ndarray], base: Vocab
    ) -> tuple[Vocab, list[tuple[bytes, bytes]]]:
        """The device route over the raw word export (blob, lens, counts)."""
        import torch

        from yabpe_tpu_torch.train import hbm_driver
        from yabpe_tpu_torch.train import state as train_state

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
        table_bytes = 4 * vocab_cap * vocab_cap // max(1, cfg.vocab_shards)
        cap = cfg.max_pair_table_bytes
        if cap is None and device.type != "cuda":
            cap = HOST_PAIR_TABLE_BYTES
        if cap is None:  # the card decides: its free memory must hold the table
            hbm_driver.check_memory(table_bytes, device)
        elif table_bytes > cap:
            raise ValueError(
                f"dense pair table would need {table_bytes} bytes for "
                f"vocab_cap={vocab_cap}; raise max_pair_table_bytes or lower "
                "vocab_size"
            )
        with span("yabpe.route.wordtable"):
            table = WordTable.from_raw(*raw)
        if (cfg.data_shards or 1) > 1:
            merges_ids = self._run_sharded(table, base, vocab_cap, num_merges, device)
        else:
            resume, saver = self._checkpoint_hooks()
            merges_ids = self._run_single_device(
                table, base, vocab_cap, num_merges, device, resume, saver
            )
        with span("yabpe.route.decode"):
            return train_state.merges_to_bytes(merges_ids, base)

    def _run_sharded(
        self, table: WordTable, base: Vocab, vocab_cap: int, num_merges: int, device,
    ) -> np.ndarray:
        """``data_shards`` > 1: the kernel-sharded loop where it is asked for
        and admits the problem, else (and after it rejects the problem
        mid-run) the data x vocab sharded loop, as the JAX trainer does."""
        from yabpe_tpu_torch.dist.hbm_sharded import (
            HbmShardedUnsupported,
            run_hbm_sharded_merge_loop,
        )
        from yabpe_tpu_torch.dist.sharded import run_sharded_merge_loop

        cfg = self.config
        processes, _, backend = process_info()
        common = dict(
            vocab_cap=vocab_cap, num_merges=num_merges,
            min_frequency=cfg.min_frequency, data_shards=cfg.data_shards,
            device=device, processes=processes, backend=backend,
            stats_out=self.loop_stats,
        )
        spec = cfg.spec_merges_per_round
        if self._should_use_hbm_sharded(table, vocab_cap, processes):
            resume, saver = self._checkpoint_hooks()
            self._log_route("sharded")
            try:
                return run_hbm_sharded_merge_loop(
                    table, base, spec_batch=spec if spec > 1 else 16,
                    cps=cfg.hbm_sharded_cps, resume=resume, on_chunk=saver,
                    **common,
                )
            except HbmShardedUnsupported as e:
                # deterministic loops: a restart from scratch on the
                # sharded loop gives the same merges
                _LOG.warning(
                    "kernel-sharded loop unsupported mid-run (%s); falling "
                    "back to the sharded loop", e,
                )
                self.loop_stats.clear()
        resume, saver = self._checkpoint_hooks()
        if spec == 0 and processes > 1:
            spec = 16  # auto: latency-tolerant epochs across processes
        self._log_route("sharded_loop")
        return run_sharded_merge_loop(
            table, base, vocab_shards=cfg.vocab_shards,
            chunk_size=cfg.merge_chunk_size, resume=resume, on_chunk=saver,
            spec_batch=spec, **common,
        )

    def _run_single_device(
        self, table: WordTable, base: Vocab, vocab_cap: int, num_merges: int,
        device, resume, saver,
    ) -> np.ndarray:
        """One device: K1, K2, or past the kernels' limits the bigvocab or
        the incremental engine, in the JAX trainer's order."""
        from yabpe_tpu_torch.train import hbm_driver
        from yabpe_tpu_torch.train import state as train_state

        cfg = self.config
        kw = dict(
            vocab_cap=vocab_cap,
            num_merges=num_merges,
            min_frequency=cfg.min_frequency,
            chunk_size=cfg.merge_chunk_size,
            device=device,
        )
        if self._should_use_fused(table, vocab_cap):
            from yabpe_tpu_torch.train.fused_driver import run_fused_merge_loop

            self._log_route("K1")
            return run_fused_merge_loop(table, base, **kw)
        limits = hbm_driver.kernel_limits(table, vocab_cap)
        if self._should_use_hbm(limits):
            self._log_route("K2")
            return hbm_driver.run_hbm_merge_loop(
                table, base, resume=resume, on_chunk=saver, **kw
            )

        count_strategy = train_state.resolve_count_strategy(
            cfg.count_strategy, table, vocab_cap, device.type
        )
        dtype = train_state.count_dtype(table)
        hbm_driver.check_memory(
            hbm_driver.state_bytes(
                table.words.shape[0], max(table.width, 2), vocab_cap,
                hbm_driver.byte_width(table.width, list(base.tokens())),
                num_merges,
            ) + (dtype.itemsize - 4) * vocab_cap * vocab_cap,
            device,
        )
        engine = dict(resume=resume, on_chunk=saver, count_strategy=count_strategy, **kw)
        if vocab_cap > 2048:
            from yabpe_tpu_torch.train.bigvocab import run_bigvocab_merge_loop

            self._log_route("bigvocab", limits)
            return run_bigvocab_merge_loop(table, base, **engine)
        from yabpe_tpu_torch.train.incremental import run_incremental_merge_loop

        self._log_route("incremental", limits)
        return run_incremental_merge_loop(table, base, **engine)

    def _log_route(self, route: str, why: str | None = None) -> None:
        self.route = route
        _LOG.info(
            "merge loop: %s%s", route,
            f" (past the merge kernels' limits: {why})" if why else "",
        )

    def _checkpoint_hooks(self):
        """(resume, saver) for checkpointed runs, (None, None) otherwise.

        ``resume`` is the loaded (merges_ids, steps_done) tuple or None;
        ``saver`` is an on_chunk callback that saves every
        ``checkpoint_every_chunks`` calls.
        """
        cfg = self.config
        if not cfg.checkpoint_dir:
            return None, None
        from yabpe_tpu_torch.train import checkpoint as ckpt

        resume = ckpt.load_checkpoint(cfg.checkpoint_dir, cfg)
        if resume is not None:
            _LOG.info("resuming from checkpoint at merge %d", resume[1])
        every = max(1, cfg.checkpoint_every_chunks)
        chunks_seen = [0]

        def saver(merges_ids, steps_done):
            chunks_seen[0] += 1
            if chunks_seen[0] % every == 0:
                ckpt.save_checkpoint(
                    cfg.checkpoint_dir, merges_ids, steps_done, cfg
                )

        return resume, saver

    def _should_use_hbm_sharded(
        self, table: WordTable, vocab_cap: int, processes: int
    ) -> bool:
        """Route a sharded run to the kernel-sharded loop: only with
        ``use_hbm_kernel=True`` and one vocab shard, as in the JAX trainer
        (``:446-483``). Past the loop's limits it raises ValueError, unless
        the data shards are too few to span the processes, which goes to
        the sharded loop."""
        from yabpe_tpu_torch.dist.hbm_sharded import hbm_sharded_applicable

        cfg = self.config
        if cfg.use_hbm_kernel is not True or (cfg.vocab_shards or 1) > 1:
            return False
        if not hbm_sharded_applicable(
            int(table.words.shape[0]),
            int(table.words.shape[1]),
            vocab_cap,
            data_shards=cfg.data_shards,
            processes=processes,
        ):
            if processes > cfg.data_shards:
                return False  # not enough shards to span the processes
            raise ValueError(
                "use_hbm_kernel=True with data_shards > 1 but the problem "
                "exceeds the sharded-HBM loop's limits (vocab <= 63488, "
                "word width <= 64, per-shard log plan)"
            )
        return True

    def _should_use_fused(self, table: WordTable, vocab_cap: int) -> bool:
        """Route a device problem to the small-vocabulary kernel K1.

        Counterpart of the JAX trainer's ``_should_use_fused``, with the
        same admission (``fused_applicable``, copied verbatim) so that both
        packages send the same problems to this kernel, words of any width
        included, and K1's own limits (``hbm_driver.kernel_limits(...,
        fused=True)``: pair mass below 2^31). ``False``
        never takes it, nor does a checkpointed run; ``True`` takes it or
        raises ValueError past either. Unlike the JAX package, auto
        (``None``) does not ask for a TPU: there the test keeps the Pallas
        kernel off backends where it would run interpreted, while here the
        kernel is the device route's own, on the card or as its plain twin
        on the CPU.
        """
        from yabpe_tpu_torch.train import hbm_driver
        from yabpe_tpu_torch.train.fused_driver import fused_applicable

        cfg = self.config
        if cfg.use_fused_kernel is False or cfg.checkpoint_dir:
            return False
        fits = fused_applicable(
            int(table.words.shape[0]),
            int(table.words.shape[1]),
            vocab_cap,
            max(table.width, 2),
        )
        limits = hbm_driver.kernel_limits(table, vocab_cap, fused=True)
        if cfg.use_fused_kernel is True:
            if limits is not None:
                raise ValueError(f"use_fused_kernel=True but {limits}")
            if not fits:
                raise ValueError(
                    "use_fused_kernel=True but the problem exceeds the "
                    "kernel's VMEM budget"
                )
        return fits and limits is None

    def _should_use_hbm(self, limits: str | None) -> bool:
        """Route a device problem to the large-vocabulary kernel K2: where
        it is within the kernels' limits, unless ``use_hbm_kernel`` is
        False; ``True`` past them raises ValueError, as in the JAX
        trainer (``:500-505``)."""
        cfg = self.config
        if cfg.use_hbm_kernel is False:
            return False
        if cfg.use_hbm_kernel is True and limits is not None:
            raise ValueError(
                f"use_hbm_kernel=True but the problem exceeds the HBM "
                f"kernel's limits: {limits}"
            )
        return limits is None

    def save(self, output_dir: str | Path) -> None:
        """Persist the trained model to disk (native latin-1 dialect)."""
        if not self._vocab:
            raise ValueError("Model has not been trained yet. Call train() first.")
        save_model(output_dir, self._vocab, self._merges, self.config.special_tokens)


__all__ = ["BBPETrainer"]
