"""Trainer configuration.

Counterpart of yabpe_tpu/train/config.py: field-for-field parity with the
reference dataclass (its trainer.py:17-38), the engine knobs the port
acts on, with the JAX package's defaults, and ``device``. ``seed`` is
kept for interface compatibility; training is fully deterministic and
never uses it.
"""

from __future__ import annotations

from collections.abc import Sequence
from dataclasses import dataclass, field


@dataclass
class BBPETrainerConfig:
    """Configuration of a BBPE trainer.

    Attributes:
        vocab_size: Target vocabulary size, including special tokens.
        min_frequency: Minimum pair frequency for a merge to be considered.
        max_workers: Worker pool size for parallel corpus ingestion.
        chunk_size_bytes: Logical chunk size when splitting large corpora.
        seed: Unused; kept for interface compatibility.
        special_tokens: Tokens that must appear in the vocabulary and are
            pre-split as whole pre-tokens during ingestion.

        backend: "torch" runs the merge loop chosen by ``use_native_loop``
            (default); "numpy" runs the host oracle loop.
        merge_chunk_size: merge steps per call of the merge-loop kernel; the
            host reads the stop flag once per chunk.
        ingest_processes: use a process pool for the ``regex`` ingest path
            (the numpy backend without the native library); None = auto
            (processes for corpora over 8 MiB). Ignored by the native
            scanner, which releases the GIL and runs on threads.
        align_chunks_to_newline: end ingestion chunks at newlines so
            pre-tokens never straddle chunk boundaries (off for strict
            reference parity).
        data_shards: if > 1, shard the word table over this many data
            shards: the kernel-sharded loop (dist/hbm_sharded.py) with
            ``use_hbm_kernel=True``, else the sharded loop
            (dist/sharded.py); under ``torch.distributed`` the shards are
            spread over the processes. None/1 = one device.
        vocab_shards: if > 1 (with data_shards), keep the dense pair-count
            table as slabs of left-symbol rows ([V/nv, V] each) in the
            sharded loop.
        max_pair_table_bytes: guard rail for the dense [V, V] count table
            (per slab, after vocab sharding): a larger table raises
            ValueError. None (default): on a CUDA device the card decides,
            a table the device's free memory cannot hold raising
            RuntimeError (``hbm_driver.check_memory``: 40 GB for a 100k
            vocabulary fits an 80 GB card); elsewhere
            ``HOST_PAIR_TABLE_BYTES`` (11 GiB).
        count_strategy: how the fallback engines count pairs: "dense",
            "matmul" (the JAX package's MXU layout of the same counts; it
            must be exact, every possible count below 2^24, or raises
            ValueError) or "auto" ("dense" here). The counts, and so the
            merges, are the same.
        checkpoint_dir: where checkpointed training saves its merge record
            and resumes from (train/checkpoint.py, the JAX package's
            files). A checkpointed run never takes the small-vocabulary
            kernel.
        checkpoint_every_chunks: save every this many chunks (epochs on
            the data-sharded loop).
        use_fused_kernel: on the device route, run the merge loop on the
            small-vocabulary kernel (kernels/fused_loop.py) (True), never
            (False), or when the problem fits its admission, at any word
            width (None). True past its admission or its limits (ids in 16
            bits, pair mass below 2^31) raises ValueError. Results are
            identical either way.
        use_native_loop: True runs the native C++ host merge loop; None or
            False runs the device merge loop. Results are identical either
            way.
        use_hbm_kernel: with ``data_shards`` > 1, True runs the
            data-sharded loop, whose word shards go through the replay
            kernel (kernels/replay_emit.py); a problem past its limits
            raises ValueError. With one shard, the large-vocabulary kernel
            (kernels/hbm_loop.py) runs problems within the kernels' limits
            (None), always (True: past the limits, ValueError) or never
            (False: the fallback engines run them). Results are identical
            either way.
        spec_merges_per_round: merges per speculative epoch of the
            sharded loops. The kernel-sharded loop always runs epochs: 0 or
            1 there means 16. The sharded loop runs them (1-D meshes only;
            ignored with a warning when vocab_shards > 1) for values > 1;
            0 means 16 under ``torch.distributed`` with more than one
            process and off in one process; 1 is off. Results are
            identical either way.
        hbm_sharded_cps: cell-log capacity of the data-sharded loop, in
            rows of 128 cells per chain step past the first; a tuning knob
            (an overflowing step is never committed), not a correctness one.
        device: where the device merge loop runs: "cuda" (default) or "cpu".
            "cuda" without a CUDA device raises; it never falls back.
    """

    vocab_size: int = 32000
    min_frequency: int = 2
    max_workers: int = 8
    chunk_size_bytes: int = 8 * 1024 * 1024
    seed: int = 42
    special_tokens: Sequence[str] = field(
        default_factory=lambda: ["[PAD]", "[UNK]", "[BOS]", "[EOS]"]
    )

    backend: str = "torch"
    merge_chunk_size: int = 2048
    ingest_processes: bool | None = None
    align_chunks_to_newline: bool = False
    data_shards: int | None = None
    vocab_shards: int = 1
    max_pair_table_bytes: int | None = None
    count_strategy: str = "dense"
    checkpoint_dir: str | None = None
    checkpoint_every_chunks: int = 4
    use_fused_kernel: bool | None = None
    use_native_loop: bool | None = None
    use_hbm_kernel: bool | None = None
    spec_merges_per_round: int = 0
    hbm_sharded_cps: int = 64
    device: str = "cuda"


#: The dense table's cap off CUDA by default: 11 GiB admits GPT-2-scale
#: vocabularies (50,257 -> a 10.1 GB [V, V] table) while still catching
#: nonsense sizes.
HOST_PAIR_TABLE_BYTES = 11 * 1024 * 1024 * 1024

__all__ = ["HOST_PAIR_TABLE_BYTES", "BBPETrainerConfig"]
