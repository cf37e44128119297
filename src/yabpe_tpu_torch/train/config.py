"""Trainer configuration.

Counterpart of yabpe_tpu/train/config.py: field-for-field parity with the
reference dataclass (its trainer.py:17-38), the engine knobs the port
acts on so far, and ``device``. The JAX package's TPU engine knobs
(``count_strategy``, ``use_hbm_kernel``,
``spec_merges_per_round``, ``hbm_sharded_cps``, ``ingest_processes``,
``checkpoint_every_chunks``) have no counterpart here. ``seed`` is kept
for interface compatibility; training is fully deterministic and never
uses it.
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
        align_chunks_to_newline: end ingestion chunks at newlines so
            pre-tokens never straddle chunk boundaries (off for strict
            reference parity).
        data_shards, vocab_shards: sharded training; values above 1 are not
            ported yet and raise NotImplementedError.
        max_pair_table_bytes: guard rail for the dense [V, V] count table.
        checkpoint_dir: checkpointed training; not ported yet, so a value
            raises NotImplementedError.
        use_fused_kernel: on the device route, run the merge loop on the
            small-vocabulary kernel (kernels/fused_loop.py) (True), never
            (False), or when the problem fits its admission (None). True
            past the admission raises ValueError. Results are identical
            either way.
        use_native_loop: True runs the native C++ host merge loop; None or
            False runs the device merge loop. Results are identical either
            way.
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
    align_chunks_to_newline: bool = False
    data_shards: int | None = None
    vocab_shards: int = 1
    # 11 GB admits GPT-2-scale vocabularies (50,257 -> a 10.1 GB [V, V]
    # table) while still catching nonsense sizes.
    max_pair_table_bytes: int = 11 * 1024 * 1024 * 1024
    checkpoint_dir: str | None = None
    use_fused_kernel: bool | None = None
    use_native_loop: bool | None = None
    device: str = "cuda"


__all__ = ["BBPETrainerConfig"]
