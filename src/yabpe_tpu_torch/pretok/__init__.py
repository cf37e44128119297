"""Host-side pre-tokenization: GPT-2 pattern, chunking and ingestion.

The pattern functions import ``regex`` only when called, so this package
imports where ``regex`` is absent (the native scanner ingests there).
"""

from yabpe_tpu_torch.pretok.patterns import (
    GPT2_SPLIT_PATTERN,
    compile_gpt2_pattern,
    compile_special_splitter,
    compile_trainer_pattern,
)
from yabpe_tpu_torch.pretok.ingest import count_pretokens

__all__ = [
    "GPT2_SPLIT_PATTERN",
    "compile_gpt2_pattern",
    "compile_special_splitter",
    "compile_trainer_pattern",
    "count_pretokens",
]
