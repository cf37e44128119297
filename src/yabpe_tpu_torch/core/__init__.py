"""Core data structures: vocab tables, padded words, lex keys."""

from yabpe_tpu_torch.core.vocab import Vocab
from yabpe_tpu_torch.core.wordtable import PAD, WordTable

__all__ = ["Vocab", "WordTable", "PAD"]
