"""Tokenization: the host tokenizer API."""

from yabpe_tpu_torch.tok.tokenizer import BBPETokenizer

__all__ = ["BBPETokenizer"]
