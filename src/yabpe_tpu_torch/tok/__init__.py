"""Tokenization: the tokenizer API, whole-file encoding and the batched
device encoder."""

from yabpe_tpu_torch.tok.tokenizer import BBPETokenizer

__all__ = ["BBPETokenizer"]
