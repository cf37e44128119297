"""yabpe-tpu's PyTorch/CUDA port: byte-level BPE training on an NVIDIA GPU.

The same public surface as the JAX package ``yabpe_tpu``, for the parts
ported so far:

- :class:`BBPETrainer`       — train a byte-level BPE vocabulary from files.
- :class:`BBPETrainerConfig` — trainer configuration, plus ``device``.
- :class:`BBPEModel`         — container for a trained model.
- :class:`BBPETokenizer`     — encode/decode with a trained or loaded model.

The merge loop runs as hand-written CUDA kernels over state in device
memory (``csrc/fused_loop.cu`` for small vocabularies, ``csrc/hbm_loop.cu``
for large ones); ingestion and host encoding are the native C++ library
in ``native/``, and the batched device encoder a merge-rank scan in torch
(``tok/device_encode.py``). This package imports torch and numpy, never JAX and never
the JAX package.
"""

from yabpe_tpu_torch.tok.tokenizer import BBPETokenizer
from yabpe_tpu_torch.train.config import BBPETrainerConfig
from yabpe_tpu_torch.train.model import BBPEModel
from yabpe_tpu_torch.train.trainer import BBPETrainer

__version__ = "0.1.0"

__all__ = [
    "BBPETokenizer",
    "BBPETrainer",
    "BBPETrainerConfig",
    "BBPEModel",
    "__version__",
]
