"""Host side of the small-vocabulary merge-loop kernel (kernels/fused_loop).

Counterpart of yabpe_tpu/train/fused_driver.py. :func:`fused_applicable`
is that module's admission, copied verbatim, so that both packages send
the same problems to this kernel. :func:`fused_state_from_numpy` builds
the kernel's state from the numpy arrays of a word table and the base
vocabulary (the state JAX's ``init_state`` and ``init_counts`` build), and
:func:`run_fused_merge_loop` runs it chunk by chunk
(``hbm_driver.run_chunks``: one host sync per chunk to read the stop
flag).
"""

from __future__ import annotations

import numpy as np
import torch

from yabpe_tpu_torch.core.vocab import Vocab
from yabpe_tpu_torch.core.wordtable import WordTable
from yabpe_tpu_torch.kernels.fused_loop import FusedState, fused_merge_chunk
from yabpe_tpu_torch.train import hbm_driver
from yabpe_tpu_torch.utils.profiling import span

# Conservative VMEM budget for state + step temporaries (limit is 100 MB).
_VMEM_BUDGET = 48 * 1024 * 1024


def fused_applicable(num_rows: int, width: int, vocab_cap: int, byte_width: int) -> bool:
    words = num_rows * width * 4
    counts = vocab_cap * vocab_cap * 4
    token_bytes = vocab_cap * byte_width * 4
    # one-hot gather/scatter temporaries: ~4 copies of [A=64, N] + [N, W]
    temps = 4 * 64 * num_rows * 4 + 4 * words + 8 * counts
    return words + counts + token_bytes + temps < _VMEM_BUDGET


def fused_state_from_numpy(
    words: np.ndarray,
    freqs: np.ndarray,
    base_tokens: list[bytes],
    vocab_cap: int,
    device: str | torch.device,
    *,
    num_merges: int | None = None,
) -> FusedState:
    """Build the kernel state on ``device`` from a WordTable's ``words``
    [N, W] / ``freqs`` [N], the base vocabulary's token bytes and the
    vocabulary capacity: the tensors of
    ``hbm_driver.state_from_numpy`` (the [b0, b0] corner counts of
    ``hbm_driver.initial_corner_counts`` in a zeroed [V, V] table, and
    their exact row maxima) but ``stats``.

    ``num_merges`` sizes the merge record (default: vocab_cap - b0).
    """
    st = hbm_driver.state_from_numpy(
        words, freqs, base_tokens, vocab_cap, device, num_merges=num_merges
    )
    return FusedState(
        words=st.words,
        freqs=st.freqs,
        counts=st.counts,
        row_max=st.row_max,
        token_bytes=st.token_bytes,
        token_len=st.token_len,
        lex_rank=st.lex_rank,
        merges=st.merges,
        scalars=st.scalars,
    )


def run_fused_merge_loop(
    table: WordTable,
    base_vocab: Vocab,
    *,
    vocab_cap: int,
    num_merges: int,
    min_frequency: int,
    chunk_size: int = 256,
    device: str | torch.device = "cuda",
    on_chunk=None,
) -> np.ndarray:
    """Run the merge loop on the kernel; returns [num_merges, 3] int32 ids.

    Admission is K1's own in ``hbm_driver.admit(..., fused=True)``: total
    pair mass below 2^31 (the int32 table's exactness), words of any
    width, and the state within the device's free memory (the kernel's
    entry refuses ids past 16 bits). ``on_chunk(merges_ids, steps_done)``, when given, gets the
    merge record after every chunk.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but CUDA is not available")
    base_tokens = list(base_vocab.tokens())
    with span("yabpe.route.state"):
        hbm_driver.admit(
            table, max(vocab_cap, len(base_tokens)), num_merges,
            hbm_driver.byte_width(table.width, base_tokens), device, fused=True,
        )
        state = fused_state_from_numpy(
            table.words, table.freqs, base_tokens, vocab_cap, device,
            num_merges=num_merges,
        )
    return hbm_driver.run_chunks(
        fused_merge_chunk, state, num_merges=num_merges,
        min_frequency=min_frequency, chunk_size=chunk_size, on_chunk=on_chunk,
    )


__all__ = ["fused_applicable", "fused_state_from_numpy", "run_fused_merge_loop"]
