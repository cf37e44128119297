"""Small-vocabulary merge-loop kernel: a whole chunk in one launch.

The port's counterpart of the TPU kernel
``yabpe_tpu/kernels/fused_loop.py::_merge_loop_kernel`` (its entry point is
``fused_merge_chunk`` there too). It computes what that kernel computes:
``chunk_size`` whole merge steps with all state on the device, each one a
select over the full [V, V] table. The kernel is CUDA C++ in
``csrc/fused_loop.cu``, one persistent cooperative launch per chunk; its
design note is at the top of that file.

Three parts live here:

- :class:`FusedState`, the state tensors (all int32, one device): the
  fields of ``kernels.hbm_loop.HbmState`` without ``row_max``;
- :func:`fused_merge_chunk`, the wrapper: it runs one chunk of merge
  steps and updates the state **in place**. For CUDA tensors it launches
  the kernel (built on first use) and raises on any launch error,
  ``cudaErrorCooperativeLaunchTooLarge`` included; for CPU tensors, and
  only for them, it runs the plain twin;
- :func:`fused_merge_chunk_reference`, the plain twin: the step of
  ``kernels.hbm_loop.plain_merge_steps``, whose selection is the
  full-table max that the kernel computes.

``LAUNCHES["fused_merge_chunk"]`` counts the wrapper's kernel launches (one
per chunk that reaches the card), so a run can show that it went through
the kernel.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass, fields

import torch

from yabpe_tpu_torch.kernels.hbm_loop import (
    MAX_WORD_WIDTH,
    check_state,
    plain_merge_steps,
)

#: Kernel launches by wrapper; a caller zeroes an entry to count a run.
LAUNCHES: dict[str, int] = {"fused_merge_chunk": 0}


@dataclass
class FusedState:
    """Merge-loop state, int32 tensors on one device.

    Attributes:
        words: [N, W] symbol ids, -1 padded; updated in place.
        freqs: [N] word frequencies.
        counts: [V, V] exact pair counts.
        token_bytes: [V, L] token byte strings, -1 padded.
        token_len: [V] token byte lengths.
        lex_rank: [V] dense lex rank among live tokens, -1 for free ids.
        merges: [M, 3] (left, right, new id) per step, -1 where not taken.
        scalars: [8] next_id, stopped, num_done; the rest unused.
    """

    words: torch.Tensor
    freqs: torch.Tensor
    counts: torch.Tensor
    token_bytes: torch.Tensor
    token_len: torch.Tensor
    lex_rank: torch.Tensor
    merges: torch.Tensor
    scalars: torch.Tensor

    def tensors(self) -> list[torch.Tensor]:
        return [getattr(self, f.name) for f in fields(self)]

    def clone(self) -> "FusedState":
        return FusedState(*(t.clone() for t in self.tensors()))

    def check(self) -> None:
        """Raise ValueError unless the tensors have the kernel's layout."""
        check_state(self)


def fused_merge_chunk(
    state: FusedState,
    *,
    chunk_start: int,
    chunk_size: int,
    num_merges: int,
    min_frequency: int,
) -> None:
    """Run merge steps [chunk_start, chunk_start + chunk_size), capped at
    ``num_merges``, updating ``state`` in place.

    CUDA tensors go through the CUDA kernel, on PyTorch's current stream
    and without a sync; CPU tensors through the twin. Any other device, a
    build failure or a launch failure raises.
    """
    state.check()
    device = state.words.device
    if device.type == "cpu":
        fused_merge_chunk_reference(
            state,
            chunk_start=chunk_start,
            chunk_size=chunk_size,
            num_merges=num_merges,
            min_frequency=min_frequency,
        )
        return
    if device.type != "cuda":
        raise ValueError(f"fused_merge_chunk runs on cuda or cpu, not {device}")
    step_end = min(chunk_start + chunk_size, num_merges)
    if step_end <= chunk_start:
        return
    if state.merges.shape[0] < step_end:
        raise ValueError("FusedState.merges has fewer rows than steps")
    lib = _library()
    n, w = state.words.shape
    v, byte_width = state.token_bytes.shape
    with torch.cuda.device(device):
        slots = torch.empty(
            lib.yabpe_fused_slots_bytes(), dtype=torch.uint8, device=device
        )
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.yabpe_fused_merge_chunk(
            *(t.data_ptr() for t in state.tensors()), slots.data_ptr(),
            n, w, v, byte_width, chunk_start, step_end, min_frequency, stream,
        )
    if rc != 0:
        msg = lib.yabpe_fused_error_string(rc).decode()
        raise RuntimeError(f"fused_merge_chunk: CUDA error {rc}: {msg}")
    LAUNCHES["fused_merge_chunk"] += 1


def grid_blocks(vocab_cap: int, byte_width: int) -> int:
    """Blocks of the kernel's cooperative grid on the current CUDA device:
    co-resident blocks per SM (at the shared memory these widths need)
    times the SM count."""
    blocks = _library().yabpe_fused_grid_blocks(vocab_cap, byte_width)
    if blocks < 0:
        raise RuntimeError(f"fused_merge_chunk: CUDA error {-blocks} in the occupancy query")
    return blocks


@functools.cache
def _library() -> ctypes.CDLL:
    from yabpe_tpu_torch.kernels import _build

    lib = _build.load("fused_loop")
    lib.yabpe_fused_merge_chunk.restype = ctypes.c_int
    lib.yabpe_fused_merge_chunk.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    )
    lib.yabpe_fused_error_string.restype = ctypes.c_char_p
    lib.yabpe_fused_error_string.argtypes = [ctypes.c_int]
    for name in ("yabpe_fused_max_width", "yabpe_fused_slots_bytes"):
        getattr(lib, name).restype = ctypes.c_int
        getattr(lib, name).argtypes = []
    lib.yabpe_fused_grid_blocks.restype = ctypes.c_int
    lib.yabpe_fused_grid_blocks.argtypes = [ctypes.c_int, ctypes.c_int]
    if lib.yabpe_fused_max_width() != MAX_WORD_WIDTH:
        raise RuntimeError("csrc/fused_loop.cu disagrees on MAX_WORD_WIDTH")
    return lib


def fused_merge_chunk_reference(
    state: FusedState,
    *,
    chunk_start: int,
    chunk_size: int,
    num_merges: int,
    min_frequency: int,
    tally: dict[str, int] | None = None,
) -> None:
    """The plain twin of :func:`fused_merge_chunk`, in torch ops on any
    device; updates ``state`` in place. ``tally`` is that of
    ``kernels.hbm_loop.plain_merge_steps``."""
    plain_merge_steps(
        state,
        chunk_start=chunk_start,
        chunk_size=chunk_size,
        num_merges=num_merges,
        min_frequency=min_frequency,
        tally=tally,
    )


__all__ = [
    "LAUNCHES",
    "FusedState",
    "fused_merge_chunk",
    "fused_merge_chunk_reference",
    "grid_blocks",
]
