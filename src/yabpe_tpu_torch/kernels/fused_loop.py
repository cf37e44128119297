"""Small-vocabulary merge-loop kernel: a whole chunk in one launch.

The port's counterpart of the TPU kernel
``yabpe_tpu/kernels/fused_loop.py::_merge_loop_kernel`` (its entry point is
``fused_merge_chunk`` there too). It computes what that kernel computes:
``chunk_size`` whole merge steps with all state on the device, each one a
select of the highest count over the full [V, V] table. The kernel is
CUDA C++ in ``csrc/fused_loop.cu``, one persistent launch of one
thread-block cluster per chunk with a lazy select over a maintained row
max; its design note is at the top of that file. Like the TPU kernel it
takes words of any width: past :data:`NARROW_WIDTH` symbols its apply
works in place in device memory, and where the token bytes do not fit the
first CTA's shared memory they stay in device memory
(:func:`token_layout`).

The parts that live here:

- :class:`FusedState`, the state tensors (all int32, one device): the
  fields of ``kernels.hbm_loop.HbmState`` without ``stats``, at any word
  width >= 2;
- :func:`fused_merge_chunk`, the wrapper: it runs one chunk of merge
  steps and updates the state **in place**. For CUDA tensors it launches
  the kernel (built on first use; its launch shape queried once per
  process and problem shape) and raises on any launch error; for CPU
  tensors, and only for them, it runs the plain twin;
- :func:`fused_merge_chunk_reference`, the plain twin: the step of
  ``kernels.hbm_loop.plain_merge_steps``, whose selection is the
  full-table max that the kernel's lazy select finds, then ``row_max``
  recomputed exactly;
- :func:`fused_select_step`, the kernel's select alone (tests hold it to
  ``kernels.hbm_loop.cluster_select_reference`` with
  :data:`SELECT_STRIPES` stripes), and :func:`rank_search_reference`, the
  kernel's dedup and insertion search in torch (tests hold it to the
  twin's walk over every live token). Neither is on the training path.

``LAUNCHES["fused_merge_chunk"]`` counts the wrapper's kernel launches (one
per chunk that reaches the card), so a run can show that it went through
the kernel; ``LAUNCHES["fused_select_step"]`` counts the select entry's.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass, fields

import torch

from yabpe_tpu_torch.core import lexkey
from yabpe_tpu_torch.kernels.hbm_loop import (
    MAX_WORD_WIDTH,
    check_state,
    cluster_select_reference,
    plain_merge_steps,
)

#: Widest word of the kernel's narrow apply (the one K2 and K3 share,
#: per-thread arrays); wider words take its in-place apply.
NARROW_WIDTH = MAX_WORD_WIDTH

#: Where the kernel's first CTA keeps the token bytes: in its shared
#: memory, or in device memory where they do not fit there.
TOKEN_LAYOUTS = ("shared", "global")

#: Kernel launches by wrapper; a caller zeroes an entry to count a run.
LAUNCHES: dict[str, int] = {"fused_merge_chunk": 0, "fused_select_step": 0}

#: Stripes of the kernel's select: one per warp of its first CTA.
SELECT_STRIPES = 16


@dataclass
class FusedState:
    """Merge-loop state, int32 tensors on one device.

    Attributes:
        words: [N, W] symbol ids, -1 padded; updated in place.
        freqs: [N] word frequencies.
        counts: [V, V] exact pair counts.
        row_max: [V] upper bound on each row's max count (exact after a
            twin chunk).
        token_bytes: [V, L] token byte strings, -1 padded.
        token_len: [V] token byte lengths.
        lex_rank: [V] dense lex rank among live tokens, -1 for free ids.
        merges: [M, 3] (left, right, new id) per step, -1 where not taken.
        scalars: [8] next_id, stopped, num_done; the rest unused.
    """

    words: torch.Tensor
    freqs: torch.Tensor
    counts: torch.Tensor
    row_max: torch.Tensor
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
    _layout: str | None = None,
) -> None:
    """Run merge steps [chunk_start, chunk_start + chunk_size), capped at
    ``num_merges``, updating ``state`` in place.

    CUDA tensors go through the CUDA kernel, on PyTorch's current stream
    and without a sync; CPU tensors through the twin. Any other device, a
    build failure or a launch failure raises. The layout of the token
    bytes is :func:`token_layout`'s; ``_layout``, a hook for tests, forces
    one of :data:`TOKEN_LAYOUTS` ("shared" where the bytes do not fit
    raises).
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
    n, w = state.words.shape
    v, byte_width = state.token_bytes.shape
    layout = token_layout(v, byte_width, device) if _layout is None else _layout
    if layout not in TOKEN_LAYOUTS:
        raise ValueError(f"layout must be one of {TOKEN_LAYOUTS}, got {layout!r}")
    ctas = cluster_ctas(n, v, byte_width, device, width=w, _layout=layout)
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.yabpe_fused_merge_chunk(
            *(t.data_ptr() for t in state.tensors()),
            n, w, v, byte_width, chunk_start, step_end, min_frequency, ctas,
            TOKEN_LAYOUTS.index(layout), stream,
        )
    _raise_on_error(lib, rc, "fused_merge_chunk")
    LAUNCHES["fused_merge_chunk"] += 1


def _raise_on_error(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.yabpe_fused_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc}: {msg}")


def _device_index(device) -> int:
    device = torch.device("cuda" if device is None else device)
    return torch.cuda.current_device() if device.index is None else device.index


def token_layout(vocab_cap: int, byte_width: int, device=None) -> str:
    """Where the kernel keeps [vocab_cap, byte_width] token bytes on a
    CUDA ``device``: "shared" where they fit its first CTA's shared memory
    as u16, else "global". Queried once per process and shape."""
    return _token_layout(_device_index(device), vocab_cap, byte_width)


def cluster_ctas(
    n_words: int, vocab_cap: int, byte_width: int, device=None, *,
    width: int = 2, _layout: str | None = None,
) -> int:
    """CTAs of the kernel's cluster for ``n_words`` words of ``width``
    symbols and [vocab_cap, byte_width] vocab tensors in
    :func:`token_layout`'s layout (``_layout`` forces one, as in
    :func:`fused_merge_chunk`) on a CUDA ``device``: enough that every word
    has a thread, at most 16, fewer where a cluster that large does not
    fit. Queried once per process and shape."""
    index = _device_index(device)
    layout = _layout or _token_layout(index, vocab_cap, byte_width)
    return _cluster_ctas(index, n_words, max(width, 2), vocab_cap, byte_width, layout)


@functools.cache
def _prepare(device_index: int) -> None:
    """The kernel's function attributes, once per process and device."""
    lib = _library()
    with torch.cuda.device(device_index):
        _raise_on_error(lib, lib.yabpe_fused_prepare(), "fused_merge_chunk set-up")


@functools.cache
def _token_layout(device_index: int, vocab_cap: int, byte_width: int) -> str:
    _prepare(device_index)
    lib = _library()
    with torch.cuda.device(device_index):
        rc = lib.yabpe_fused_token_layout(vocab_cap, byte_width)
    _raise_on_error(lib, -rc if rc < 0 else 0, "fused_merge_chunk layout query")
    return TOKEN_LAYOUTS[rc]


@functools.cache
def _cluster_ctas(
    device_index: int, n_words: int, width: int, vocab_cap: int, byte_width: int, layout: str,
) -> int:
    _prepare(device_index)
    lib = _library()
    with torch.cuda.device(device_index):
        ctas = lib.yabpe_fused_cluster_ctas(
            n_words, width, vocab_cap, byte_width, TOKEN_LAYOUTS.index(layout)
        )
    _raise_on_error(lib, -ctas if ctas < 0 else 0, "fused_merge_chunk cluster query")
    return ctas


def fused_select_step(
    counts: torch.Tensor,
    row_max: torch.Tensor,
    lex_rank: torch.Tensor,
    *,
    next_id: int,
    min_frequency: int,
) -> tuple[int, int, int, int]:
    """One select of the merge step, for tests: the pair (a, b) with the
    highest count among the live ids [0, next_id), ties to the greatest
    lex rank of the row, then of the column.

    Tightens ``row_max`` in place as a step does and returns (a, b,
    count, verify rounds); a = b = -1 and count 0 when no count reaches
    ``max(min_frequency, 1)``. CUDA tensors go through the kernel's select
    (one launch, then a sync to read the result); CPU tensors through
    ``cluster_select_reference`` with :data:`SELECT_STRIPES` stripes.
    """
    v = counts.shape[0]
    for name, t in (("counts", counts), ("row_max", row_max), ("lex_rank", lex_rank)):
        if t.dtype != torch.int32 or not t.is_contiguous() or t.device != counts.device:
            raise ValueError(f"{name} must be contiguous int32 on the device of counts")
    if counts.shape != (v, v) or row_max.shape != (v,) or lex_rank.shape != (v,):
        raise ValueError("counts must be [V, V], row_max and lex_rank [V]")
    if not 0 < next_id <= v:
        raise ValueError(f"next_id {next_id} outside (0, {v}]")
    device = counts.device
    if device.type == "cpu":
        return cluster_select_reference(
            counts, row_max, lex_rank, next_id=next_id,
            min_frequency=min_frequency, cluster=SELECT_STRIPES,
        )
    if device.type != "cuda":
        raise ValueError(f"fused_select_step runs on cuda or cpu, not {device}")
    _prepare(device.index if device.index is not None else torch.cuda.current_device())
    lib = _library()
    out = torch.zeros(4, dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.yabpe_fused_select(
            counts.data_ptr(), row_max.data_ptr(), lex_rank.data_ptr(),
            out.data_ptr(), next_id, v, min_frequency, stream,
        )
    _raise_on_error(lib, rc, "fused_select_step")
    LAUNCHES["fused_select_step"] += 1
    a, b, count, rounds = out.tolist()
    return a, b, count, rounds


@functools.cache
def _library() -> ctypes.CDLL:
    from yabpe_tpu_torch.kernels import _build

    lib = _build.load("fused_loop")
    lib.yabpe_fused_merge_chunk.restype = ctypes.c_int
    lib.yabpe_fused_merge_chunk.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    )
    lib.yabpe_fused_select.restype = ctypes.c_int
    lib.yabpe_fused_select.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    )
    lib.yabpe_fused_error_string.restype = ctypes.c_char_p
    lib.yabpe_fused_error_string.argtypes = [ctypes.c_int]
    for name in ("yabpe_fused_narrow_width", "yabpe_fused_select_stripes",
                 "yabpe_fused_prepare"):
        getattr(lib, name).restype = ctypes.c_int
        getattr(lib, name).argtypes = []
    lib.yabpe_fused_token_layout.restype = ctypes.c_int
    lib.yabpe_fused_token_layout.argtypes = [ctypes.c_int] * 2
    lib.yabpe_fused_cluster_ctas.restype = ctypes.c_int
    lib.yabpe_fused_cluster_ctas.argtypes = [ctypes.c_int] * 5
    if lib.yabpe_fused_narrow_width() != NARROW_WIDTH:
        raise RuntimeError("csrc/fused_loop.cu disagrees on NARROW_WIDTH")
    if lib.yabpe_fused_select_stripes() != SELECT_STRIPES:
        raise RuntimeError("csrc/fused_loop.cu disagrees on SELECT_STRIPES")
    return lib


def fused_merge_chunk_reference(
    state: FusedState,
    *,
    chunk_start: int,
    chunk_size: int,
    num_merges: int,
    min_frequency: int,
) -> None:
    """The plain twin of :func:`fused_merge_chunk`, in torch ops on any
    device; updates ``state`` in place: ``kernels.hbm_loop.
    plain_merge_steps``, then ``row_max`` recomputed exactly."""
    plain_merge_steps(
        state,
        chunk_start=chunk_start,
        chunk_size=chunk_size,
        num_merges=num_merges,
        min_frequency=min_frequency,
    )
    state.row_max.copy_(state.counts.amax(dim=1))


def rank_search_reference(
    token_bytes: torch.Tensor,
    lex_rank: torch.Tensor,
    merged: torch.Tensor,
    next_id: int,
) -> tuple[int, int]:
    """The kernel's dedup and insertion search, in torch, for tests: (the
    live id whose bytes equal ``merged`` or -1, the number of live tokens
    below ``merged``), by a binary search over the lex ranks of the live
    ids [0, next_id) through the inverse array rank -> id, one token
    compare per level."""
    rank_id = torch.empty(next_id, dtype=torch.long)
    rank_id[lex_rank[:next_id].long().cpu()] = torch.arange(next_id)
    lo, hi, eq = 0, next_id, -1
    while lo < hi:
        mid = (lo + hi) // 2
        row = token_bytes[int(rank_id[mid])]
        less, equal = lexkey.rows_vs_query(row[None, :], merged)
        if bool(equal[0]):
            eq = int(rank_id[mid])
        if bool(less[0]):
            lo = mid + 1
        else:
            hi = mid
    return eq, lo


__all__ = [
    "LAUNCHES",
    "NARROW_WIDTH",
    "SELECT_STRIPES",
    "TOKEN_LAYOUTS",
    "FusedState",
    "cluster_ctas",
    "fused_merge_chunk",
    "fused_merge_chunk_reference",
    "fused_select_step",
    "rank_search_reference",
    "token_layout",
]
