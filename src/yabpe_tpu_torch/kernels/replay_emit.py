"""Replay of a merge chain over one word shard, logging delta cells.

The port's counterpart of the TPU kernel
``yabpe_tpu/kernels/replay_emit.py::_replay_emit_kernel`` (its entry point
is ``replay_emit_chunk`` there too), the building block of the
data-sharded merge loop (``dist/hbm_sharded.py``): each shard replays the
epoch's speculative chain over its words in one call and, instead of
folding the count deltas into a table, logs every changed-window cell in
its step's cell log. The logs are what the shards exchange. The kernel is
CUDA C++ in ``csrc/replay_emit.cu``, one word-major launch per call; its
design note is at the top of that file.

Layout. The shard is the port's word table, ``words`` [N, W] int32 (-1
padded) and ``freqs`` [N] int32, not the JAX package's packed i16 rows,
so every id below the vocabulary cap fits and there is no ``wide`` mode.
The chain is [K, 3] int32 rows (a, b, c); a row with a < 0 is skipped.
The logs keep the JAX units: three [cps0 + (K-1)*cps, 128] int32 arrays
(left, right, weight); step 0 owns rows [0, cps0), step j > 0 rows
[cps0 + (j-1)*cps, cps0 + j*cps). ``cursor[j]`` is the number of slots
step j took: its cells are its first ``min(cursor[j], capacity)`` slots,
and the kernel leaves the slots past them unwritten (the JAX kernel and
the twin clear them to left = -1). ``ok[j]`` is 0 where step j's cells
passed its capacity.

Three parts live here:

- :func:`replay_emit_chunk`, the wrapper. It returns new tensors and
  leaves the shard it is given as it was. For CUDA tensors it launches
  the kernel (built on first use) and raises on any launch error; for CPU
  tensors, and only for them, it runs the plain twin;
- :func:`replay_emit_chunk_reference`, the plain twin in torch ops: the
  apply of ``kernels/hbm_loop.py::merge_rows`` with the changed window's
  cells sent to the log, the same cells in the same number as the kernel,
  so that both flag the same overflows;
- the JAX package's log plan (:func:`max_log_rows` and what it reads),
  kept verbatim as arithmetic so that the sharded loop sizes its logs as
  the JAX loop does.

Counters, each a caller zeroes to count a run: ``CALLS`` the wrapper's
calls that reach the card, ``LAUNCHES`` its kernel launches (one per such
call) and ``MEMSETS`` its memsets (one of 2K ints per such call, zeroing
``cursor`` and ``ok``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from yabpe_tpu_torch.kernels.hbm_loop import MAX_WORD_WIDTH, merge_rows

#: Wrapper calls, kernel launches and memsets that reached the card, by
#: wrapper; a caller zeroes an entry to count a run.
CALLS: dict[str, int] = {"replay_emit_chunk": 0}
LAUNCHES: dict[str, int] = {"replay_emit_chunk": 0}
MEMSETS: dict[str, int] = {"replay_emit_chunk": 0}

#: Cells per log row.
LANES = 128

#: Longest chain a call takes (the kernel keeps the chain in shared memory).
MAX_CHAIN_STEPS = 2048

# ---- The JAX package's log plan (yabpe_tpu/kernels/replay_emit.py:48-79),
# copied as arithmetic: the TPU kernel's VMEM budget, which the sharded
# loop's capacity plan reads. Nothing on the GPU is bounded by it.

#: Emission-stage rows of the TPU kernel.
STAGE_ROWS = 256

#: The TPU kernel's VMEM ceiling (bytes).
VMEM_LIMIT_BYTES = 122 * 1024 * 1024


def replay_vmem_estimate(nr: int, wl: int, rows: int) -> int:
    """VMEM plan in bytes of the TPU kernel for ``nr`` packed rows of
    ``wl`` lanes and ``rows`` log rows."""
    return (
        2 * nr * wl * 2          # words in + aliased out VMEM windows
        + 3 * rows * 128 * 4     # cell logs
        + nr * 128 * 4 + nr * 4  # flags + per-row any-flag
        + 8 * wl * 2             # gather window
        + 3 * STAGE_ROWS * 128 * 4  # stage
    )


def max_log_rows(nr: int, wl: int, headroom: float = 0.9) -> int:
    """Largest total cell-log row count whose TPU VMEM plan fits; a
    multiple of 8, <= 0 when the shard alone exceeds the plan."""
    budget = int(VMEM_LIMIT_BYTES * headroom) - replay_vmem_estimate(nr, wl, 0)
    return (budget // (3 * 128 * 4)) // 8 * 8


# ---- The wrapper, the twin and their checks.


def log_rows(num_steps: int, cps: int, cps0: int) -> int:
    """Rows of each cell log for a chain of ``num_steps`` steps."""
    return cps0 + (num_steps - 1) * cps


def step_slots(step: int, cps: int, cps0: int) -> tuple[int, int]:
    """(first slot, slot count) of ``step``'s part of a flattened log."""
    if step == 0:
        return 0, cps0 * LANES
    return (cps0 + (step - 1) * cps) * LANES, cps * LANES


def _check(words, freqs, chain, cps, cps0) -> None:
    if words.dim() != 2 or not 2 <= words.shape[1] <= MAX_WORD_WIDTH:
        raise ValueError(
            f"words must be [N, W] with 2 <= W <= {MAX_WORD_WIDTH}, got "
            f"{tuple(words.shape)}"
        )
    if freqs.shape != words.shape[:1] or chain.dim() != 2 or chain.shape[1] != 3:
        raise ValueError("freqs must be [N] and chain [K, 3]")
    if chain.shape[0] < 1:
        raise ValueError("the chain needs at least one step")
    for name, t in (("words", words), ("freqs", freqs), ("chain", chain)):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous int32")
        if t.device != words.device:
            raise ValueError("words, freqs and chain must share one device")
    if cps <= 0 or cps % 8 or cps0 <= 0 or cps0 % 8:
        raise ValueError("cps/cps0 must be positive multiples of 8")
    if chain.shape[0] > MAX_CHAIN_STEPS:
        raise ValueError(f"the chain has more than {MAX_CHAIN_STEPS} steps")


def _outputs(words, num_steps, cps, cps0):
    """(words', log_l, log_r, log_w, flags): ``flags`` is [2K], cursor then
    ok, so that one memset zeroes both."""
    rows = log_rows(num_steps, cps, cps0)
    kw = dict(dtype=torch.int32, device=words.device)
    return (
        torch.empty_like(words),
        torch.empty((rows, LANES), **kw),
        torch.empty((rows, LANES), **kw),
        torch.empty((rows, LANES), **kw),
        torch.empty((2 * num_steps,), **kw),
    )


def replay_emit_chunk(
    words: torch.Tensor,
    freqs: torch.Tensor,
    chain: torch.Tensor,
    *,
    cps: int = 64,
    cps0: int | None = None,
) -> tuple[torch.Tensor, ...]:
    """Apply ``chain`` to the shard, logging each step's delta cells.

    Returns ``(words', log_l, log_r, log_w, ok, cursor)``: the shard after
    the chain (a new tensor), the three [cps0 + (K-1)*cps, 128] logs, the
    [K] flags and the [K] slot counts. Step j's cells are its first
    ``min(cursor[j], capacity)`` slots; read nothing past them
    (:func:`step_live`). ``cps0`` defaults to 4 * cps, as in the JAX
    package. CUDA tensors go through the CUDA kernel on PyTorch's current
    stream without a sync; CPU tensors through the twin. Any other device,
    a build failure or a launch failure raises.
    """
    if cps0 is None:
        cps0 = 4 * cps
    _check(words, freqs, chain, cps, cps0)
    device = words.device
    if device.type == "cpu":
        return replay_emit_chunk_reference(words, freqs, chain, cps=cps, cps0=cps0)
    if device.type != "cuda":
        raise ValueError(f"replay_emit_chunk runs on cuda or cpu, not {device}")
    lib = _library()
    n, w = words.shape
    k = chain.shape[0]
    *out, flags = _outputs(words, k, cps, cps0)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.yabpe_replay_emit_chunk(
            words.data_ptr(), freqs.data_ptr(), chain.data_ptr(),
            *(t.data_ptr() for t in out), flags.data_ptr(),
            n, w, k, cps, cps0, stream,
        )
    if rc != 0:
        msg = lib.yabpe_replay_error_string(rc).decode()
        raise RuntimeError(f"replay_emit_chunk: CUDA error {rc}: {msg}")
    CALLS["replay_emit_chunk"] += 1
    MEMSETS["replay_emit_chunk"] += 1
    LAUNCHES["replay_emit_chunk"] += 1
    return (*out, flags[k:], flags[:k])


@functools.cache
def _library() -> ctypes.CDLL:
    from yabpe_tpu_torch.kernels import _build

    lib = _build.load("replay_emit")
    lib.yabpe_replay_emit_chunk.restype = ctypes.c_int
    lib.yabpe_replay_emit_chunk.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    )
    lib.yabpe_replay_error_string.restype = ctypes.c_char_p
    lib.yabpe_replay_error_string.argtypes = [ctypes.c_int]
    lib.yabpe_replay_max_width.restype = ctypes.c_int
    lib.yabpe_replay_max_width.argtypes = []
    if lib.yabpe_replay_max_width() != MAX_WORD_WIDTH:
        raise RuntimeError("csrc/replay_emit.cu disagrees on MAX_WORD_WIDTH")
    return lib


def replay_emit_chunk_reference(
    words: torch.Tensor,
    freqs: torch.Tensor,
    chain: torch.Tensor,
    *,
    cps: int,
    cps0: int,
) -> tuple[torch.Tensor, ...]:
    """The plain twin of :func:`replay_emit_chunk`, in torch ops on any
    device; the shard it is given is left as it was.

    Each active step applies its merge with ``merge_rows(window=True)``
    and writes the changed window's cells to the step's slots in order; a
    step with more cells than slots gets ok = 0 and keeps only its first
    cells. ``cursor[j]`` is the step's cell count; the slots past it are
    cleared (left = right = -1, weight 0), as the JAX kernel leaves them.
    """
    num_steps = chain.shape[0]
    out_words, log_l, log_r, log_w, flags = _outputs(words, num_steps, cps, cps0)
    ok, cursor = flags[num_steps:], flags[:num_steps]
    out_words.copy_(words)
    log_l.fill_(-1)
    log_r.fill_(-1)
    log_w.zero_()
    ok.fill_(1)
    cursor.zero_()
    flat = (log_l.view(-1), log_r.view(-1), log_w.view(-1))
    for j, (a, b, c) in enumerate(chain.tolist()):
        if a < 0:
            continue
        step_cells = merge_rows(out_words, freqs, a, b, c, window=True)
        if step_cells is None:
            continue
        first, cap = step_slots(j, cps, cps0)
        count = step_cells[0].numel()
        cursor[j] = count
        if count > cap:
            ok[j] = 0
        kept = min(count, cap)
        for log, values in zip(flat, step_cells):
            log[first : first + kept] = values[:kept]
    return out_words, log_l, log_r, log_w, ok, cursor


def step_live(cursor: torch.Tensor, step: int, *, cps: int, cps0: int) -> torch.Tensor:
    """[count] bool over step ``step``'s slots (``step_slots``): True for
    the slots below ``min(cursor[step], capacity)``, the step's cells.
    ``cursor`` is [K], or [S, K] for S shards' logs, giving [S, count]."""
    count = step_slots(step, cps, cps0)[1]
    slots = torch.arange(count, device=cursor.device)
    return slots < cursor[..., step : step + 1]


def step_net_delta(
    log_l: torch.Tensor,
    log_r: torch.Tensor,
    log_w: torch.Tensor,
    step: int,
    *,
    cursor: torch.Tensor | None,
    cps: int,
    cps0: int,
    vocab_cap: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Net count delta of one step of a log: (flat cells ``left *
    vocab_cap + right``, sorted, and their summed weights), zero sums
    dropped. Two logs of the same step agree when these agree, whatever
    the order of their cells.

    The step's cells are the slots below ``min(cursor[step], capacity)``
    (:func:`step_live`), whatever the slots past them hold. ``cursor=None``
    reads a log whose empty slots are cleared to left = -1 (the JAX
    kernel's, which leaves no cursor) by that mark instead."""
    first, count = step_slots(step, cps, cps0)
    left = log_l.reshape(-1)[first : first + count].long()
    right = log_r.reshape(-1)[first : first + count].long()
    weight = log_w.reshape(-1)[first : first + count].long()
    live = left >= 0 if cursor is None else step_live(cursor, step, cps=cps, cps0=cps0)
    cells, inverse = torch.unique(left[live] * vocab_cap + right[live], return_inverse=True)
    sums = torch.zeros_like(cells).index_add_(0, inverse, weight[live])
    keep = sums != 0
    return cells[keep], sums[keep]


__all__ = [
    "CALLS",
    "LANES",
    "LAUNCHES",
    "MAX_CHAIN_STEPS",
    "MEMSETS",
    "STAGE_ROWS",
    "VMEM_LIMIT_BYTES",
    "log_rows",
    "max_log_rows",
    "replay_emit_chunk",
    "replay_emit_chunk_reference",
    "replay_vmem_estimate",
    "step_live",
    "step_net_delta",
    "step_slots",
]
