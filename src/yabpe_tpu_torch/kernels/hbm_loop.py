"""Merge-loop kernel over a device-resident [V, V] count table.

The port's counterpart of the TPU kernel
``yabpe_tpu/kernels/hbm_loop.py::_hbm_loop_kernel`` (its entry point is
``hbm_merge_chunk`` there too). It computes what that kernel computes,
over a layout chosen for the GPU; the kernels are CUDA C++ in
``csrc/hbm_loop.cu`` (per merge step one thread-block-cluster kernel and
one apply kernel) and their design note is at the top of that file.

The parts that live here:

- :class:`HbmState`, the state tensors (int32 but ``token_key``, one
  device);
- :func:`hbm_merge_chunk`, the wrapper: it runs one chunk of merge steps
  and updates the state **in place**. For CUDA tensors it launches the
  kernels (built on first use) and raises on any launch error; for CPU
  tensors, and only for them, it runs the plain twin. Steps below
  ``replay_until`` replay their preloaded rows of ``merges`` (checkpoint
  resume: the TPU kernel's replay mode) in place of the select;
- :func:`hbm_merge_chunk_reference`, the plain twin in torch ops. It is
  deliberately independent of the kernel's bookkeeping: its step,
  :func:`plain_merge_steps` (shared with the twin of
  ``kernels/fused_loop.py``), selects by an exact max over the whole
  table (:func:`exact_select`), applies merges with tensor ops and folds
  full-word deltas with ``index_add_``, and writes a new token's prefix
  key beside its bytes; then it recomputes ``row_max`` and ``block_max``
  exactly;
- :func:`cluster_select_reference`, the kernel's select round by round
  in torch (striped candidates, several verified per round, each
  verified row read through its block bounds, the acceptance rule,
  ``row_max`` and the blocks read tightened), and :func:`hbm_select_step`,
  which runs the kernel's select alone on the card. Tests hold the two
  to each other and the model to :func:`exact_select`; neither is on the
  training path.

``LAUNCHES["hbm_merge_chunk"]`` counts the wrapper's kernel launches (one
per chunk that reaches the card), so a run can show that it went through
the kernel; ``LAUNCHES["hbm_select_step"]`` counts the select entry's.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass, fields

import torch

from yabpe_tpu_torch.core import lexkey

# Layout of ``HbmState.scalars`` (csrc/hbm_loop.cu names the same slots).
NEXT_ID = 0
STOPPED = 1
NUM_DONE = 2
DIVERGED = 6  # 1 + the replayed step whose record the vocab disagrees with
N_SCALARS = 8

# Layout of ``HbmState.stats``: counters that the kernel adds to and the
# twin leaves alone (csrc/hbm_loop.cu's enum Stat). The STAT_NS_* slots
# are nanoseconds by the card's global timer that the step kernel's first
# CTA spends in each phase; they wrap at 2^32, so read them as
# differences modulo 2^32 over a chunk.
STAT_ROUNDS = 0  # verify rounds of the select
STAT_VERIFIED = 1  # rows read exactly by the select
STAT_NS_BOUND = 2  # bound passes
STAT_NS_VERIFY = 3  # verifies and acceptance
STAT_NS_COMPARE = 4  # merged bytes, dedup compare and lex rank
STAT_NS_VOCAB = 5  # vocab update and the record
STAT_NS_STEP = 6  # the whole step kernel
STAT_NS_BARRIER = 7  # the first round's first cluster barrier alone
STAT_REPLAYED = 8  # replayed steps, which add to none of the slots above
STAT_NS_REPLAY = 9  # the step kernel of the replayed steps, whole
STAT_BLOCKS_READ = 10  # column blocks the select's verifies read in full
STAT_TIE_ROWS = 11  # token rows the dedup compare read on a prefix-key tie
N_STATS = 12

#: Longest word (in symbols) the apply kernel of K2 (and K3) takes.
MAX_WORD_WIDTH = 64

#: Largest vocabulary K2 takes: its select keys hold ids and lex ranks
#: below 2^17 (csrc/select_keys.cuh's kRowKeyMaxVocab), which covers 100k
#: vocabularies. The K3 route keeps the JAX kernel's 63,488
#: (dist/hbm_sharded.py).
MAX_VOCAB_CAP = 1 << 17

#: csrc/select_keys.cuh's row key: count << 33 | (lex rank + 1) << 15 | slot.
_ROW_SLOT_BITS = 15
_ROW_COUNT_SHIFT = 33

#: CTAs in the select's thread-block cluster where a cluster of 16 fits.
CLUSTER_CTAS = 16

#: Columns of a count row per block of ``HbmState.block_max``
#: (csrc/merge_apply.cuh's kBlockCols): 4 KB of a row.
BLOCK_COLS = 1024

#: Warps of the step kernel's CTA: a verify reads at most this many blocks
#: in one pass without first looking for the row's bound.
VERIFY_WARPS = 8

#: Rows of at most this many blocks are verified whole, their block bounds
#: neither read nor tightened (csrc/hbm_loop.cu's kWholeBlocks: one 32 KB
#: batch of the whole-row read).
WHOLE_ROW_BLOCKS = 8

#: ``yabpe_hbm_select``'s output: (a, b, count, rounds, rows verified,
#: CTAs, blocks read).
_N_OUT = 7

#: Kernel launches by wrapper; a caller zeroes an entry to count a run.
LAUNCHES: dict[str, int] = {"hbm_merge_chunk": 0, "hbm_select_step": 0}


@dataclass
class HbmState:
    """Merge-loop state, int32 tensors but ``token_key`` on one device.

    Attributes:
        words: [N, W] symbol ids, -1 padded; updated in place.
        freqs: [N] word frequencies.
        counts: [V, V] exact pair counts.
        row_max: [V] upper bound on each row's max count (exact after a
            twin chunk).
        block_max: [V, block_count(V)] upper bound on the max count of
            each block of BLOCK_COLS columns of a row (exact after a twin
            chunk).
        token_bytes: [V, L] token byte strings, -1 padded.
        token_len: [V] token byte lengths.
        lex_rank: [V] dense lex rank among live tokens, -1 for free ids.
        token_key: [key_rows(V)] int64, each token's prefix key
            (``core/lexkey.py::prefix_keys``), 0 for free ids and the
            padding rows past V.
        merges: [M, 3] (left, right, new id) per step, -1 where not taken.
        scalars: [8] next_id, stopped, num_done, then per-step temporaries
            and ``DIVERGED``.
        stats: [12] the kernel's counters (verify rounds, rows verified,
            the step kernel's nanoseconds by phase, the replayed steps and
            their nanoseconds, the blocks the verifies read, the token rows
            the dedup compare read: ``STAT_*``); the twin leaves them as
            they are.
    """

    words: torch.Tensor
    freqs: torch.Tensor
    counts: torch.Tensor
    row_max: torch.Tensor
    block_max: torch.Tensor
    token_bytes: torch.Tensor
    token_len: torch.Tensor
    lex_rank: torch.Tensor
    token_key: torch.Tensor
    merges: torch.Tensor
    scalars: torch.Tensor
    stats: torch.Tensor

    def tensors(self) -> list[torch.Tensor]:
        return [getattr(self, f.name) for f in fields(self)]

    def clone(self) -> "HbmState":
        return HbmState(*(t.clone() for t in self.tensors()))

    def check(self) -> None:
        """Raise ValueError unless the tensors have the kernel's layout."""
        check_state(self)


def block_count(vocab_cap: int) -> int:
    """Column blocks of a count row: the width of ``HbmState.block_max``."""
    return -(-vocab_cap // BLOCK_COLS)


def key_rows(vocab_cap: int) -> int:
    """Rows of ``HbmState.token_key``: V rounded up to a multiple of 4, so
    that the step kernel's copy of a stripe's keys, whole 16 bytes, stays
    inside the tensor."""
    return -(-vocab_cap // 4) * 4


def exact_block_max(counts: torch.Tensor, block_cols: int = BLOCK_COLS) -> torch.Tensor:
    """[V, ceil(V / block_cols)] int32: the exact max count of each block of
    ``block_cols`` columns of each row of ``counts``."""
    v = counts.shape[1]
    return torch.stack(
        [counts[:, k:k + block_cols].amax(dim=1) for k in range(0, v, block_cols)], dim=1
    ).contiguous()


def check_state(state) -> None:
    """Raise ValueError unless a merge-loop state (this module's
    :class:`HbmState` or ``kernels.fused_loop.FusedState``) has the
    kernels' layout: contiguous int32 tensors (int64 ``token_key``) on one
    device, consistent shapes, and a word width of at least 2, at most
    MAX_WORD_WIDTH for an HbmState (K2's apply; K1, like the TPU kernel,
    takes any width)."""
    name = type(state).__name__
    n, w = state.words.shape
    v = state.counts.shape[0]
    shapes = {
        "freqs": (n,), "counts": (v, v), "row_max": (v,),
        "block_max": (v, block_count(v)),
        "token_len": (v,), "lex_rank": (v,), "token_key": (key_rows(v),),
        "scalars": (N_SCALARS,), "stats": (N_STATS,),
    }
    for f in fields(state):
        t = getattr(state, f.name)
        kind = "int64" if f.name == "token_key" else "int32"
        if t.dtype != getattr(torch, kind) or not t.is_contiguous():
            raise ValueError(f"{name}.{f.name} must be contiguous {kind}")
        if t.device != state.words.device:
            raise ValueError(f"{name} tensors must share one device")
        if f.name in shapes and tuple(t.shape) != shapes[f.name]:
            raise ValueError(
                f"{name}.{f.name} has shape {tuple(t.shape)}, "
                f"expected {shapes[f.name]}"
            )
    if state.token_bytes.shape[0] != v or state.merges.shape[1:] != (3,):
        raise ValueError(f"{name} token_bytes/merges shapes disagree")
    if w < 2:
        raise ValueError(f"word width {w} below 2")
    if isinstance(state, HbmState) and w > MAX_WORD_WIDTH:
        raise ValueError(f"word width {w} outside [2, {MAX_WORD_WIDTH}]")


def hbm_merge_chunk(
    state: HbmState,
    *,
    chunk_start: int,
    chunk_size: int,
    num_merges: int,
    min_frequency: int,
    replay_until: int = 0,
    _stage_keys: bool = True,
) -> None:
    """Run merge steps [chunk_start, chunk_start + chunk_size), capped at
    ``num_merges``, updating ``state`` in place.

    A step below ``replay_until`` replays its row of ``state.merges``: the
    pair comes from the record and everything but the select runs as in a
    live step. A record with a negative left id stops the loop; one whose
    ids are not live, or whose merged id differs from the vocab's, sets
    ``scalars[DIVERGED]`` to the step + 1 and stops
    (:func:`raise_on_divergence` reads it).

    CUDA tensors go through the CUDA kernels, on PyTorch's current stream
    and without a sync; CPU tensors through the twin. Any other device, a
    build failure or a launch failure raises. The step kernel stages its
    stripes' prefix keys in shared memory where the cluster has room for
    them (:func:`stages_keys`); ``_stage_keys=False``, a hook for tests,
    makes it read them from device memory, as on a card without the room.
    """
    state.check()
    device = state.words.device
    if device.type == "cpu":
        hbm_merge_chunk_reference(
            state,
            chunk_start=chunk_start,
            chunk_size=chunk_size,
            num_merges=num_merges,
            min_frequency=min_frequency,
            replay_until=replay_until,
        )
        return
    if device.type != "cuda":
        raise ValueError(f"hbm_merge_chunk runs on cuda or cpu, not {device}")
    step_end = min(chunk_start + chunk_size, num_merges)
    if step_end <= chunk_start:
        return
    if state.merges.shape[0] < step_end:
        raise ValueError("HbmState.merges has fewer rows than steps")
    _check_aligned(state.counts, state.row_max, state.lex_rank, state.token_bytes,
                   state.token_key)
    if state.token_bytes.shape[1] % 4:
        raise ValueError("HbmState.token_bytes width must be a multiple of 4")
    lib = _library()
    n, w = state.words.shape
    v, byte_width = state.token_bytes.shape
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.yabpe_hbm_merge_chunk(
            *(t.data_ptr() for t in state.tensors()),
            n, w, v, byte_width, chunk_start, step_end, min_frequency,
            replay_until, int(_stage_keys), stream,
        )
    _raise_on_error(lib, rc, "hbm_merge_chunk")
    LAUNCHES["hbm_merge_chunk"] += 1


def raise_on_divergence(scalars: list[int]) -> None:
    """Raise where a replayed step's record disagreed with the vocab
    (``scalars``: the state's scalars, read on the host)."""
    if scalars[DIVERGED]:
        raise AssertionError(
            f"checkpoint/vocab divergence at replayed step {scalars[DIVERGED] - 1}"
        )


def _check_aligned(*tensors: torch.Tensor) -> None:
    """The step kernel reads these with 16-byte loads or copies."""
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(
            "counts, row_max, lex_rank, token_bytes and token_key must be 16-byte aligned")


def _raise_on_error(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.yabpe_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc}: {msg}")


def cluster_ctas(vocab_cap: int, byte_width: int, device=None) -> int:
    """CTAs of the step kernel's cluster on this card for [vocab_cap,
    byte_width] vocab tensors: 16 where a cluster of 16 fits, else 8.
    Raises RuntimeError where no cluster fits."""
    return _cluster(vocab_cap, byte_width, device)[0]


def stages_keys(vocab_cap: int, byte_width: int, device=None) -> bool:
    """Whether the step kernel's cluster on this card has the shared memory
    to stage each stripe's prefix keys for [vocab_cap, byte_width] vocab
    tensors (else its dedup compare reads them from device memory).
    Raises RuntimeError where no cluster fits."""
    return _cluster(vocab_cap, byte_width, device)[1]


def _cluster(vocab_cap: int, byte_width: int, device) -> tuple[int, bool]:
    lib = _library()
    staged = ctypes.c_int(0)
    with torch.cuda.device(device):
        ctas = lib.yabpe_hbm_cluster_ctas(vocab_cap, byte_width, ctypes.byref(staged))
    _raise_on_error(lib, -ctas if ctas < 0 else 0, "cluster_ctas")
    return ctas, staged.value == 1


def hbm_select_step(
    counts: torch.Tensor,
    row_max: torch.Tensor,
    lex_rank: torch.Tensor,
    *,
    next_id: int,
    min_frequency: int,
    block_max: torch.Tensor | None = None,
    tally: dict[str, int] | None = None,
) -> tuple[int, int, int, int, int]:
    """One select of the merge step, for tests: the pair (a, b) with the
    highest count among the live ids [0, next_id), ties to the greatest
    lex rank of the row, then of the column.

    ``block_max`` [V, block_count(V)] bounds each row's column blocks
    (:class:`HbmState`); without it the exact block maxima of ``counts``
    are used. Tightens ``row_max`` and the blocks it reads in place as a
    step does and returns (a, b, count, verify rounds, CTAs); a = b = -1
    and count 0 when no count reaches ``max(min_frequency, 1)``.
    ``tally``, when given, accumulates the blocks read under
    ``blocks_read``. CUDA tensors go through the step kernel's select (one
    launch, then a sync to read the result); CPU tensors through
    :func:`cluster_select_reference` with :data:`CLUSTER_CTAS` stripes.
    """
    v = counts.shape[0]
    if block_max is None:
        block_max = exact_block_max(counts)
    for name, t in (("counts", counts), ("row_max", row_max), ("lex_rank", lex_rank),
                    ("block_max", block_max)):
        if t.dtype != torch.int32 or not t.is_contiguous() or t.device != counts.device:
            raise ValueError(f"{name} must be contiguous int32 on the device of counts")
    if counts.shape != (v, v) or row_max.shape != (v,) or lex_rank.shape != (v,):
        raise ValueError("counts must be [V, V], row_max and lex_rank [V]")
    if block_max.shape != (v, block_count(v)):
        raise ValueError(f"block_max must be [V, {block_count(v)}]")
    if not 0 < next_id <= v:
        raise ValueError(f"next_id {next_id} outside (0, {v}]")
    device = counts.device
    if device.type == "cpu":
        return (*cluster_select_reference(
            counts, row_max, lex_rank, next_id=next_id,
            min_frequency=min_frequency, cluster=CLUSTER_CTAS,
            block_max=block_max, tally=tally,
        ), CLUSTER_CTAS)
    if device.type != "cuda":
        raise ValueError(f"hbm_select_step runs on cuda or cpu, not {device}")
    _check_aligned(counts, row_max, lex_rank)
    lib = _library()
    scalars = torch.zeros(N_SCALARS, dtype=torch.int32, device=device)
    scalars[NEXT_ID] = next_id
    out = torch.zeros(_N_OUT, dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.yabpe_hbm_select(
            counts.data_ptr(), row_max.data_ptr(), block_max.data_ptr(),
            lex_rank.data_ptr(), scalars.data_ptr(), out.data_ptr(), v,
            min_frequency, stream,
        )
    _raise_on_error(lib, rc, "hbm_select_step")
    LAUNCHES["hbm_select_step"] += 1
    a, b, count, rounds, _, ctas, blocks = out.tolist()
    if tally is not None:
        tally["blocks_read"] = tally.get("blocks_read", 0) + blocks
    return a, b, count, rounds, ctas


@functools.cache
def _library() -> ctypes.CDLL:
    from yabpe_tpu_torch.kernels import _build

    lib = _build.load("hbm_loop")
    lib.yabpe_hbm_merge_chunk.restype = ctypes.c_int
    lib.yabpe_hbm_merge_chunk.argtypes = (
        [ctypes.c_void_p] * 12 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    )
    lib.yabpe_cuda_error_string.restype = ctypes.c_char_p
    lib.yabpe_cuda_error_string.argtypes = [ctypes.c_int]
    lib.yabpe_hbm_max_width.restype = ctypes.c_int
    lib.yabpe_hbm_max_width.argtypes = []
    lib.yabpe_hbm_cluster_ctas.restype = ctypes.c_int
    lib.yabpe_hbm_cluster_ctas.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)]
    lib.yabpe_hbm_select.restype = ctypes.c_int
    lib.yabpe_hbm_select.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    lib.yabpe_hbm_max_vocab.restype = ctypes.c_int
    lib.yabpe_hbm_max_vocab.argtypes = []
    lib.yabpe_hbm_block_cols.restype = ctypes.c_int
    lib.yabpe_hbm_block_cols.argtypes = []
    if lib.yabpe_hbm_max_width() != MAX_WORD_WIDTH:
        raise RuntimeError("csrc/hbm_loop.cu disagrees on MAX_WORD_WIDTH")
    if lib.yabpe_hbm_max_vocab() != MAX_VOCAB_CAP:
        raise RuntimeError("csrc/hbm_loop.cu disagrees on MAX_VOCAB_CAP")
    if lib.yabpe_hbm_block_cols() != BLOCK_COLS:
        raise RuntimeError("csrc/hbm_loop.cu disagrees on BLOCK_COLS")
    return lib


def hbm_merge_chunk_reference(
    state: HbmState,
    *,
    chunk_start: int,
    chunk_size: int,
    num_merges: int,
    min_frequency: int,
    replay_until: int = 0,
) -> None:
    """The plain twin of :func:`hbm_merge_chunk`, in torch ops on any
    device; updates ``state`` in place: :func:`plain_merge_steps`, then
    ``row_max`` and ``block_max`` recomputed exactly."""
    plain_merge_steps(
        state,
        chunk_start=chunk_start,
        chunk_size=chunk_size,
        num_merges=num_merges,
        min_frequency=min_frequency,
        replay_until=replay_until,
    )
    state.row_max.copy_(state.counts.amax(dim=1))
    state.block_max.copy_(exact_block_max(state.counts))


def plain_merge_steps(
    s,
    *,
    chunk_start: int,
    chunk_size: int,
    num_merges: int,
    min_frequency: int,
    replay_until: int = 0,
) -> None:
    """Merge steps [chunk_start, chunk_start + chunk_size), capped at
    ``num_merges``, in plain torch ops, on a merge-loop state (any object
    with the fields of :class:`HbmState` but ``row_max``, and but
    ``token_key`` for K1's); updates it in place. The step of both
    kernels' twins.

    Each step selects by an exact max over the whole table (ties to the
    greatest lex rank of the row, then of the column), stops when that
    count is below ``max(min_frequency, 1)``, grows the vocab (dedup,
    lex-rank insertion and, where the state keeps them, the new token's
    prefix key) and applies the merge to every word that holds
    the pair. A step below ``replay_until`` takes the pair from its row of
    ``merges`` instead, as :func:`hbm_merge_chunk` says.
    """
    v = s.counts.shape[0]
    scal = s.scalars.tolist()
    if scal[STOPPED]:
        return
    next_id, num_done = scal[NEXT_ID], scal[NUM_DONE]
    token_key = getattr(s, "token_key", None)  # K2's state has it, K1's not
    ids = torch.arange(v, device=s.counts.device)
    row_max = s.counts.amax(dim=1)
    for step in range(chunk_start, min(chunk_start + chunk_size, num_merges)):
        replay = step < replay_until
        if replay:
            a, b, record_c = s.merges[step].tolist()
            if a >= 0 and not (a < next_id and 0 <= b < next_id):
                scal[DIVERGED] = step + 1
            if a < 0 or scal[DIVERGED]:
                scal[STOPPED] = 1
                break
        else:
            a, b, best = exact_select(s.counts, row_max, s.lex_rank)
            if best < max(min_frequency, 1):
                scal[STOPPED] = 1
                break

        merged, merged_len = lexkey.concat_token_bytes(
            s.token_bytes, s.token_len, a, b
        )
        active = ids < next_id
        less, equal = lexkey.rows_vs_query(s.token_bytes, merged)
        equal &= active
        if bool(equal.any()):
            c = int(equal.int().argmax())
        else:
            c = next_id
            bumped, rank = lexkey.insert_lex_rank(s.lex_rank, active, less)
            bumped[c] = rank
            s.lex_rank.copy_(bumped)
            s.token_bytes[c] = merged
            s.token_len[c] = merged_len
            if token_key is not None:
                token_key[c] = lexkey.prefix_keys(merged)
            next_id += 1
        s.merges[step] = torch.tensor([a, b, c], dtype=torch.int32)
        num_done += 1
        if replay and c != record_c:  # stop before the apply
            scal[DIVERGED], scal[STOPPED] = step + 1, 1
            break

        _apply_merge(s, a, b, c)
        row_max = s.counts.amax(dim=1)

    scal[NEXT_ID], scal[NUM_DONE] = next_id, num_done
    s.scalars.copy_(torch.tensor(scal, dtype=torch.int32))


def exact_select(
    counts: torch.Tensor, row_max: torch.Tensor, lex_rank: torch.Tensor
) -> tuple[int, int, int]:
    """(a, b, count) of the highest count of ``counts``, ties to the
    greatest lex rank of the row, then of the column; ``row_max`` is the
    exact max of each row."""
    best = int(row_max.max())
    a = int(torch.where(row_max == best, lex_rank, -1).argmax())
    b = int(torch.where(counts[a] == best, lex_rank, -1).argmax())
    return a, b, best


def _pack_key(count, lex, slot):
    """K2's row key (csrc/select_keys.cuh's pack_row_key): count, then lex
    rank + 1, then the row's slot in its stripe, in 31 + 18 + 15 bits (ints
    or int64 tensors). Live rows hold distinct lex ranks, so the slot never
    decides between two of them."""
    return (count << _ROW_COUNT_SHIFT) | ((lex + 1) << _ROW_SLOT_BITS) | slot


def _key_count(key: int) -> int:
    return key >> _ROW_COUNT_SHIFT


def _key_slot(key: int) -> int:
    return key & ((1 << _ROW_SLOT_BITS) - 1)


def _stripe_rows(n: int, ctas: int) -> int:
    """Rows of a stripe: ceil(n / ctas) rounded up to a multiple of 4."""
    return (-(-n // ctas) + 3) // 4 * 4


def _stripe_bounds(n: int, ctas: int) -> list[tuple[int, int]]:
    """The rows [lo, hi) that each CTA of the select owns among the live
    rows [0, n): stripes of :func:`_stripe_rows` rows, the last ones short
    or empty."""
    size = _stripe_rows(n, ctas)
    return [(min(c * size, n), min(c * size + size, n)) for c in range(ctas)]


def cluster_select_reference(
    counts: torch.Tensor,
    row_max: torch.Tensor,
    lex_rank: torch.Tensor,
    *,
    next_id: int,
    min_frequency: int,
    cluster: int = CLUSTER_CTAS,
    block_max: torch.Tensor | None = None,
    block_cols: int = BLOCK_COLS,
    tally: dict[str, int] | None = None,
) -> tuple[int, int, int, int]:
    """The select of csrc/hbm_loop.cu's step kernel, round by round, in
    torch: a model of the kernel for tests, not a twin of the step.

    ``row_max`` is an upper bound on each row's max count (stale rows
    allowed); ``lex_rank`` is the dense lex rank of the live ids [0,
    next_id). Each round takes the top two bound keys (count, lex rank,
    slot in the stripe: :func:`_pack_key`) of each of ``cluster`` row
    stripes, stops when no bound reaches ``max(min_frequency, 1)``, and
    verifies each stripe's top row whose key beats the best exact key so
    far: its exact max over the live columns tightens ``row_max`` in
    place. The best exact key is accepted when it is at least every bound
    key of a row not verified in the round (a verified stripe's second
    key, another stripe's top key).

    With ``block_max`` (upper bounds on the max of each block of
    ``block_cols`` columns of a row, stale blocks allowed) a row is
    verified as the kernel's verify_row does it (:func:`_verify_blocks`),
    and the blocks it reads are tightened in place; without it the whole
    row is read (K1's select). ``tally``, when given, accumulates the
    blocks read under ``blocks_read``.

    Returns (a, b, count, rounds): the pair and its count, the column
    the greatest lex rank among the row's columns equal to the count; a
    = b = -1 and count 0 for a stop.
    """
    n = next_id
    thr = max(min_frequency, 1)
    lex = lex_rank[:n].long()
    slots = torch.arange(n, device=counts.device) % _stripe_rows(n, cluster)
    stripes = _stripe_bounds(n, cluster)
    low = (1 << _ROW_COUNT_SHIFT) - 1  # a key's lex rank and slot
    best = best_row = best_col = rounds = 0
    while True:
        rounds += 1
        keys = _pack_key(row_max[:n].long(), lex, slots)
        tops = [
            (keys[lo:hi].sort(descending=True).values[:2].tolist() + [0, 0])[:2]
            for lo, hi in stripes
        ]
        if _key_count(max(t1 for t1, _ in tops)) < thr:
            return -1, -1, 0, rounds
        unverified = 0
        verified = []
        for (lo, _), (t1, t2) in zip(stripes, tops):
            if t1 > best and _key_count(t1) > 0:
                verified.append((lo + _key_slot(t1), t1))
                unverified = max(unverified, t2)
            else:
                unverified = max(unverified, t1)
        for r, t1 in verified:
            row = counts[r, :n]
            if block_max is None:
                m = int(row.max())
                col = int(torch.where(row == m, lex, -1).argmax())
            else:
                m, col, read = _verify_blocks(
                    row, block_max[r], _key_count(t1), lex, block_cols
                )
                if tally is not None:
                    tally["blocks_read"] = tally.get("blocks_read", 0) + read
            row_max[r] = m
            exact = (m << _ROW_COUNT_SHIFT) | (t1 & low)
            if exact > best:
                best, best_row, best_col = exact, r, col
        if best >= unverified:
            break
    if _key_count(best) < thr:
        return -1, -1, 0, rounds
    return best_row, best_col, _key_count(best), rounds


def _verify_blocks(
    row: torch.Tensor, bounds: torch.Tensor, bound: int, lex: torch.Tensor,
    block_cols: int,
) -> tuple[int, int, int]:
    """(max, column, blocks read) of a count row's live columns ``row``
    [n], as csrc/hbm_loop.cu's verify_row finds them through the row's
    block bounds ``bounds`` and its own ``bound``. A row of at most
    :data:`WHOLE_ROW_BLOCKS` blocks is read whole, its bounds untouched.
    Else block 0 is read first; where at most :data:`VERIFY_WARPS` other
    live blocks have a bound that reaches max(block 0's max, 1), one pass
    reads them; else pass 1 reads each unread block whose bound reaches
    ``bound`` and, where the blocks read hold less, pass 2 every unread
    block whose bound reaches max(best, 1). Each block read is tightened in
    ``bounds`` to its exact max. The column is the greatest lex rank among
    the read columns equal to the max (0 for a row without a count)."""
    n = row.shape[0]
    live = -(-n // block_cols)
    if live <= WHOLE_ROW_BLOCKS:
        m = int(row.max())
        return m, int(torch.where(row == m, lex, -1).argmax()) if m > 0 else 0, live
    before = bounds[:live].clone()
    taken = torch.zeros(live, dtype=torch.bool, device=row.device)
    taken[0] = True
    bounds[0] = best = int(row[:block_cols].max())
    theta = max(best, 1)
    if int((before >= theta)[1:].sum()) > VERIFY_WARPS and theta < max(bound, 1):
        theta = max(bound, 1)
    while True:
        chosen = ~taken & (before >= theta)
        for k in chosen.nonzero()[:, 0].tolist():
            bounds[k] = m = int(row[k * block_cols:(k + 1) * block_cols].max())
            best = max(best, m)
        taken |= chosen
        if max(best, 1) >= theta:
            break
        theta = max(best, 1)
    if best <= 0:
        return 0, 0, int(taken.sum())
    read = taken.repeat_interleave(block_cols)[:n]
    col = int(torch.where(read & (row == best), lex, -1).argmax())
    return best, col, int(taken.sum())


def _pairs(words: torch.Tensor, freqs: torch.Tensor, mask: torch.Tensor | None = None):
    """(left, right, frequency) of every adjacent pair of ``words``, or of
    those where ``mask`` [n, w - 1] is set."""
    left, right = words[:, :-1], words[:, 1:]
    valid = (left >= 0) & (right >= 0)
    if mask is not None:
        valid &= mask
    return left[valid], right[valid], freqs[:, None].expand_as(left)[valid]


def merge_rows(
    words: torch.Tensor, freqs: torch.Tensor, a: int, b: int, c: int,
    *, window: bool = False,
):
    """Leftmost non-overlapping (a, b) -> c, in place, in every word of
    ``words`` [N, W] that holds the pair.

    Returns None when no word holds it, else the delta cells (left, right,
    weight): every old pair at -freq and every new pair at +freq of each
    changed word or, with ``window``, only the pairs of its changed window:
    from the pair before the first merge to the pair after the last one
    (the cells that the CUDA apply step of ``csrc/merge_apply.cuh`` emits,
    in the same number).
    Either way they sum to the same net delta.
    """
    hit = (words[:, :-1] == a) & (words[:, 1:] == b)
    rows = hit.any(dim=1).nonzero()[:, 0]
    if rows.numel() == 0:
        return None
    old = words[rows]
    hit = hit[rows]
    n, w = old.shape
    # A match is taken unless its left symbol is the right symbol of the
    # match taken just before it.
    take = torch.zeros_like(hit)
    prev = torch.zeros_like(hit[:, 0])
    for k in range(w - 1):
        prev = hit[:, k] & ~prev
        take[:, k] = prev
    new = old.clone()
    new[:, :-1][take] = c
    keep = new >= 0
    keep[:, 1:] &= ~take
    pos = keep.long().cumsum(dim=1) - 1
    row_idx = torch.arange(n, device=words.device)[:, None].expand(n, w)
    out = torch.full_like(old, -1)
    out[row_idx[keep], pos[keep]] = new[keep]
    words[rows] = out

    freqs = freqs[rows]
    old_mask = new_mask = None
    if window:
        first = take.int().argmax(dim=1)
        last = (w - 2) - take.flip(1).int().argmax(dim=1)
        q_last = pos.gather(1, last[:, None])[:, 0]
        lo = (first - 1).clamp(min=0)[:, None]
        k = torch.arange(w - 1, device=words.device)[None, :]
        old_hi = torch.minimum(last + 1, (old >= 0).sum(dim=1) - 2)[:, None]
        new_hi = torch.minimum(q_last, (out >= 0).sum(dim=1) - 2)[:, None]
        old_mask = (k >= lo) & (k <= old_hi)
        new_mask = (k >= lo) & (k <= new_hi)
    old_l, old_r, old_f = _pairs(old, freqs, old_mask)
    new_l, new_r, new_f = _pairs(out, freqs, new_mask)
    return (
        torch.cat([old_l, new_l]),
        torch.cat([old_r, new_r]),
        torch.cat([-old_f, new_f]),
    )


def _apply_merge(s, a: int, b: int, c: int) -> None:
    """Leftmost non-overlapping (a, b) -> c in every word that holds the
    pair, and the matching count deltas."""
    applied = merge_rows(s.words, s.freqs, a, b, c)
    if applied is None:
        return
    left, right, deltas = applied
    v = s.counts.shape[0]
    cells = left.long() * v + right.long()
    s.counts.view(-1).index_add_(0, cells, deltas)
