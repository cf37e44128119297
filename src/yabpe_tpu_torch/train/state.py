"""Vocabulary state of the merge loop, and the merge-record conversion.

Counterpart of yabpe_tpu/train/state.py for what the port's drivers need
outside the kernels: :class:`VocabState` (the token side of the JAX
package's ``TrainState``: its fields without ``words`` and ``freqs``,
which live in the kernels' word shards), :func:`vocab_update` (``:178``)
and :func:`merges_to_bytes` (``:280``).
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

from yabpe_tpu_torch.core import lexkey
from yabpe_tpu_torch.core.vocab import Vocab


@dataclass
class VocabState:
    """Token table of a merge loop, tensors on one device.

    Attributes:
        token_bytes: [V, L] int32 token byte strings, -1 padded.
        token_len: [V] int32 token byte lengths.
        lex_rank: [V] int32 dense lex rank among live tokens, -1 for free ids.
        next_id: 0-d int32, the first free token id.
        stopped: 0-d bool, set once a step found no pair to merge.
        merges: [M, 3] int32 (left, right, new id) per step, -1 where not
            taken; None where no record is kept (a speculative chain).
        num_done: 0-d int32, the steps taken.
    """

    token_bytes: torch.Tensor
    token_len: torch.Tensor
    lex_rank: torch.Tensor
    next_id: torch.Tensor
    stopped: torch.Tensor
    merges: torch.Tensor | None
    num_done: torch.Tensor

    @classmethod
    def initial(
        cls,
        base_tokens: list[bytes],
        vocab_cap: int,
        byte_width: int,
        num_merges: int,
        device: str | torch.device,
    ) -> "VocabState":
        """The state before the first merge: the base tokens at ids
        0..b0-1, the merge record all -1."""
        token_bytes, token_len = lexkey.initial_token_matrix(
            base_tokens, vocab_cap, byte_width
        )
        lex_rank = lexkey.initial_lex_ranks(base_tokens, vocab_cap)

        def put(a) -> torch.Tensor:
            return torch.tensor(a, dtype=torch.int32, device=device)

        return cls(
            token_bytes=put(token_bytes),
            token_len=put(token_len),
            lex_rank=put(lex_rank),
            next_id=put(len(base_tokens)),
            stopped=torch.tensor(False, device=device),
            merges=torch.full(
                (max(num_merges, 1), 3), -1, dtype=torch.int32, device=device
            ),
            num_done=put(0),
        )

    def speculative_copy(self) -> "VocabState":
        """A copy to run speculative steps on: no merge record."""
        return VocabState(
            **{
                f.name: getattr(self, f.name).clone()
                for f in fields(self)
                if f.name != "merges"
            },
            merges=None,
        )


def vocab_update(
    state: VocabState,
    left: torch.Tensor,
    right: torch.Tensor,
    do: torch.Tensor,
    stopped: torch.Tensor,
    step_index: int,
) -> torch.Tensor:
    """Token-table, lex-rank and merge-record maintenance for one step.

    Counterpart of yabpe_tpu/train/state.py::vocab_update, updating
    ``state`` **in place**. ``left``, ``right`` are 0-d id tensors, ``do``
    and ``stopped`` 0-d bools: where ``do`` is false nothing is grown and
    nothing recorded. Returns the merged symbol id as a 0-d tensor (the
    existing id when the merged bytes are already a live token: the dedup
    branch). Gathers, scatters and selects only, so a device caller never
    waits on the host.
    """
    vocab_cap = state.lex_rank.shape[0]
    merged, merged_len = lexkey.concat_token_bytes(
        state.token_bytes, state.token_len, left, right
    )
    less, equal = lexkey.rows_vs_query(state.token_bytes, merged)
    active = (
        torch.arange(vocab_cap, device=state.lex_rank.device) < state.next_id
    )
    eq_active = equal & active
    exists = eq_active.any()
    existing_id = eq_active.int().argmax().to(state.next_id.dtype)
    new_sym = torch.where(exists, existing_id, state.next_id)

    grow = do & ~exists
    # next_id < vocab_cap whenever a step grows the table (the driver runs
    # vocab_cap - b0 merges at most); the clamp keeps the index in range
    # for the steps that write nothing.
    slot = state.next_id.clamp(max=vocab_cap - 1).long().view(1)
    bumped, insert_rank = lexkey.insert_lex_rank(state.lex_rank, active, less)
    bumped.index_copy_(0, slot, insert_rank.view(1))
    state.lex_rank.copy_(torch.where(grow, bumped, state.lex_rank))
    state.token_bytes.index_copy_(
        0, slot,
        torch.where(grow, merged, state.token_bytes.index_select(0, slot)[0])[None],
    )
    state.token_len.index_copy_(
        0, slot,
        torch.where(grow, merged_len.to(state.token_len.dtype),
                    state.token_len.index_select(0, slot)),
    )
    state.next_id += grow.to(state.next_id.dtype)

    if state.merges is not None:
        row = state.merges[step_index]
        record = torch.stack([t.to(row.dtype) for t in (left, right, new_sym)])
        row.copy_(torch.where(do, record, row))
        state.num_done += do.to(state.num_done.dtype)
    state.stopped = stopped
    return new_sym


def merges_to_bytes(
    merges_ids: np.ndarray, base_vocab: Vocab
) -> tuple[Vocab, list[tuple[bytes, bytes]]]:
    """Convert the device merge record back to byte-string merges + vocab.

    Replays id-space merges on the host, growing a copy of the base vocab
    exactly as the device did (dedup included). Rows with a negative left
    id (steps never taken) end the record.
    """
    vocab = Vocab()
    for tok in base_vocab.tokens():
        vocab.add(tok)
    merges: list[tuple[bytes, bytes]] = []
    for left, right, new_sym in merges_ids:
        if left < 0:
            break
        lb = vocab.bytes_of(int(left))
        rb = vocab.bytes_of(int(right))
        got = vocab.add(lb + rb)
        if got != int(new_sym):
            raise AssertionError(
                f"host/device vocab divergence: merge {lb!r}+{rb!r} -> id {got} "
                f"on host but {int(new_sym)} on device"
            )
        merges.append((lb, rb))
    return vocab, merges


__all__ = ["VocabState", "merges_to_bytes", "vocab_update"]
