"""Mid-training checkpoint and deterministic resume of the merge loop.

Counterpart of yabpe_tpu/train/checkpoint.py, with the same files, so a
checkpoint written by either package resumes in the other. Training is
deterministic and the merge record is the whole of its state, so a
checkpoint is the [num_merges, 3] id record and a fingerprint of the
config: ``merge_state.npz`` (``merges``, ``steps_done``) and
``meta.json`` (``steps_done``, ``fingerprint``, ``format`` 1).

The engines resume by replaying the record onto the freshly ingested word
table: :func:`resume_state` here for the fallback engines
(train/incremental.py, train/bigvocab.py), the merge kernel's replay mode
for its driver (train/hbm_driver.py), and replayed epochs for the
data-sharded loop (dist/hbm_sharded.py). The port runs in one process,
so there is no process-index test before a save.
"""

from __future__ import annotations

import hashlib
import json
import os
import zipfile
from dataclasses import asdict
from pathlib import Path

import numpy as np
import torch

from yabpe_tpu_torch.core.vocab import Vocab
from yabpe_tpu_torch.core.wordtable import WordTable
from yabpe_tpu_torch.kernels.merge_apply import apply_pair_merge
from yabpe_tpu_torch.train.state import TrainState, VocabState, init_state


def config_fingerprint(config) -> str:
    """Hash of the semantically relevant trainer config fields (the JAX
    package's, so both give the same hash for the same values)."""
    fields = asdict(config)
    relevant = {
        k: fields[k]
        for k in ("vocab_size", "min_frequency", "special_tokens")
    }
    blob = json.dumps(relevant, sort_keys=True, default=list)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def save_checkpoint(
    ckpt_dir: str | Path, merges_ids: np.ndarray, steps_done: int, config
) -> None:
    """Persist the merge record atomically: the npz goes to a tmp file
    named by the pid, so no two writers interleave inside one file, and
    ``replace`` puts it in place."""
    path = Path(ckpt_dir)
    path.mkdir(parents=True, exist_ok=True)
    tmp = path / f"merge_state.tmp.{os.getpid()}.npz"
    np.savez(tmp, merges=merges_ids, steps_done=np.int64(steps_done))
    tmp.replace(path / "merge_state.npz")
    meta = {
        "steps_done": steps_done,
        "fingerprint": config_fingerprint(config),
        "format": 1,
    }
    (path / "meta.json").write_text(json.dumps(meta))


def load_checkpoint(
    ckpt_dir: str | Path, config
) -> tuple[np.ndarray, int] | None:
    """(merges_ids, steps_done), or None when the checkpoint is absent,
    torn, or written for another config."""
    path = Path(ckpt_dir)
    meta_file = path / "meta.json"
    state_file = path / "merge_state.npz"
    if not meta_file.exists() or not state_file.exists():
        return None
    try:
        meta = json.loads(meta_file.read_text())
        if meta.get("fingerprint") != config_fingerprint(config):
            return None
        with np.load(state_file) as data:
            return data["merges"], int(data["steps_done"])
    except (
        json.JSONDecodeError, OSError, ValueError, KeyError, EOFError,
        zipfile.BadZipFile,
    ):
        # A torn or corrupt checkpoint (killed mid-write before the atomic
        # replace, a truncated npz) starts afresh instead of failing.
        return None


def _replay(words: torch.Tensor, records: np.ndarray) -> torch.Tensor:
    """Apply a [k, 3] (left, right, new_sym) record to the word table; a
    record with a negative left id is skipped."""
    for left, right, new_sym in records.tolist():
        if left >= 0:
            words = apply_pair_merge(words, left, right, new_sym)
    return words


def resume_state(
    table: WordTable,
    base_vocab: Vocab,
    vocab_cap: int,
    num_merges: int,
    merges_ids: np.ndarray,
    steps_done: int,
    device: str | torch.device,
) -> TrainState:
    """The training state as of ``steps_done`` merges, on ``device``.

    Raises AssertionError where the record's merged id is not the one the
    vocabulary gives (a checkpoint from another corpus or vocabulary).
    """
    # Rebuild the grown vocabulary on the host, as the device did.
    vocab = Vocab()
    for tok in base_vocab.tokens():
        vocab.add(tok)
    for left, right, new_sym in merges_ids[:steps_done]:
        if left < 0:
            break
        got = vocab.add(vocab.bytes_of(int(left)) + vocab.bytes_of(int(right)))
        if got != int(new_sym):
            raise AssertionError("checkpoint/vocab divergence")

    state = init_state(table, base_vocab, vocab_cap, num_merges, device)
    tokens = list(vocab.tokens())
    fresh = VocabState.initial(
        tokens, vocab_cap, int(state.vocab.token_bytes.shape[1]), num_merges, device
    )
    records = np.asarray(merges_ids[:steps_done], dtype=np.int32)
    fresh.merges[:steps_done] = torch.as_tensor(records, device=device)
    fresh.num_done.fill_(int((records[:, 0] >= 0).sum()))
    return TrainState(
        words=_replay(state.words, records), freqs=state.freqs, vocab=fresh
    )


__all__ = [
    "config_fingerprint",
    "load_checkpoint",
    "resume_state",
    "save_checkpoint",
]
