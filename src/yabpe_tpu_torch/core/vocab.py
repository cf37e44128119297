"""Vocabulary: a bijection between token ids and token byte strings.

Id assignment parity target: the reference library's trainer.py:119-134
(base vocab: ids 0-255 are the single bytes with id == byte value, then
special tokens in config order as UTF-8 bytes, skipping duplicates) and
:296-300 (each merge appends its concatenation unless those bytes already
exist — the dedup branch).
"""

from __future__ import annotations

from collections.abc import Iterable, Sequence


class Vocab:
    """Growable id <-> bytes bijection.

    Unlike the reference's plain dict, this is the host twin of the device
    token table (``token_bytes``/``token_len`` arrays in the train state):
    ids are dense, append-only, and byte strings are unique.
    """

    def __init__(self) -> None:
        self._id_to_bytes: list[bytes] = []
        self._bytes_to_id: dict[bytes, int] = {}

    @classmethod
    def base(cls, special_tokens: Sequence[str] = ()) -> "Vocab":
        """256 single-byte tokens (id == byte value) + specials in order."""
        v = cls()
        for b in range(256):
            v.add(bytes([b]))
        for tok in special_tokens:
            v.add(tok.encode("utf-8"))
        return v

    @classmethod
    def from_id_map(cls, id_to_bytes: dict[int, bytes]) -> "Vocab":
        """Build from an external {id: bytes} map (ids must be dense 0..n-1)."""
        v = cls()
        for i in range(len(id_to_bytes)):
            if i not in id_to_bytes:
                raise ValueError(f"Vocab ids must be dense; missing id {i}")
            v.add(id_to_bytes[i])
        return v

    def add(self, token: bytes) -> int:
        """Return the id for ``token``, appending it if new."""
        existing = self._bytes_to_id.get(token)
        if existing is not None:
            return existing
        idx = len(self._id_to_bytes)
        self._id_to_bytes.append(token)
        self._bytes_to_id[token] = idx
        return idx

    def id_of(self, token: bytes) -> int | None:
        return self._bytes_to_id.get(token)

    def bytes_of(self, idx: int) -> bytes:
        return self._id_to_bytes[idx]

    def __len__(self) -> int:
        return len(self._id_to_bytes)

    def __contains__(self, token: bytes) -> bool:
        return token in self._bytes_to_id

    def tokens(self) -> Iterable[bytes]:
        return iter(self._id_to_bytes)

    def as_bytes_to_id(self) -> dict[bytes, int]:
        return dict(self._bytes_to_id)

    def as_id_to_bytes(self) -> dict[int, bytes]:
        return {i: b for i, b in enumerate(self._id_to_bytes)}

    def max_token_len(self) -> int:
        return max((len(b) for b in self._id_to_bytes), default=0)


__all__ = ["Vocab"]
