"""Trained-model container.

Parity target: the reference library's trainer.py:41-52; the JAX
package's counterpart is yabpe_tpu/train/model.py.
"""

from __future__ import annotations

from collections.abc import Mapping, Sequence


class BBPEModel:
    """Container for a trained BBPE model.

    Attributes:
        vocab: token bytes -> token id.
        merges: merge pairs in creation order.
        special_tokens: special token strings.
    """

    def __init__(
        self,
        vocab: Mapping[bytes, int],
        merges: Sequence[tuple[bytes, bytes]],
        special_tokens: Sequence[str],
    ) -> None:
        self.vocab: dict[bytes, int] = dict(vocab)
        self.merges: list[tuple[bytes, bytes]] = list(merges)
        self.special_tokens: list[str] = list(special_tokens)


__all__ = ["BBPEModel"]
