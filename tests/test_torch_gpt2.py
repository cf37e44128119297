"""GPT-2's own 50,000-merge model through the port's tokenizer, on the CPU.

The merges are derived from tests/fixtures_gpt2/gpt2_vocab.json alone:
GPT-2's ids 256..50255 are its merge ranks in order, so BPE-encoding each
token's bytes with the merges derived before it splits it into that
rank's two parts. With them, ``encode``, ``encode_batch(device=True)``
(``compute_device="cpu"``) and ``encode_file`` (native host threads, and
the device scan) must give the golden ids of
tests/fixtures_gpt2/golden_encode/gpt2_golden.json: the 11 inline snippets
and the two special-token texts, with and without ``<|endoftext|>``, and
the JAX tokenizer's ids from the same model. The golden entries whose
texts are files outside the repository (address, german,
tinystories_sample, corpus_en) are left out. The two special-token texts
are the golden ``no_special`` ids decoded (their files are outside the
repository too). Every comparison is exact.
"""

from __future__ import annotations

import json

import pytest

from yabpe_tpu import BBPETokenizer as JaxTokenizer
from yabpe_tpu_torch import BBPETokenizer
from yabpe_tpu_torch.io import gpt2

from .common import LOCAL_FIXTURES

EOT = "<|endoftext|>"
SPECIAL_KEYS = ("special_trailing", "special_double")
MODES = ["with_special", "no_special"]


@pytest.fixture(scope="module")
def gpt2_model():
    vocab = gpt2.load_gpt2_vocab(LOCAL_FIXTURES / "gpt2_vocab.json")
    return vocab, gpt2.derive_gpt2_merges(vocab)


@pytest.fixture(scope="module")
def cases(gpt2_model):
    """[(text, {mode: golden ids})]: the snippets, then the two
    special-token texts."""
    golden = json.loads(
        (LOCAL_FIXTURES / "golden_encode" / "gpt2_golden.json").read_text(encoding="utf-8")
    )
    snippets = golden["snippets"]
    out = [
        (text, {"with_special": ws, "no_special": ns})
        for text, ws, ns in zip(snippets["texts"], snippets["with_special"], snippets["no_special"])
    ]
    plain = BBPETokenizer(*gpt2_model, [], compute_device="cpu")
    for key in SPECIAL_KEYS:
        entry = golden[key]
        out.append((plain.decode(entry["no_special"]), {m: entry[m] for m in MODES}))
    assert len(out) == 13
    return out


def _tokenizer(gpt2_model, mode: str) -> BBPETokenizer:
    return BBPETokenizer(*gpt2_model, [EOT] if mode == "with_special" else [],
                         compute_device="cpu")


def test_derived_merges_are_gpt2s(gpt2_model):
    vocab, merges = gpt2_model
    assert len(vocab) == 50257 and vocab[EOT.encode()] == 50256
    assert len(merges) == 50000
    assert all(vocab[a + b] == 256 + rank for rank, (a, b) in enumerate(merges))
    assert merges[:3] == [(b" ", b"t"), (b" ", b"a"), (b"h", b"e")]


@pytest.mark.parametrize("mode", MODES)
def test_encode_gives_the_golden_ids(gpt2_model, cases, mode):
    tok = _tokenizer(gpt2_model, mode)
    for text, want in cases:
        assert tok.encode(text) == want[mode], repr(text)
        assert tok.decode(want[mode]) == text, repr(text)


@pytest.mark.parametrize("mode", MODES)
def test_encode_batch_on_the_device_route_gives_the_golden_ids(gpt2_model, cases, mode):
    tok = _tokenizer(gpt2_model, mode)
    texts = [text for text, _ in cases]
    assert tok.encode_batch(texts, device=True) == [want[mode] for _, want in cases]
    encoder = tok._get_device_encoder(None)
    assert encoder is not None and encoder.stats["tiles"] > 0


@pytest.mark.parametrize("device", [False, True], ids=["host", "device"])
@pytest.mark.parametrize("mode", MODES)
def test_encode_file_gives_the_golden_ids(gpt2_model, cases, tmp_path, mode, device):
    tok = _tokenizer(gpt2_model, mode)
    for i, (text, want) in enumerate(cases):
        path = tmp_path / f"{i}.txt"
        path.write_bytes(text.encode("utf-8"))
        got = tok.encode_file(path, device=device)
        assert got.tolist() == want[mode], repr(text)
    if device:
        assert tok._get_device_encoder(None).stats["tiles"] > 0


@pytest.mark.parametrize("mode", MODES)
def test_ids_match_the_jax_tokenizer(gpt2_model, cases, mode):
    specials = [EOT] if mode == "with_special" else []
    port = _tokenizer(gpt2_model, mode)
    jax = JaxTokenizer(*gpt2_model, specials)
    texts = [text for text, _ in cases]
    for text in texts:
        assert port.encode(text) == jax.encode(text), repr(text)
    assert port.encode_batch(texts, device=True) == jax.encode_batch(texts, device=True)
