"""The port's host tokenizer (yabpe_tpu_torch.BBPETokenizer) against the
JAX package's, on one saved model: the port trainer's output on the 5 MB
TinyStories fixture at vocab 1000, trained on the CPU. Every comparison is
exact: the same ids, the same decoded text, the same files."""

from __future__ import annotations

import json

import pytest

from yabpe_tpu import BBPETokenizer as JaxTokenizer
from yabpe_tpu.io import gpt2 as jax_gpt2
from yabpe_tpu_torch import BBPETokenizer, BBPETrainer, BBPETrainerConfig
from yabpe_tpu_torch.io import gpt2

from .common import DATA, LOCAL_FIXTURES

SPECIALS = ["<|endoftext|>"]
DATA_FILES = ["empty", "large", "multiline", "sample", "simple", "unicode"]
SNIPPETS = json.loads(
    (LOCAL_FIXTURES / "golden_encode" / "gpt2_golden.json").read_text(encoding="utf-8")
)["snippets"]["texts"]


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory, tinystories_5m):
    trainer = BBPETrainer(BBPETrainerConfig(
        vocab_size=1000, min_frequency=1, max_workers=1,
        chunk_size_bytes=1 << 30, special_tokens=SPECIALS, device="cpu",
    ))
    trainer.train([tinystories_5m])
    out = tmp_path_factory.mktemp("tok") / "model"
    trainer.save(out)
    return out


def _texts(source: str, tinystories_5m) -> list[str]:
    if source == "snippets":
        return SNIPPETS
    if source == "tinystories_prefix":
        with open(tinystories_5m, encoding="utf-8") as f:
            return [f.read(200_000)]
    return [(DATA / f"{source}.txt").read_text(encoding="utf-8")]


def _pair(model_dir, with_specials: bool):
    port = BBPETokenizer.from_file(model_dir)
    jax = JaxTokenizer.from_file(model_dir)
    if with_specials:
        return port, jax
    return (
        BBPETokenizer(port._vocab, port._merges, []),
        JaxTokenizer(jax._vocab, jax._merges, []),
    )


@pytest.mark.parametrize("with_specials", [True, False], ids=["specials", "no_specials"])
@pytest.mark.parametrize("source", ["snippets", *DATA_FILES, "tinystories_prefix"])
def test_ids_match_jax_tokenizer(model_dir, tinystories_5m, source, with_specials):
    port, jax = _pair(model_dir, with_specials)
    for text in _texts(source, tinystories_5m):
        ids = port.encode(text)
        assert ids == jax.encode(text), text[:80]
        assert port.decode(ids) == text


def test_regex_path_matches_native_path(model_dir, tinystories_5m, monkeypatch):
    """Without the native library the tokenizer pre-tokenizes with the
    regex pattern and encodes word by word: the same ids."""
    from yabpe_tpu_torch import native

    texts = SNIPPETS + _texts("unicode", None) + [_texts("tinystories_prefix", tinystories_5m)[0][:20_000]]
    want = [BBPETokenizer.from_file(model_dir).encode(t) for t in texts]
    tok = BBPETokenizer.from_file(model_dir)
    monkeypatch.setattr(native, "available", lambda: False)
    assert [tok.encode(t) for t in texts] == want
    assert tok._native_encoder is None


def test_host_surface_matches_jax(model_dir):
    port, jax = _pair(model_dir, True)
    assert port.vocab_size == jax.vocab_size
    assert port.special_tokens == jax.special_tokens == SPECIALS
    assert port.get_vocab() == jax.get_vocab()
    assert port.encode_batch(SNIPPETS) == jax.encode_batch(SNIPPETS)
    assert port.decode_batch(port.encode_batch(SNIPPETS)) == SNIPPETS
    pieces = ["Once upon a time", " there was", "<|endoftext|>", "a cat."]
    assert list(port.encode_iterable(pieces)) == list(jax.encode_iterable(pieces))
    assert port.decode([10**6, *port.encode("hi")]) == "hi"
    assert port.cache_info().startswith("hits=")
    port.clear_cache()
    assert port.encode("hello world") == jax.encode("hello world")


def test_gpt2_dialect_round_trip(model_dir, tmp_path):
    """io/gpt2.py is the JAX module's copy: the same remap, and a model
    saved in the GPT-2 dialect loads into both tokenizers with the same
    ids."""
    assert gpt2.byte_to_unicode() == jax_gpt2.byte_to_unicode()
    port = BBPETokenizer.from_file(model_dir)
    gpt2.save_gpt2_vocab(tmp_path / "vocab.json", port._vocab)
    gpt2.save_gpt2_merges(tmp_path / "merges.txt", port._merges)
    assert gpt2.reconstruct_gpt2_vocab(port._merges) == jax_gpt2.reconstruct_gpt2_vocab(port._merges)
    got = BBPETokenizer.from_gpt2_files(tmp_path / "vocab.json", tmp_path / "merges.txt")
    want = JaxTokenizer.from_gpt2_files(tmp_path / "vocab.json", tmp_path / "merges.txt")
    assert got.special_tokens == want.special_tokens == SPECIALS
    for text in SNIPPETS:
        assert got.encode(text) == want.encode(text) == port.encode(text)
