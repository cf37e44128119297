"""The port's checkpoint and resume (yabpe_tpu_torch.train.checkpoint, the
replay mode of the merge kernel's twin, and the trainer's hooks), held
against the JAX package on the CPU.

The JAX merge kernel runs in interpret mode, as tests/test_hbm_loop.py
runs it, at vocab 300. Tolerance: exact.
"""

from __future__ import annotations

import json
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

from yabpe_tpu import BBPETrainer as JaxTrainer
from yabpe_tpu import BBPETrainerConfig as JaxConfig
from yabpe_tpu.core.vocab import Vocab as JaxVocab
from yabpe_tpu.core.wordtable import WordTable as JaxWordTable
from yabpe_tpu.pretok.ingest import count_pretokens as jax_count_pretokens
from yabpe_tpu.train import checkpoint as jax_ckpt
from yabpe_tpu.train import hbm_driver as jax_driver
from yabpe_tpu_torch import BBPETrainer, BBPETrainerConfig
from yabpe_tpu_torch.core.vocab import Vocab
from yabpe_tpu_torch.core.wordtable import WordTable
from yabpe_tpu_torch.kernels import hbm_loop
from yabpe_tpu_torch.train import checkpoint as ckpt
from yabpe_tpu_torch.train import hbm_driver

from .common import DATA
from .test_torch_engines import _wide_lines

SPECIALS: list[str] = []  # 256 base tokens: vocab 300 holds 44 merges
K2_RUN = dict(vocab_cap=300, num_merges=44, min_frequency=1, chunk_size=16)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and these tensors are small."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def small_corpus(tmp_path_factory):
    """The corpus of tests/test_hbm_loop.py, counted by the JAX package."""
    text = (
        "the quick brown fox jumps over the lazy dog. "
        "the dog barks, the fox runs away! banana bandana anagrams "
        "low lower lowest newer newest wider widest 123 4567 \n\n"
    ) * 6 + "naïve café 東京 😀 mixed UP case WORDS"
    f = tmp_path_factory.mktemp("ckpt") / "small.txt"
    f.write_text(text, encoding="utf-8")
    jt = JaxWordTable.from_counter(jax_count_pretokens([f], SPECIALS, max_workers=1))
    return jt, WordTable(jt.words, jt.freqs, jt.num_words, jt.max_len)


@pytest.fixture(scope="module")
def k2_full(small_corpus):
    """The uninterrupted twin run: its record and its state after every
    chunk."""
    _, table = small_corpus
    states = {}
    ids = hbm_driver.run_hbm_merge_loop(
        table, Vocab.base(SPECIALS), device="cpu",
        on_state=lambda st, steps: states.setdefault(steps, st.clone()), **K2_RUN,
    )
    return ids, states


@pytest.fixture(scope="module")
def wide_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("ckpt_wide") / "wide.txt"
    path.write_text(
        (DATA / "sample.txt").read_text(encoding="utf-8") + "\n"
        + "\n".join(_wide_lines(30, 2)) + "\n",
        encoding="utf-8",
    )
    return path


# ------------------------------------------------------------ the files


def test_fingerprints_equal_across_packages():
    for kw in (
        {},
        dict(vocab_size=300, special_tokens=[]),
        dict(vocab_size=1000, min_frequency=3, special_tokens=("<|a|>", "<|b|>")),
    ):
        assert ckpt.config_fingerprint(BBPETrainerConfig(**kw)) == (
            jax_ckpt.config_fingerprint(JaxConfig(**kw))
        ), kw
    assert ckpt.config_fingerprint(BBPETrainerConfig(vocab_size=300)) != (
        ckpt.config_fingerprint(BBPETrainerConfig(vocab_size=301))
    )


def test_torn_or_mismatched_checkpoint_loads_as_none(tmp_path):
    cfg = BBPETrainerConfig(vocab_size=300, special_tokens=[])
    record = np.arange(12, dtype=np.int32).reshape(4, 3)
    assert ckpt.load_checkpoint(tmp_path, cfg) is None  # absent
    ckpt.save_checkpoint(tmp_path, record, 3, cfg)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["merge_state.npz", "meta.json"]
    assert json.loads((tmp_path / "meta.json").read_text())["format"] == 1
    for load in (ckpt.load_checkpoint, jax_ckpt.load_checkpoint):
        merges, steps = load(tmp_path, cfg)
        assert np.array_equal(merges, record) and steps == 3
    assert ckpt.load_checkpoint(tmp_path, BBPETrainerConfig(vocab_size=301, special_tokens=[])) is None
    npz = (tmp_path / "merge_state.npz").read_bytes()
    (tmp_path / "merge_state.npz").write_bytes(npz[: len(npz) // 2])
    assert ckpt.load_checkpoint(tmp_path, cfg) is None  # torn npz
    ckpt.save_checkpoint(tmp_path, record, 3, cfg)
    (tmp_path / "meta.json").write_text('{"steps_done": 3, "finger')
    assert ckpt.load_checkpoint(tmp_path, cfg) is None  # torn meta


@pytest.mark.parametrize("steps_done", [0, 16, 21, 44])
def test_resume_state_matches_jax(small_corpus, k2_full, steps_done):
    jt, table = small_corpus
    ids = k2_full[0]
    want = jax_ckpt.resume_state(jt, JaxVocab.base(SPECIALS), 300, 44, ids, steps_done)
    got = ckpt.resume_state(table, Vocab.base(SPECIALS), 300, 44, ids, steps_done, "cpu")
    assert np.array_equal(got.words.numpy(), np.asarray(want.words))
    for name in ("token_bytes", "token_len", "lex_rank", "merges"):
        assert np.array_equal(getattr(got.vocab, name).numpy(), np.asarray(getattr(want, name))), name
    for name in ("next_id", "stopped", "num_done"):
        assert int(getattr(got.vocab, name)) == int(getattr(want, name)), name


def test_divergent_record_raises(small_corpus, k2_full):
    """A record whose merged id disagrees with the vocab, or whose ids are
    not live, raises, in ``resume_state`` and in the kernel twin's replay."""
    jt, table = small_corpus
    base = Vocab.base(SPECIALS)
    ids = k2_full[0]
    bad_id = ids.copy()
    bad_id[10, 2] += 1
    bad_pair = ids.copy()
    bad_pair[10, 1] = 299  # not a live id at step 10
    with pytest.raises(AssertionError, match="divergence"):
        ckpt.resume_state(table, base, 300, 44, bad_id, 21, "cpu")
    for record in (bad_id, bad_pair):
        with pytest.raises(AssertionError, match="divergence at replayed step 10"):
            hbm_driver.run_hbm_merge_loop(
                table, base, device="cpu", resume=(record, 21), **K2_RUN
            )


# ------------------------------------------------- K2's replay, the twin


@pytest.mark.parametrize("steps_done", [16, 21, 44])
def test_k2_twin_resume_equals_uninterrupted(small_corpus, k2_full, steps_done):
    """Resumed at 16, 21 and 44 steps, the twin's state equals the
    uninterrupted twin's at every chunk boundary (``row_max`` at least
    the table's row maxima), and so do the merges."""
    _, table = small_corpus
    ids, full_states = k2_full
    record = np.full_like(ids, -1)
    record[:steps_done] = ids[:steps_done]
    states = {}
    got = hbm_driver.run_hbm_merge_loop(
        table, Vocab.base(SPECIALS), device="cpu", resume=(record, steps_done),
        on_state=lambda st, steps: states.setdefault(steps, st.clone()), **K2_RUN,
    )
    assert np.array_equal(got, ids)
    assert sorted(states) == sorted(full_states)
    for steps, st in states.items():
        want = full_states[steps]
        for name in ("words", "counts", "token_bytes", "token_len", "lex_rank"):
            assert torch.equal(getattr(st, name), getattr(want, name)), (steps, name)
        # Rows past the boundary hold the preloaded record until replayed.
        rows = steps if steps < steps_done else len(ids)
        assert torch.equal(st.merges[:rows], want.merges[:rows]), steps
        assert torch.equal(st.scalars, want.scalars), steps
        assert bool((st.row_max >= st.counts.amax(dim=1)).all()), steps


def test_k2_twin_resume_matches_jax_kernel_interpret(small_corpus, k2_full):
    """The twin's replay against the JAX kernel's replay mode (interpret
    mode) at resume points 16 and 21."""
    jt, table = small_corpus
    ids = k2_full[0]
    for steps_done in (16, 21):
        record = np.full_like(ids, -1)
        record[:steps_done] = ids[:steps_done]
        want = jax_driver.run_hbm_merge_loop(
            jt, JaxVocab.base(SPECIALS), resume=(record, steps_done),
            interpret=True, **K2_RUN,
        )
        got = hbm_driver.run_hbm_merge_loop(
            table, Vocab.base(SPECIALS), device="cpu", resume=(record, steps_done),
            **K2_RUN,
        )
        assert np.array_equal(got, np.asarray(want)[:44]), steps_done


# ------------------------------------------------------------ the trainer


def _cat_file(tmp_path: Path) -> Path:
    f = tmp_path / "c.txt"
    f.write_text("the cat sat on the mat. the bat and the rat ran. " * 40, encoding="utf-8")
    return f


def _kill_and_resume(path, cfg_cls, trainer_cls, ckdir, kw, at):
    """Train with checkpoints every chunk, cut the saved record to ``at``
    steps, and train again from it; returns (model, trainer, the full
    record)."""
    cfg = cfg_cls(**kw, checkpoint_dir=str(ckdir), checkpoint_every_chunks=1)
    trainer_cls(cfg).train([path])
    merges_ids, _ = ckpt.load_checkpoint(ckdir, cfg)
    cut = np.full_like(merges_ids, -1)
    cut[:at] = merges_ids[:at]
    ckpt.save_checkpoint(ckdir, cut, at, cfg)
    trainer = trainer_cls(cfg)
    return trainer.train([path]), trainer, merges_ids


@pytest.mark.parametrize(
    "route,extra", [
        ("K2", dict(vocab_size=300, use_fused_kernel=False)),
        ("incremental", dict(vocab_size=320)),
        ("bigvocab", dict(vocab_size=2300, use_hbm_kernel=False)),
        ("sharded", dict(vocab_size=300, data_shards=2, use_hbm_kernel=True)),
    ],
)
def test_trainer_kill_and_resume(tmp_path, wide_file, route, extra):
    """Kill-and-resume through the trainer gives the uninterrupted model,
    on K2 (replay mode), both engines and the data-sharded route; the cut
    at step 20 is not on a chunk boundary."""
    path = wide_file if route == "incremental" else (
        DATA / "sample.txt" if route == "bigvocab" else _cat_file(tmp_path)
    )
    kw = dict(
        min_frequency=1, max_workers=1, special_tokens=[], merge_chunk_size=16,
        device="cpu", **extra,
    )
    full = BBPETrainer(BBPETrainerConfig(**kw)).train([path])
    model, trainer, _ = _kill_and_resume(
        path, BBPETrainerConfig, BBPETrainer, tmp_path / "ck", kw, 20
    )
    assert trainer.route == route
    assert model.merges == full.merges and model.vocab == full.vocab


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_resumes_across_packages(tmp_path, writer):
    """A checkpoint written by one package, cut at step 20, resumes in the
    other to the uninterrupted merges: the JAX trainer's incremental
    engine, the port's merge kernel (twin)."""
    path = DATA / "sample.txt"
    kw = dict(vocab_size=320, min_frequency=1, max_workers=1, special_tokens=[], merge_chunk_size=16)
    port_kw = dict(**kw, device="cpu", use_fused_kernel=False)
    full = BBPETrainer(BBPETrainerConfig(**port_kw)).train([path])
    ckdir = tmp_path / "ck"
    if writer == "jax":
        cfg = JaxConfig(**kw, use_native_loop=False, checkpoint_dir=str(ckdir), checkpoint_every_chunks=1)
        JaxTrainer(cfg).train([path])
    else:
        cfg = BBPETrainerConfig(**port_kw, checkpoint_dir=str(ckdir), checkpoint_every_chunks=1)
        BBPETrainer(cfg).train([path])
    merges_ids, _ = jax_ckpt.load_checkpoint(ckdir, cfg)
    cut = np.full_like(merges_ids, -1)
    cut[:20] = merges_ids[:20]
    jax_ckpt.save_checkpoint(ckdir, cut, 20, cfg)
    if writer == "jax":
        trainer = BBPETrainer(BBPETrainerConfig(**port_kw, checkpoint_dir=str(ckdir)))
        model = trainer.train([path])
        assert trainer.route == "K2"
    else:
        model = JaxTrainer(JaxConfig(**kw, use_native_loop=False, checkpoint_dir=str(ckdir))).train([path])
    assert model.merges == full.merges and model.vocab == full.vocab


def test_saver_cadence(tmp_path):
    """``checkpoint_every_chunks`` chunks between saves; the record saved
    is the merge record at that chunk's end."""
    path = _cat_file(tmp_path)
    kw = dict(
        vocab_size=300, min_frequency=1, max_workers=1, special_tokens=[],
        merge_chunk_size=8, device="cpu", use_fused_kernel=False,
        checkpoint_dir=str(tmp_path / "ck"), checkpoint_every_chunks=3,
    )
    cfg = BBPETrainerConfig(**kw)
    model = BBPETrainer(cfg).train([path])
    merges_ids, steps = ckpt.load_checkpoint(tmp_path / "ck", cfg)
    assert steps % 24 == 0 and steps > 0
    done = merges_ids[merges_ids[:, 0] >= 0]
    assert len(done) == min(steps, len(model.merges))
    assert Counter(map(tuple, done.tolist())).most_common(1)[0][1] == 1
