"""The port's small-vocabulary kernel module
(yabpe_tpu_torch.kernels.fused_loop) and train/fused_driver.py, held
against the JAX package's ``_merge_loop_kernel``.

On the CPU the wrapper runs the kernel's plain twin; the JAX side runs its
Pallas kernel in interpret mode, as tests/test_fused_kernel.py does. Both
start from the same numpy state, and after every chunk the whole state
must be exactly equal: all of this is integer arithmetic. The CUDA kernel
is held against the twin on a card by tests/test_torch_cuda.py.
"""

from __future__ import annotations

import functools
import random
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yabpe_tpu import BBPETrainer as JaxTrainer
from yabpe_tpu import BBPETrainerConfig as JaxConfig
from yabpe_tpu.core.vocab import Vocab as JaxVocab
from yabpe_tpu.core.wordtable import WordTable as JaxWordTable
from yabpe_tpu.kernels.fused_loop import fused_merge_chunk as jax_fused_merge_chunk
from yabpe_tpu.train import fused_driver as jax_driver
from yabpe_tpu.train.incremental import init_counts as jax_init_counts
from yabpe_tpu.train.reference_loop import train_merges_oracle as jax_oracle
from yabpe_tpu.train.state import init_state as jax_init_state
from yabpe_tpu_torch import BBPETrainer, BBPETrainerConfig
from yabpe_tpu_torch.core.vocab import Vocab
from yabpe_tpu_torch.core.wordtable import WordTable
from yabpe_tpu_torch.kernels import fused_loop
from yabpe_tpu_torch.kernels.hbm_loop import STOPPED
from yabpe_tpu_torch.train import fused_driver
from yabpe_tpu_torch.train.state import merges_to_bytes

from .common import DATA

SPECIALS = ["<|endoftext|>"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and these tensors are small."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _random_counter(seed: int) -> tuple[Counter, int]:
    """The random case of tests/test_fused_kernel.py."""
    rng = random.Random(seed)
    alphabet = "abcdeé 東!"
    words = [
        "".join(rng.choice(alphabet) for _ in range(rng.randint(1, 12)))
        for _ in range(rng.randint(5, 50))
    ]
    counter = Counter()
    for w in words:
        counter[w.encode("utf-8")] += rng.randint(1, 9)
    return counter, 256 + rng.randint(1, 40)


def _case(name: str):
    """(counter, vocab_size, min_frequency, batch_rows) of each case of
    tests/test_fused_kernel.py."""
    if name == "dedup_and_runs":
        return Counter({b"abab": 10, b"aaa": 7, b"ab": 5, b"cd": 3}), 262, 1, 8
    if name == "min_frequency_stop":
        return Counter({b"ab": 5, b"cd": 1}), 300, 2, 8
    if name == "many_affected_rows":
        counter = Counter({f"x{i:02d}ab".encode(): 1 + (i % 3) for i in range(40)})
        counter[b"ab"] = 50
        return counter, 262, 1, 4
    counter, vocab_size = _random_counter(int(name.removeprefix("random_")))
    return counter, vocab_size, 1, 8


def _jax_state(jt, vocab_cap: int, num: int):
    """The JAX kernel's inputs, as tests/test_fused_kernel.py builds them."""
    st = jax_init_state(jt, JaxVocab.base([]), vocab_cap, num)
    counts = jax_init_counts(st.words, st.freqs, vocab_cap=vocab_cap)
    return [
        st.words,
        counts.reshape(vocab_cap, vocab_cap),
        st.token_bytes,
        st.token_len.reshape(1, -1),
        st.lex_rank.reshape(1, -1),
        jnp.full((max(num, 1), 4), -1, jnp.int32),
        jnp.zeros((1, 8), jnp.int32).at[0, 0].set(st.next_id),
    ], st.freqs.reshape(1, -1)


def _assert_same(port: fused_loop.FusedState, jax_state, where) -> None:
    words, counts, token_bytes, token_len, lex, merges, scalars = (
        np.asarray(x) for x in jax_state
    )
    assert np.array_equal(port.words.numpy(), words), where
    assert np.array_equal(port.counts.numpy(), counts), where
    assert np.array_equal(port.token_bytes.numpy(), token_bytes), where
    assert np.array_equal(port.token_len.numpy(), token_len[0]), where
    assert np.array_equal(port.lex_rank.numpy(), lex[0]), where
    assert np.array_equal(port.merges.numpy(), merges[:, :3]), where
    assert port.scalars.tolist()[:3] == scalars[0, :3].tolist(), where


@pytest.mark.parametrize(
    "name",
    ["dedup_and_runs", "min_frequency_stop", "many_affected_rows"]
    + [f"random_{seed}" for seed in range(4)],
)
def test_twin_matches_jax_kernel_every_chunk(name):
    """The cases of tests/test_fused_kernel.py, chunk by chunk (16 steps):
    the twin's state equals the JAX kernel's (interpret mode) after every
    chunk, and the merges equal the oracle's."""
    counter, vocab_size, min_freq, batch_rows = _case(name)
    jt = JaxWordTable.from_counter(counter)
    num = vocab_size - 256
    jax_state, jax_freqs = _jax_state(jt, vocab_size, num)
    port = fused_driver.fused_state_from_numpy(
        jt.words, jt.freqs, list(Vocab.base([]).tokens()), vocab_size, "cpu",
        num_merges=num,
    )
    _assert_same(port, jax_state, "initial state")
    chunk, start = 16, 0
    while start < num:
        scalars = jax_state[6].at[0, 3].set(start)
        jax_state = list(jax_fused_merge_chunk(
            *jax_state[:6], scalars, jax_freqs, vocab_cap=vocab_size,
            num_merges=num, chunk_size=chunk, min_frequency=min_freq,
            batch_rows=batch_rows, interpret=True,
        ))
        fused_loop.fused_merge_chunk(
            port, chunk_start=start, chunk_size=chunk, num_merges=num,
            min_frequency=min_freq,
        )
        start += chunk
        _assert_same(port, jax_state, f"after the chunk ending at {start}")
        if int(port.scalars[STOPPED]):
            break
    merges = merges_to_bytes(port.merges.numpy(), Vocab.base([]))[1]
    assert merges == jax_oracle(counter, [], vocab_size, min_freq)[1]
    if name == "min_frequency_stop":
        assert merges == [(b"a", b"b")]


def test_run_fused_merge_loop_matches_jax_on_large_txt():
    """tests/data/large.txt at vocab 300: the port's driver (chunks of 16
    on the twin) gives the JAX driver's merge record."""
    from yabpe_tpu.pretok.ingest import count_pretokens

    counter = count_pretokens([DATA / "large.txt"], SPECIALS, max_workers=1)
    jt = JaxWordTable.from_counter(counter)
    num = 300 - 257
    want = jax_driver.run_fused_merge_loop(
        jt, JaxVocab.base(SPECIALS), vocab_cap=300, num_merges=num,
        min_frequency=1, chunk_size=64, interpret=True,
    )
    got = fused_driver.run_fused_merge_loop(
        WordTable(jt.words, jt.freqs, jt.num_words, jt.max_len),
        Vocab.base(SPECIALS), vocab_cap=300, num_merges=num, min_frequency=1,
        chunk_size=16, device="cpu",
    )
    assert np.array_equal(got, np.asarray(want)[:num])
    assert (got[:, 0] >= 0).all()


@pytest.fixture(scope="module")
def wide_table(tmp_path_factory):
    """The first 3,000 bytes of tests/data/large.txt plus 30 lines of
    65-300-byte pre-tokens (scripts/wide_lines.py, seed 2): a JAX word
    table of 128 rows x 304 symbols, and its file."""
    from yabpe_tpu.pretok.ingest import count_pretokens

    from .test_torch_engines import _wide_lines

    path = tmp_path_factory.mktemp("fused_wide") / "wide.txt"
    path.write_bytes(
        (DATA / "large.txt").read_bytes()[:3000] + b"\n"
        + "\n".join(_wide_lines(30, 2)).encode("utf-8") + b"\n"
    )
    jt = JaxWordTable.from_counter(count_pretokens([path], [], max_workers=1))
    assert jt.words.shape == (128, 304) and jt.max_len > 64
    return path, jt


def test_twin_matches_jax_kernel_at_width_304(wide_table):
    """Words past 64 symbols, as the TPU kernel takes them: the twin's
    state equals the JAX kernel's (interpret mode) after every chunk of 32
    at vocab 320, the record equals the JAX driver's and the port driver's,
    and a word longer than 64 symbols is merged."""
    _, jt = wide_table
    vocab_size, num, chunk = 320, 64, 32
    jax_state, jax_freqs = _jax_state(jt, vocab_size, num)
    port = fused_driver.fused_state_from_numpy(
        jt.words, jt.freqs, list(Vocab.base([]).tokens()), vocab_size, "cpu",
        num_merges=num,
    )
    before = port.words.clone()
    _assert_same(port, jax_state, "initial state")
    for start in range(0, num, chunk):
        scalars = jax_state[6].at[0, 3].set(start)
        jax_state = list(jax_fused_merge_chunk(
            *jax_state[:6], scalars, jax_freqs, vocab_cap=vocab_size,
            num_merges=num, chunk_size=chunk, min_frequency=1, interpret=True,
        ))
        fused_loop.fused_merge_chunk(
            port, chunk_start=start, chunk_size=chunk, num_merges=num, min_frequency=1,
        )
        _assert_same(port, jax_state, f"after the chunk ending at {start + chunk}")
    assert int(port.scalars[2]) == num
    long_rows = (before >= 0).sum(dim=1) > 64
    assert bool((port.words[long_rows] != before[long_rows]).any())
    want = jax_driver.run_fused_merge_loop(
        jt, JaxVocab.base([]), vocab_cap=vocab_size, num_merges=num,
        min_frequency=1, chunk_size=chunk, interpret=True,
    )
    got = fused_driver.run_fused_merge_loop(
        WordTable(jt.words, jt.freqs, jt.num_words, jt.max_len), Vocab.base([]),
        vocab_cap=vocab_size, num_merges=num, min_frequency=1, chunk_size=chunk,
        device="cpu",
    )
    assert np.array_equal(got, np.asarray(want)[:num])
    assert np.array_equal(got, port.merges.numpy())


def test_trainer_routes_wide_words_to_k1_as_jax_does(wide_table, monkeypatch):
    """The JAX trainer's route: the wide corpus at vocab 320 fits K1's
    admission, so the port trains it on K1 (its twin, device="cpu"), with
    the merges and vocab of the JAX trainer forced onto its K1 (the Pallas
    kernel interpreted, as on any backend but a TPU) and of the native
    loop."""
    path, _ = wide_table
    kw = dict(vocab_size=320, min_frequency=1, max_workers=1, special_tokens=[])
    trainer = BBPETrainer(BBPETrainerConfig(**kw, device="cpu"))
    before = fused_loop.LAUNCHES["fused_merge_chunk"]
    model = trainer.train([path])
    assert trainer.route == "K1"
    assert fused_loop.LAUNCHES["fused_merge_chunk"] == before  # the twin ran
    monkeypatch.setattr(
        jax_driver, "run_fused_merge_loop",
        functools.partial(jax_driver.run_fused_merge_loop, interpret=True),
    )
    jax = JaxTrainer(JaxConfig(**kw, use_fused_kernel=True, use_native_loop=False)).train([path])
    native = BBPETrainer(BBPETrainerConfig(**kw, use_native_loop=True)).train([path])
    assert model.merges == jax.merges == native.merges
    assert model.vocab == jax.vocab == native.vocab


def test_fused_applicable_matches_jax():
    for rows in (64, 512, 4096, 61440, 200_000):
        for width in (16, 32, 64):
            for vocab in (257, 500, 1000, 1024, 1500, 2048, 4096):
                args = (rows, width, vocab, width)
                assert fused_driver.fused_applicable(*args) == (
                    jax_driver.fused_applicable(*args)
                ), args
    assert fused_driver.fused_applicable(512, 16, 1000, 16)
    assert not fused_driver.fused_applicable(512, 16, 2048, 16)


def test_fused_state_from_numpy_matches_jax_init():
    counter, vocab_size, _, _ = _case("random_1")
    jt = JaxWordTable.from_counter(counter)
    num = vocab_size - 256
    jax_state, jax_freqs = _jax_state(jt, vocab_size, num)
    port = fused_driver.fused_state_from_numpy(
        jt.words, jt.freqs, list(Vocab.base([]).tokens()), vocab_size, "cpu",
        num_merges=num,
    )
    _assert_same(port, jax_state, "initial state")
    assert np.array_equal(port.freqs.numpy(), np.asarray(jax_freqs)[0])


def test_wrapper_runs_the_twin_only_for_cpu_tensors():
    table = WordTable.from_counter(Counter({b"abab": 3}))
    base = Vocab.base([])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fused_driver.run_fused_merge_loop(
                table, base, vocab_cap=260, num_merges=4, min_frequency=1,
                device="cuda",
            )
    cpu_state = fused_driver.fused_state_from_numpy(
        table.words, table.freqs, list(base.tokens()), 260, "cpu"
    )
    meta_state = fused_loop.FusedState(
        *(torch.empty_like(t, device="meta") for t in cpu_state.tensors())
    )
    before = fused_loop.LAUNCHES["fused_merge_chunk"]
    with pytest.raises(ValueError, match="cuda or cpu"):
        fused_loop.fused_merge_chunk(
            meta_state, chunk_start=0, chunk_size=4, num_merges=4,
            min_frequency=1,
        )
    fused_loop.fused_merge_chunk(
        cpu_state, chunk_start=0, chunk_size=4, num_merges=4, min_frequency=1
    )
    assert fused_loop.LAUNCHES["fused_merge_chunk"] == before  # the twin ran
    assert cpu_state.merges.tolist()[:2] == [[97, 98, 256], [256, 256, 257]]
    with pytest.raises(ValueError, match="FusedState.scalars"):
        fused_loop.fused_merge_chunk(
            fused_loop.FusedState(*cpu_state.tensors()[:-1], cpu_state.scalars[:3]),
            chunk_start=0, chunk_size=4, num_merges=4, min_frequency=1,
        )
