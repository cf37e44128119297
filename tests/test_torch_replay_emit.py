"""The port's replay kernel module (yabpe_tpu_torch.kernels.replay_emit),
held against the JAX package's kernel.

On the CPU the wrapper runs the kernel's plain twin; the JAX side runs its
Pallas kernel in interpret mode, as tests/test_replay_emit.py does, on the
same word lists made with numpy, and its packed words are unpacked into
the port's [N, W] layout. The cells of a step come in no fixed order, so
each step's net delta (summed by cell, zeros dropped) is compared. Every
comparison is exact: all of this is integer arithmetic. The CUDA kernel is
held against the twin on a card by tests/test_torch_cuda.py.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from yabpe_tpu.train.hbm_driver import pack_words
from yabpe_tpu_torch.kernels import replay_emit

from .test_replay_emit import _apply_word, _mk_table, _unpack


def _jax_replay(words_list, freqs, chain, width, *, cps, cps0, wide=False):
    """JAX replay_emit_chunk in interpret mode: (words [N, W], logs, ok)."""
    import jax.numpy as jnp

    from yabpe_tpu.kernels.replay_emit import replay_emit_chunk

    table = _mk_table(words_list, freqs, width)
    chain_np = np.full((len(chain), 128), -1, dtype=np.int32)
    chain_np[:, :3] = chain
    out, ll, lr, lw, ok = replay_emit_chunk(
        jnp.asarray(pack_words(table)), jnp.asarray(chain_np),
        word_width=width, cps=cps, cps0=cps0, wide=wide, interpret=True,
    )
    words = _unpack(np.asarray(out), len(words_list), width)
    if wide:
        words = np.where(words == -1, -1, words & 0xFFFF)
    logs = [torch.from_numpy(np.array(x)) for x in (ll, lr, lw)]
    return words, logs, np.asarray(ok)


def _port_inputs(words_list, freqs, chain, width):
    words = np.full((len(words_list), width), -1, dtype=np.int32)
    for i, w in enumerate(words_list):
        words[i, : len(w)] = w
    return (
        torch.from_numpy(words),
        torch.tensor(freqs, dtype=torch.int32),
        torch.tensor(chain, dtype=torch.int32),
    )


def _same_net_deltas(logs_a, logs_b, steps, *, cursor_a, cps, cps0, vocab_cap, ok):
    """The port's logs (read up to ``cursor_a``) against the JAX kernel's
    (cleared empty slots)."""
    for j in range(steps):
        if not ok[j]:
            continue
        kw = dict(cps=cps, cps0=cps0, vocab_cap=vocab_cap)
        a = replay_emit.step_net_delta(*logs_a, j, cursor=cursor_a, **kw)
        b = replay_emit.step_net_delta(*logs_b, j, cursor=None, **kw)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]), f"step {j}"


def _oracle_words(words_list, chain):
    words_list = [list(w) for w in words_list]
    for a, b, c in chain:
        if a < 0:
            continue
        for i, w in enumerate(words_list):
            if any(w[k] == a and w[k + 1] == b for k in range(len(w) - 1)):
                words_list[i] = _apply_word(w, a, b, c)
    return words_list


@pytest.mark.parametrize("seed", [0, 1])
def test_twin_matches_jax_kernel(seed):
    """The random cases of tests/test_replay_emit.py: a present pair, an
    absent pair, an inactive row, a merge of the symbol made one step
    before, and the overlapping (7, 7); cps0 differs from cps."""
    rng = np.random.default_rng(seed)
    width, n = 12, 300
    words_list = [
        rng.integers(0, 40, size=rng.integers(1, width + 1)).tolist()
        for _ in range(n)
    ]
    freqs = rng.integers(1, 9, size=n).tolist()
    first = words_list[0]
    chain = [
        (first[0], first[1], 40) if len(first) > 1 else (0, 1, 40),
        (3, 5, 41),
        (99, 98, 42),
        (-1, -1, -1),
        (41, 2, 43),
        (7, 7, 44),
    ]
    want_words, want_logs, want_ok = _jax_replay(
        words_list, freqs, chain, width, cps=64, cps0=128
    )
    words, fr, ch = _port_inputs(words_list, freqs, chain, width)
    out, *logs, ok, cursor = replay_emit.replay_emit_chunk_reference(
        words, fr, ch, cps=64, cps0=128
    )
    assert np.array_equal(out.numpy(), want_words)
    assert ok.tolist() == want_ok.tolist() == [1] * len(chain)
    _same_net_deltas(
        logs, want_logs, len(chain), cursor_a=cursor, cps=64, cps0=128, vocab_cap=64, ok=want_ok
    )
    oracle = _oracle_words(words_list, chain)
    for i, w in enumerate(oracle):
        assert out[i, : len(w)].tolist() == w


def test_overflow_flags_match_jax():
    """600 words hit by step 0 at cps = cps0 = 8: more cells than 1024
    slots, so ok[0] == 0 on both sides; the words are applied all the
    same."""
    width, n = 8, 600
    words_list = [[1, 2, 3] for _ in range(n)]
    chain = [(1, 2, 50), (50, 3, 51)]
    want_words, _, want_ok = _jax_replay(words_list, [1] * n, chain, width, cps=8, cps0=8)
    words, fr, ch = _port_inputs(words_list, [1] * n, chain, width)
    out, _, _, _, ok, cursor = replay_emit.replay_emit_chunk(words, fr, ch, cps=8, cps0=8)
    assert want_ok[0] == 0 and int(ok[0]) == 0
    assert int(ok[1]) == 1  # 600 cells fit; the TPU kernel's unit is 8 rows
    assert cursor.tolist() == [1800, 600]  # slots taken, past the capacity too
    assert np.array_equal(out.numpy(), want_words)
    assert (out[:, 0] == 51).all() and (out[:, 1:] == -1).all()


def test_ids_near_40000_match_jax_wide_mode():
    """Ids past the i16 range: the JAX kernel's wide mode (u16 bit
    patterns); the port's int32 words need no mode."""
    width, base = 6, 40000
    words_list = [[base, base + 1, base + 2], [base + 1, base + 2], [base + 2, base]]
    freqs = [3, 5, 2]
    chain = [(base, base + 1, base + 3), (base + 1, base + 2, base + 4), (base + 3, base + 2, base + 5)]
    want_words, want_logs, want_ok = _jax_replay(
        words_list, freqs, chain, width, cps=64, cps0=64, wide=True
    )
    words, fr, ch = _port_inputs(words_list, freqs, chain, width)
    out, *logs, ok, cursor = replay_emit.replay_emit_chunk(words, fr, ch, cps=64, cps0=64)
    assert np.array_equal(out.numpy(), want_words)
    assert ok.tolist() == want_ok.tolist() == [1, 1, 1]
    # the JAX kernel's cells are int32 ids in either mode
    _same_net_deltas(
        logs, want_logs, 3, cursor_a=cursor, cps=64, cps0=64, vocab_cap=base + 8, ok=want_ok
    )
    cells, sums = replay_emit.step_net_delta(
        *logs, 0, cursor=cursor, cps=64, cps0=64, vocab_cap=base + 8
    )
    assert int(sums.sum()) == -3  # word 0 loses one adjacent pair


def test_input_shard_untouched_and_layout():
    rng = np.random.default_rng(5)
    words = torch.from_numpy(rng.integers(0, 6, size=(50, 9)).astype(np.int32))
    words[:, 7:] = -1
    before = words.clone()
    freqs = torch.ones(50, dtype=torch.int32)
    chain = torch.tensor([[0, 1, 6], [6, 2, 7], [-1, 0, 0], [3, 3, 8]], dtype=torch.int32)
    out, log_l, log_r, log_w, ok, cursor = replay_emit.replay_emit_chunk(words, freqs, chain, cps=16)
    assert torch.equal(words, before) and not torch.equal(out, before)
    rows = replay_emit.log_rows(4, 16, 64)
    assert log_l.shape == log_r.shape == log_w.shape == (rows, 128)
    assert ok.tolist() == [1, 1, 1, 1]
    empty = log_l.view(-1) < 0
    assert bool((log_r.view(-1)[empty] == -1).all() and (log_w.view(-1)[empty] == 0).all())
    # an inactive row logs nothing
    first, count = replay_emit.step_slots(2, 16, 64)
    assert bool((log_l.view(-1)[first : first + count] == -1).all()) and int(cursor[2]) == 0
    assert cursor.shape == (4,) and int(cursor.sum()) == int((log_l.view(-1) >= 0).sum())


def test_wrapper_takes_the_twin_on_cpu_only():
    words = torch.tensor([[1, 2, 1, 2]], dtype=torch.int32)
    freqs = torch.tensor([4], dtype=torch.int32)
    chain = torch.tensor([[1, 2, 9], [9, 9, 10]], dtype=torch.int32)
    before = replay_emit.LAUNCHES["replay_emit_chunk"]
    out, *_ = replay_emit.replay_emit_chunk(words, freqs, chain, cps=8, cps0=8)
    assert replay_emit.LAUNCHES["replay_emit_chunk"] == before
    assert out.tolist() == [[10, -1, -1, -1]]
    meta = [t.to("meta") for t in (words, freqs, chain)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        replay_emit.replay_emit_chunk(*meta, cps=8, cps0=8)
    with pytest.raises(ValueError, match="multiples of 8"):
        replay_emit.replay_emit_chunk(words, freqs, chain, cps=12)
    with pytest.raises(ValueError, match="int32"):
        replay_emit.replay_emit_chunk(words.long(), freqs, chain)


def test_log_plan_matches_jax():
    from yabpe_tpu.kernels import replay_emit as jax_replay

    for nr, wl, rows in [(8, 2048, 0), (760, 2304, 2480), (4000, 8448, 64)]:
        assert replay_emit.replay_vmem_estimate(nr, wl, rows) == jax_replay.replay_vmem_estimate(nr, wl, rows)
        assert replay_emit.max_log_rows(nr, wl) == jax_replay.max_log_rows(nr, wl)
    assert replay_emit.STAGE_ROWS == jax_replay.STAGE_ROWS
    assert replay_emit.VMEM_LIMIT_BYTES == jax_replay.VMEM_LIMIT_BYTES
