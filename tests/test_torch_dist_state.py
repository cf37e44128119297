"""The port's sharded merge loop against the JAX package's, inside: the
state at chunk boundaries, one speculative epoch, the follow-up estimate,
and a seeded corpus of many equal counts, on the conftest's 8 virtual CPU
devices.

Inputs come from tests/data/large.txt and from corpora made from a seed
with numpy; they go through both packages. Every comparison is exact: the
state is integers, and the follow-up estimate's float32 arithmetic is
compared bit for bit through the integer view it produces.
"""

from __future__ import annotations

from collections import Counter
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from yabpe_tpu.dist import sharded as jax_sharded
from yabpe_tpu.dist.mesh import make_2d_mesh as jax_2d_mesh
from yabpe_tpu.dist.mesh import put_global
from yabpe_tpu_torch.dist import sharded, speculative
from yabpe_tpu_torch.dist.mesh import make_2d_mesh

from .test_torch_dist import CAP, CHUNK, _jax, _one_torch_thread, _port, _tables, large  # noqa: F401

pytestmark = pytest.mark.skipif(
    len(jax.devices("cpu")) < 8, reason="needs the 8 virtual CPU devices"
)


@pytest.fixture(scope="module")
def ties():
    """3,000 seeded words over {a, b, c, d} with counts 1-3: many equal
    counts, in slabs of every vocab shard, and early merges that affect
    more rows than the top capacity tier (the full recount)."""
    rng = np.random.default_rng(7)
    counter = Counter()
    for _ in range(3000):
        word = "".join(rng.choice(list("abcd"), size=int(rng.integers(3, 12))))
        counter[word.encode()] += int(rng.integers(1, 4))
    return _tables(counter, [])


@pytest.mark.parametrize("layout", [(2, 1, 0), (2, 2, 0), (1, 4, 0), (2, 1, 8)],
                         ids=lambda t: "x".join(map(str, t)))
def test_many_equal_counts_and_full_recounts(ties, layout):
    """The tie-break over slabs (count, lex left, lex right) and the full
    recount past the top tier, against the JAX loop."""
    cap = 256 + 120
    got, stats = _port(ties, *layout, cap=cap)
    want, _ = _jax(ties, *layout, cap=cap)
    assert np.array_equal(got, want)
    assert (got[:, 0] >= 0).sum() == 120
    assert stats["full_recounts"] > 0


def _jax_state_after(tables, d, v, chunks):
    """The JAX loop's state after ``chunks`` chunks of CHUNK steps, built
    from its own pieces as run_sharded_merge_loop builds it."""
    from yabpe_tpu.train.bigvocab import BigState
    from yabpe_tpu.train.incremental import init_counts, pick_affected_cap
    from yabpe_tpu.train.state import init_state

    table, base = tables[2], tables[3]
    table = table.pad_rows_to(jax_sharded._round_up(table.words.shape[0], d))
    num = CAP - len(base)
    mesh = jax_2d_mesh(d, v)
    core = init_state(table, base, CAP, num)
    core_specs = jax_sharded.state_partition_specs()
    kw = dict(vocab_cap=CAP, min_frequency=1, num_merges=num, chunk_size=CHUNK,
              affected_cap=pick_affected_cap(table.words.shape[0] // d))
    shard = lambda specs: jax.tree.map(  # noqa: E731
        lambda s: NamedSharding(mesh, s), specs, is_leaf=lambda x: isinstance(x, P)
    )
    if v > 1:
        core = put_global(core, shard(core_specs))
        init = jax.jit(jax.shard_map(
            partial(jax_sharded._init_slab_body, vocab_cap=CAP, rows_per=CAP // v),
            mesh=mesh, in_specs=(core_specs.words, core_specs.freqs),
            out_specs=(P("vocab"), P("vocab")), check_vma=False,
        ))
        slab, row_max = init(core.words, core.freqs)
        state = jax_sharded.Shard2DState(core=core, slab=slab, row_max=row_max)
        specs = jax_sharded.Shard2DState(core=core_specs, slab=P("vocab"), row_max=P("vocab"))
        body = partial(jax_sharded._sharded_chunk_2d, vocab_shards=v, **kw)
    else:
        counts = init_counts(core.words, core.freqs, vocab_cap=CAP)
        state = BigState(core=core, counts=counts,
                         row_max=jnp.max(counts.reshape(CAP, CAP), axis=1))
        specs = BigState(core=core_specs, counts=P(), row_max=P())
        body = partial(jax_sharded._sharded_chunk_incremental, **kw)
    state = put_global(state, shard(specs))
    fn = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(specs, P()),
                               out_specs=specs, check_vma=False))
    for c in range(chunks):
        state = fn(state, jnp.asarray(c * CHUNK, jnp.int32))
    counts = state.slab if v > 1 else state.counts
    return state.core, np.asarray(counts), np.asarray(state.row_max)


@pytest.mark.parametrize("d,v", [(2, 1), (2, 2)], ids=["2x1", "2x2"])
def test_state_at_chunk_boundaries_matches_jax(large, d, v):
    """Words, the count table (the slabs concatenated), its row bounds and
    the token table after one and two chunks equal the JAX loop's."""
    table, base = large[0], large[1]
    table = table.pad_rows_to(sharded._round_up(table.words.shape[0], d))
    mesh = make_2d_mesh(d, v, "cpu")
    num = CAP - len(base)
    state, _ = sharded.init_sharded_state(table, base, mesh, vocab_cap=CAP, num_merges=num)
    cap = sharded.pick_affected_cap(table.words.shape[0] // d)
    for chunks in (1, 2):
        start = (chunks - 1) * CHUNK
        sharded.run_steps(state, mesh, start, start + CHUNK, min_frequency=1, affected_cap=cap)
        core, counts, row_max = _jax_state_after(large, d, v, chunks)
        assert np.array_equal(torch.cat(state.words).numpy(), np.asarray(core.words))
        assert np.array_equal(torch.cat(state.slabs).numpy(), counts)
        assert np.array_equal(torch.cat(state.row_max).numpy(), row_max)
        for name in ("token_bytes", "token_len", "lex_rank", "merges", "next_id"):
            assert np.array_equal(getattr(state.vocab, name).numpy(), np.asarray(getattr(core, name))), name


@pytest.mark.parametrize("seed", range(3))
def test_estimate_followup_matches_jax(seed):
    from yabpe_tpu.dist.speculative import estimate_followup as jax_estimate

    rng = np.random.default_rng(seed)
    v = 40
    gview = rng.integers(0, 500, size=v * v).astype(np.int32)
    gview[rng.random(v * v) < 0.4] = 0
    rmv = gview.reshape(v, v).max(axis=1).astype(np.int32)
    left, right = (int(x) for x in rng.integers(0, v, size=2))
    new_sym, do = int(rng.integers(0, v)), bool(seed != 2)
    cnt = int(gview[left * v + right])
    want_g, want_rm = jax_estimate(
        jnp.asarray(gview), jnp.asarray(rmv), jnp.int32(left), jnp.int32(right),
        jnp.int32(cnt), jnp.int32(new_sym), jnp.bool_(do), v,
    )
    got_g, got_rm = speculative.estimate_followup(
        torch.from_numpy(gview.copy()), torch.from_numpy(rmv.copy()),
        torch.tensor(left, dtype=torch.int32), torch.tensor(right, dtype=torch.int32),
        torch.tensor(cnt, dtype=torch.int32), torch.tensor(new_sym, dtype=torch.int32),
        torch.tensor(do), v,
    )
    assert np.array_equal(got_g.numpy(), np.asarray(want_g))
    assert np.array_equal(got_rm.numpy(), np.asarray(want_rm))


def test_one_spec_epoch_matches_jax(large):
    """One speculate/exchange/validate epoch of k=8 from merge 5 (a state
    seeded by five per-step merges): the merges it commits, the words, the
    count table and its bounds equal the JAX epoch's."""
    from yabpe_tpu.dist.speculative import _spec_epoch as jax_epoch
    from yabpe_tpu.train.bigvocab import BigState
    from yabpe_tpu.train.incremental import init_counts, pick_affected_cap
    from yabpe_tpu.train.state import init_state

    d, k, start = 2, 8, 5
    table, base = large[0], large[1]
    num = CAP - len(base)
    mesh = make_2d_mesh(d, 1, "cpu")
    state, _ = sharded.init_sharded_state(table, base, mesh, vocab_cap=CAP, num_merges=num)
    cap0 = sharded.pick_affected_cap(table.words.shape[0] // d)
    sharded.run_steps(state, mesh, 0, start, min_frequency=1, affected_cap=cap0)
    p, stopped = speculative._spec_epoch(
        state, mesh, start, k=k, min_frequency=1, num_merges=num, cap0=cap0, cap=min(256, cap0),
    )

    jt, jb = large[2], large[3]
    jmesh = jax_2d_mesh(d, 1)
    core = init_state(jt, jb, CAP, num)
    counts = init_counts(core.words, core.freqs, vocab_cap=CAP)
    jstate = BigState(core=core, counts=counts, row_max=jnp.max(counts.reshape(CAP, CAP), axis=1))
    specs = BigState(core=jax_sharded.state_partition_specs(), counts=P(), row_max=P())
    jstate = put_global(jstate, jax.tree.map(
        lambda s: NamedSharding(jmesh, s), specs, is_leaf=lambda x: isinstance(x, P)))
    kw = dict(vocab_cap=CAP, min_frequency=1, num_merges=num)
    steps = jax.jit(jax.shard_map(
        partial(jax_sharded._sharded_chunk_incremental, chunk_size=start,
                affected_cap=pick_affected_cap(jt.words.shape[0] // d), **kw),
        mesh=jmesh, in_specs=(specs, P()), out_specs=specs, check_vma=False))
    jstate = steps(jstate, jnp.int32(0))
    epoch = jax.jit(jax.shard_map(
        lambda s, ptr: jax_epoch(s, ptr, k=k, cap0=cap0, cap=min(256, cap0), **kw),
        mesh=jmesh, in_specs=(specs, P()), out_specs=(specs, P()), check_vma=False))
    jstate, jp = epoch(jstate, jnp.int32(start))
    assert p == int(jp) and p > 1 and not stopped
    assert np.array_equal(torch.cat(state.words).numpy(), np.asarray(jstate.core.words))
    assert np.array_equal(torch.cat(state.slabs).numpy(), np.asarray(jstate.counts))
    assert np.array_equal(state.row_max[0].numpy(), np.asarray(jstate.row_max))
    assert np.array_equal(state.vocab.merges.numpy(), np.asarray(jstate.core.merges))
