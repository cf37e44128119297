"""The port's sharded merge loop (yabpe_tpu_torch.dist.sharded and
dist/speculative.py) held against the JAX package's on the conftest's 8
virtual CPU devices.

Inputs come from tests/data/large.txt and from corpora made from a seed
with numpy; they go through both packages. Every comparison is exact: the
state is integers, and the follow-up estimate's float32 arithmetic is
compared bit for bit through the integer view it produces.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import pytest
import torch

import jax

from yabpe_tpu.core.vocab import Vocab as JaxVocab
from yabpe_tpu.core.wordtable import WordTable as JaxWordTable
from yabpe_tpu.dist import sharded as jax_sharded
from yabpe_tpu.train import checkpoint as jax_ckpt
from yabpe_tpu_torch import BBPETrainerConfig
from yabpe_tpu_torch.core.vocab import Vocab
from yabpe_tpu_torch.core.wordtable import WordTable
from yabpe_tpu_torch.dist import sharded
from yabpe_tpu_torch.pretok.ingest import count_pretokens
from yabpe_tpu_torch.train import checkpoint
from yabpe_tpu_torch.train.hbm_driver import run_hbm_merge_loop

from .common import DATA

SPECIALS = ["<|endoftext|>"]
CAP = 400
CHUNK = 64
LAYOUTS = [(2, 1, 0), (4, 1, 0), (2, 2, 0), (1, 4, 0), (4, 1, 16), (8, 1, 4)]

pytestmark = pytest.mark.skipif(
    len(jax.devices("cpu")) < 8, reason="needs the 8 virtual CPU devices"
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and these tensors are small."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tables(counter, specials):
    """The same word table for both packages."""
    return (
        WordTable.from_counter(counter), Vocab.base(specials),
        JaxWordTable.from_counter(counter), JaxVocab.base(specials),
    )


@pytest.fixture(scope="module")
def large():
    return _tables(count_pretokens([DATA / "large.txt"], SPECIALS, max_workers=1), SPECIALS)


def _port(tables, d, v, s, cap=CAP, **kw):
    table, base = tables[0], tables[1]
    stats: dict = {}
    merges = sharded.run_sharded_merge_loop(
        table, base, vocab_cap=cap, num_merges=cap - len(base), min_frequency=1,
        data_shards=d, vocab_shards=v, spec_batch=s, chunk_size=CHUNK,
        stats_out=stats, device="cpu", **kw,
    )
    return merges, stats


def _jax(tables, d, v, s, cap=CAP, **kw):
    table, base = tables[2], tables[3]
    stats: dict = {}
    merges = jax_sharded.run_sharded_merge_loop(
        table, base, vocab_cap=cap, num_merges=cap - len(base), min_frequency=1,
        data_shards=d, vocab_shards=v, spec_batch=s, chunk_size=CHUNK,
        stats_out=stats, **kw,
    )
    return merges, stats


@pytest.fixture(scope="module")
def jax_runs(large):
    return {layout: _jax(large, *layout) for layout in LAYOUTS}


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda t: "x".join(map(str, t)))
def test_merges_match_jax(large, jax_runs, layout):
    """(data, vocab, spec): the merge records equal the JAX loop's, and the
    single-device route's; the speculative layouts also run the JAX loop's
    epochs and k schedule."""
    got, stats = _port(large, *layout)
    want, want_stats = jax_runs[layout]
    assert np.array_equal(got, want)
    single = run_hbm_merge_loop(
        large[0], large[1], vocab_cap=CAP, num_merges=CAP - len(large[1]),
        min_frequency=1, device="cpu",
    )
    assert np.array_equal(got, single)
    for key in want_stats:
        assert stats[key] == want_stats[key], key
    assert stats["steps"] + stats.get("spec_commits", 0) == CAP - len(large[1])


@pytest.mark.parametrize("layout", [(4, 1, 0), (2, 2, 0), (4, 1, 8)], ids=lambda t: "x".join(map(str, t)))
def test_early_stop_matches_jax(layout):
    """min_frequency stops the loop mid-chunk (and mid-epoch)."""
    counter = Counter({b"ab": 4, b"cd": 2})
    tables = _tables(counter, [])
    kw = dict(vocab_cap=300, num_merges=44, min_frequency=3, data_shards=layout[0],
              vocab_shards=layout[1], spec_batch=layout[2], chunk_size=16)
    got = sharded.run_sharded_merge_loop(tables[0], tables[1], device="cpu", **kw)
    want = jax_sharded.run_sharded_merge_loop(tables[2], tables[3], **kw)
    assert np.array_equal(got, want)
    assert (got[0] == [ord("a"), ord("b"), 256]).all() and (got[1:] == -1).all()


@pytest.mark.parametrize("layout", [(4, 1, 0), (2, 2, 0), (2, 1, 8)], ids=lambda t: "x".join(map(str, t)))
def test_resume_from_a_jax_checkpoint(large, jax_runs, tmp_path, layout):
    """A record the JAX package cut at merge 40 and saved resumes in the
    port, 1-D and 2D, to the uninterrupted run's merges."""
    full = jax_runs[(4, 1, 0)][0]
    cfg = BBPETrainerConfig(vocab_size=CAP, min_frequency=1, special_tokens=SPECIALS)
    record = np.full_like(full, -1)
    record[:40] = full[:40]
    jax_ckpt.save_checkpoint(tmp_path, record, 40, cfg)
    loaded = checkpoint.load_checkpoint(tmp_path, cfg)
    assert loaded is not None and loaded[1] == 40
    saved = []
    got, _ = _port(large, *layout, resume=loaded, on_chunk=lambda m, n: saved.append(n))
    assert np.array_equal(got, full)
    assert saved and saved[-1] == CAP - len(large[1])
