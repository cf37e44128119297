"""Batched device encoder: a merge-rank scan over padded tiles of words.

Counterpart of yabpe_tpu/tok/device_encode.py, in torch ops on the
encoder's device (the card, or the CPU in the tests). Pre-tokens are
packed into [rows, width] int32 tiles of symbol ids, -1 padded; each
iteration of the scan finds each row's lowest-rank adjacent pair by a
binary search over the sorted pair keys, merges its leftmost
non-overlapping occurrences and compacts the row: the batch-merge
formulation of yabpe_tpu_torch.tok.tokenizer, equal to the reference's
per-word heap.

Symbols live in the extended table of yabpe_tpu_torch.tok.symbols: ids
0..255 are the bytes, and each live merge adds (or reuses) the id of its
product, so a merge whose product is not in the vocab still applies and
only the final id lookup falls back to [UNK]. A pair that the merges list
twice keeps its last rank.

The JAX package packs a pair key as uint32 ``left * n_syms + right`` and
so caps the table at 65,535 symbols; past it :class:`SymbolTableTooLarge`
sends the batch to the host. The port keeps the cap and that routing; its
keys are int64, because torch's ``searchsorted`` takes no uint32.

The JAX scan is one ``while_loop`` on the device. Here the loop is on the
host, and a test for work is a host sync. Every iteration on a row with
work removes at least one symbol from it, and an iteration on a row
without work leaves it as it is, so ``L - 1`` iterations finish every row
of at most ``L`` symbols and more change nothing. :func:`scan_encode`
therefore runs up to that bound and tests for work only every
``check_every`` iterations before it: a tile whose longest word has at
most ``check_every + 1`` symbols costs no sync in the loop.
"""

from __future__ import annotations

import time
from collections.abc import Sequence

import numpy as np
import torch

from yabpe_tpu_torch import native
from yabpe_tpu_torch.core.wordtable import PAD
from yabpe_tpu_torch.kernels.merge_apply import apply_rowwise_merge, leftmost_nonoverlapping

_NO_RANK = 2**30
#: Scan iterations between two tests for work (host syncs).
CHECK_EVERY = 8


class SymbolTableTooLarge(ValueError):
    """The extended symbol table exceeds the packed pair-key range."""


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _scan_step(
    words: torch.Tensor,
    sorted_keys: torch.Tensor,
    sorted_ranks: torch.Tensor,
    sorted_new_syms: torch.Tensor,
    n_syms: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One iteration: (the new words, the positions of each row's
    lowest-rank pair, none in a row without work)."""
    left, right = words[:, :-1], words[:, 1:]
    valid = (left >= 0) & (right >= 0)
    key = left.long() * n_syms + right.long()
    num_keys = sorted_keys.shape[0]
    pos = torch.searchsorted(sorted_keys, key)
    pos_c = pos.clamp_max(num_keys - 1)
    found = valid & (pos < num_keys) & (sorted_keys[pos_c] == key)
    rank = torch.where(found, sorted_ranks[pos_c], _NO_RANK)
    row_min = rank.amin(dim=1, keepdim=True)
    match = (rank == row_min) & (rank < _NO_RANK)
    applied = leftmost_nonoverlapping(match)
    return apply_rowwise_merge(words, applied, sorted_new_syms[pos_c]), match


def scan_encode(
    words: torch.Tensor,
    sorted_keys: torch.Tensor,
    sorted_ranks: torch.Tensor,
    sorted_new_syms: torch.Tensor,
    n_syms: int,
    *,
    max_iters: int | None = None,
    check_every: int = CHECK_EVERY,
    stats: dict | None = None,
) -> torch.Tensor:
    """Scan iterations until no row has a mergeable pair.

    Args:
        words: int32 [rows, width] symbol ids, each row compacted, -1 padded.
        sorted_keys: int64 [K] pair keys ``left * n_syms + right``, sorted.
        sorted_ranks / sorted_new_syms: int32 [K], the merge rank and the
            product symbol of each key.
        n_syms: the extended symbol table's size.
        max_iters: a bound on the iterations that suffices: one less than
            the most symbols a row holds (default ``width - 1``).
        check_every: iterations between two tests for work.
        stats: adds ``iterations`` and ``syncs`` (tests for work) to it.

    Returns:
        The encoded rows; ``words`` is not changed.
    """
    bound = words.shape[1] - 1
    if max_iters is not None:
        bound = min(bound, max_iters)
    done = syncs = 0
    while done < bound:
        for _ in range(min(check_every, bound - done)):
            words, match = _scan_step(words, sorted_keys, sorted_ranks, sorted_new_syms, n_syms)
            done += 1
        if done < bound:
            syncs += 1
            if not bool(match.any()):
                break
    if stats is not None:
        stats["iterations"] = stats.get("iterations", 0) + done
        stats["syncs"] = stats.get("syncs", 0) + syncs
    return words


class DeviceEncoder:
    """Packs pre-tokens into tiles and encodes them with the scan on
    ``device``.

    ``data_shards``: each tile's rows are split into that many blocks over
    a data mesh (dist/mesh.py, all on ``device`` in this version), each
    block scanned on its own; None or 1 scans whole tiles.

    ``stats`` counts tiles, scan iterations and host syncs, new words and
    readbacks, and ``encode_file``'s seconds on the host clock: the native
    scans (``host_scan_s``), the tiles' packing and the issue of their
    scans (``dispatch_s``), and the readbacks (``collect_s``). Set
    ``scan_events`` to a list to record a pair of CUDA events around each
    tile's scan.
    """

    def __init__(
        self,
        vocab: dict[bytes, int],
        merges: list[tuple[bytes, bytes]],
        special_tokens: list[str] | None = None,
        *,
        max_rows: int = 8192,
        data_shards: int | None = None,
        device: str | torch.device = "cuda",
    ) -> None:
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "the device encoder was asked for CUDA and no CUDA device is "
                "present; pass compute_device='cpu' to run it on the CPU"
            )
        self._vocab = vocab
        self._mesh = None
        if data_shards and data_shards > 1:
            from yabpe_tpu_torch.dist.mesh import make_data_mesh

            self._mesh = make_data_mesh(data_shards, self.device)
            max_rows = _round_up(max_rows, data_shards)
        self._data_shards = data_shards or 1
        self._special_tokens = special_tokens or []
        self._special_set = frozenset(self._special_tokens)
        self._patterns = None  # (GPT-2 pattern, special splitter), lazily
        self._unk_id = vocab.get(b"[UNK]", 0)
        self._max_rows = max_rows
        self._word_cache: dict[str, tuple[int, ...]] = {}
        self._word_cache_b: dict[bytes, tuple[int, ...]] = {}
        self.stats = dict.fromkeys(("tiles", "iterations", "syncs", "new_words", "readbacks"), 0)
        self.stats.update(dict.fromkeys(("host_scan_s", "dispatch_s", "collect_s"), 0.0))
        self.scan_events: list | None = None

        from yabpe_tpu_torch.tok.symbols import extended_symbol_tables

        sym_bytes, live, out_ids = extended_symbol_tables(vocab, merges, self._unk_id)
        n_syms = len(sym_bytes)
        if n_syms > 0xFFFF:
            raise SymbolTableTooLarge(
                f"extended symbol table has {n_syms} entries; uint32 pair "
                "keys support at most 65535"
            )
        self._n_syms = n_syms
        if live:
            packed = sorted(
                (sl * n_syms + sr, rank, st) for (sl, sr), (rank, st) in live.items()
            )
            keys, ranks, syms = (np.array(col) for col in zip(*packed))
        else:
            keys, ranks, syms = np.zeros(1), np.full(1, _NO_RANK), np.zeros(1)
        self._sorted_keys = torch.as_tensor(keys.astype(np.int64), device=self.device)
        self._sorted_ranks = torch.as_tensor(ranks.astype(np.int32), device=self.device)
        self._sorted_new_syms = torch.as_tensor(syms.astype(np.int32), device=self.device)
        self._out_ids = out_ids

    # ------------------------------------------------------------------ public

    def encode_batch(self, texts: Sequence[str]) -> list[list[int]]:
        """Encode texts; every new pre-token crosses to the device in one
        set of tiles.

        With the native scanner the host side is vectorized: unique-word ids
        per pre-token occurrence from the C++ scanner, one device pass over
        the new unique words, then one numpy gather per text.
        """
        if native.available():
            return self._encode_batch_native(texts)
        parts_per_text = [self._split(t) for t in texts]
        new_words: list[str] = []
        seen: set[str] = set()
        for parts in parts_per_text:
            for is_special, piece in parts:
                if not is_special and piece not in self._word_cache and piece not in seen:
                    seen.add(piece)
                    new_words.append(piece)
        if new_words:
            encoded = self._encode_word_rows([w.encode("utf-8") for w in new_words])
            self._word_cache.update(zip(new_words, encoded))

        out: list[list[int]] = []
        for parts in parts_per_text:
            ids: list[int] = []
            for is_special, piece in parts:
                if is_special:
                    sid = self._vocab.get(piece.encode("utf-8"))
                    if sid is not None:
                        ids.append(sid)
                else:
                    ids.extend(self._word_cache[piece])
            out.append(ids)
        return out

    def encode_file(self, path, *, chunk_bytes: int = 4 * 1024 * 1024) -> np.ndarray:
        """Encode a whole file exactly through the scan. Needs the native
        scanner.

        The file is cut at pretoken-safe points
        (yabpe_tpu_torch.tok.parallel_encode.safe_cut_points), so the ids
        equal ``encode(file_contents)``. Chunk i's scans are issued before
        the native scan of chunk i+1 and read back after it, so what the
        device still has queued runs under that scan, as in the JAX
        package. The word cache persists across chunks and calls: a warm
        second file pays no scan for words already seen.
        """
        if not native.available():
            raise RuntimeError("device encode_file requires the native scanner")
        from yabpe_tpu_torch.tok.parallel_encode import safe_cut_points

        spans = safe_cut_points(path, chunk_bytes, self._special_tokens)
        specials_sorted = sorted(self._special_tokens, key=len, reverse=True)
        sp_ids = [self._vocab.get(s.encode("utf-8")) for s in specials_sorted]
        cache = self._word_cache_b
        stats = self.stats
        results: list[np.ndarray] = []
        prev = None  # (occ, uniq, new, pending tiles)
        with open(path, "rb") as f:
            for start, end in spans:
                t0 = time.perf_counter()
                f.seek(start)
                data = f.read(end - start)
                counter = native.NativeCounter(tuple(specials_sorted))
                try:
                    occ = counter.add_word_ids_specials(data)
                    uniq = counter.export_words()
                finally:
                    counter.close()
                new = [w for w in uniq if w not in cache]
                t1 = time.perf_counter()
                pending = self._dispatch_word_rows(new)
                stats["host_scan_s"] += t1 - t0
                stats["dispatch_s"] += time.perf_counter() - t1
                if prev is not None:
                    results.append(self._finish_chunk(*prev, sp_ids))
                prev = (occ, uniq, new, pending)
        if prev is not None:
            results.append(self._finish_chunk(*prev, sp_ids))
        if not results:
            return np.empty(0, dtype=np.int32)
        return np.concatenate(results)

    # ----------------------------------------------------------------- helpers

    def _finish_chunk(self, occ, uniq, new, pending, sp_ids) -> np.ndarray:
        t0 = time.perf_counter()
        encodings = self._collect_word_rows(len(new), pending)
        self.stats["collect_s"] += time.perf_counter() - t0
        self._word_cache_b.update(zip(new, encodings))
        return self._occ_to_ids(occ, self._flat_table(uniq, sp_ids))

    def _flat_table(self, uniq: list[bytes], sp_ids: list[int | None]):
        """(flat ids, starts, lengths, unique words) of the unique words'
        encodings, then one pseudo-word per special: its vocab id, or empty
        where the special is not in the vocab (the reference drops it)."""
        cache = self._word_cache_b
        encodings = [cache[w] for w in uniq]
        encodings.extend((sid,) if sid is not None else () for sid in sp_ids)
        lens = np.array([len(e) for e in encodings], dtype=np.int64)
        starts = np.zeros(len(encodings), dtype=np.int64)
        if len(encodings):
            np.cumsum(lens[:-1], out=starts[1:])
        flat = np.empty(int(lens.sum()), dtype=np.int32)
        for s, enc in zip(starts.tolist(), encodings):
            flat[s : s + len(enc)] = enc
        return flat, starts, lens, len(uniq)

    @staticmethod
    def _occ_to_ids(occ: np.ndarray, table) -> np.ndarray:
        """Expand occurrence ids (``-(1 + i)`` for special i) to token ids:
        one segment gather over the flat table."""
        flat, starts, lens, n_uniq = table
        if not len(occ):
            return np.empty(0, dtype=np.int32)
        occ = np.where(occ >= 0, occ, n_uniq + (-occ - 1))
        length = lens[occ]
        csum = np.cumsum(length)
        idx = np.arange(int(csum[-1]), dtype=np.int64) + np.repeat(starts[occ] - (csum - length), length)
        return flat[idx]

    def _encode_batch_native(self, texts: Sequence[str]) -> list[list[int]]:
        # One native pass per text: unique-word ids per pre-token
        # occurrence, -(1 + special index) per special occurrence (the
        # tokenizer dialect, longest first).
        specials_sorted = sorted(self._special_tokens, key=len, reverse=True)
        sp_ids = [self._vocab.get(s.encode("utf-8")) for s in specials_sorted]
        counter = native.NativeCounter(tuple(specials_sorted))
        try:
            occs = [
                counter.add_word_ids_specials(text.encode("utf-8"))
                if text else np.empty(0, dtype=np.int32)
                for text in texts
            ]
            uniq = counter.export_words()
        finally:
            counter.close()
        cache = self._word_cache_b
        new = [w for w in uniq if w not in cache]
        if new:
            cache.update(zip(new, self._encode_word_rows(new)))
        table = self._flat_table(uniq, sp_ids)
        return [self._occ_to_ids(occ, table).tolist() for occ in occs]

    def _split(self, text: str) -> list[tuple[bool, str]]:
        """(is_special, piece) pairs, each piece a special or a pre-token."""
        if not text:
            return []
        if self._patterns is None:
            from yabpe_tpu_torch.pretok.patterns import (
                compile_gpt2_pattern,
                compile_special_splitter,
            )

            self._patterns = (
                compile_gpt2_pattern(),
                compile_special_splitter(self._special_tokens),
            )
        pattern, splitter = self._patterns
        if splitter is None:
            return [(False, w) for w in pattern.findall(text)]
        parts: list[tuple[bool, str]] = []
        for part in splitter.split(text):
            if not part:
                continue
            if part in self._special_set:
                parts.append((True, part))
            else:
                parts.extend((False, w) for w in pattern.findall(part))
        return parts

    def _encode_word_rows(self, encoded: list[bytes]) -> list[tuple[int, ...]]:
        """Encode unique pre-tokens (bytes) through the scan."""
        return self._collect_word_rows(len(encoded), self._dispatch_word_rows(encoded))

    def pack_tiles(self, encoded: list[bytes]) -> list[tuple[list[int], np.ndarray, np.ndarray]]:
        """The tiles of ``encoded``: (word indices, int32 tile, each row's
        length) each.

        The words are sorted by length, so that long outliers share a tile
        instead of widening every one, and both dimensions are powers of
        two (rows >= 128, rounded up to the shard count; width >= 32), so a
        whole workload takes few (rows, width) shapes.
        """
        order = sorted(range(len(encoded)), key=lambda i: len(encoded[i]))
        tiles = []
        for start in range(0, len(order), self._max_rows):
            batch_idx = order[start : start + self._max_rows]
            words = [encoded[i] for i in batch_idx]
            lens = np.fromiter((len(b) for b in words), dtype=np.int64, count=len(words))
            width = 32
            while width < lens[-1]:
                width *= 2
            rows = 128
            while rows < len(words):
                rows *= 2
            rows = _round_up(rows, self._data_shards)
            tile = np.full((rows, width), PAD, dtype=np.int32)
            row_of = np.repeat(np.arange(len(words)), lens)
            col_of = np.arange(int(lens.sum())) - np.repeat(np.cumsum(lens) - lens, lens)
            tile[row_of, col_of] = np.frombuffer(b"".join(words), dtype=np.uint8)
            row_lens = np.zeros(rows, dtype=np.int64)
            row_lens[: len(words)] = lens
            tiles.append((batch_idx, tile, row_lens))
        return tiles

    def scan_tile(self, tile: torch.Tensor, row_lens: np.ndarray) -> torch.Tensor:
        """One tile's scan on the encoder's device, split into the mesh's
        blocks when it has one; each block's bound is its longest row."""
        tables = (self._sorted_keys, self._sorted_ranks, self._sorted_new_syms, self._n_syms)
        if self._mesh is None:
            return scan_encode(tile, *tables, max_iters=int(row_lens.max()) - 1, stats=self.stats)
        blocks = tile.chunk(self._data_shards)
        lens = np.split(row_lens, self._data_shards)
        out = [
            scan_encode(block.to(dev), *tables, max_iters=int(block_lens.max()) - 1, stats=self.stats)
            for block, block_lens, dev in zip(blocks, lens, self._mesh.devices)
        ]
        return torch.cat([o.to(self.device) for o in out])

    def _dispatch_word_rows(self, encoded: list[bytes]):
        """Pack the tiles and run their scans, reading nothing back; the
        returned handles feed ``_collect_word_rows``."""
        pending = []
        for batch_idx, tile, row_lens in self.pack_tiles(encoded):
            words = torch.from_numpy(tile).to(self.device, non_blocking=True)
            if self.scan_events is not None:
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
            result = self.scan_tile(words, row_lens)
            if self.scan_events is not None:
                end.record()
                self.scan_events.append((start, end))
            self.stats["tiles"] += 1
            pending.append((batch_idx, len(batch_idx), result))
        return pending

    def _collect_word_rows(self, n_words: int, pending) -> list[tuple[int, ...]]:
        """One readback for every tile: the tiles padded to one width and
        concatenated on the device, then one copy to the host."""
        out: list[tuple[int, ...] | None] = [None] * n_words
        if not pending:
            return out
        wmax = max(p.shape[1] for _, _, p in pending)
        big = torch.cat(
            [torch.nn.functional.pad(p, (0, wmax - p.shape[1]), value=PAD) for _, _, p in pending]
        ).cpu().numpy()
        self.stats["readbacks"] += 1
        self.stats["new_words"] += n_words
        row0 = 0
        for batch_idx, n, packed in pending:
            result = big[row0 : row0 + n]
            row0 += packed.shape[0]
            # A boolean mask flattens in row-major order, so one gather and
            # a cumulative sum cut every row.
            valid = result >= 0
            flat = self._out_ids[np.where(valid, result, 0)][valid].tolist()
            prev = 0
            for offset, i in zip(np.cumsum(valid.sum(axis=1)).tolist(), batch_idx):
                out[i] = tuple(flat[prev:offset])
                prev = offset
        return out


__all__ = ["CHECK_EVERY", "DeviceEncoder", "SymbolTableTooLarge", "scan_encode"]
