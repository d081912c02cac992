"""The port's bulk plane build (K9) as a two-level partition: the plain
versions of its wrappers in turn (the histogram tables, their scan, level 1
per batch, level 2 sorting each tile in place, bulk_apply_plain) against
commet_tpu's bulk build (kernels.bulk_plane_sorted, bulk_scatter_set,
bulk_or_plane) and against the single-level layout of the first design
(every entry appended to its 64 KiB slice's bin), at edge shapes, and the
one entry buffer and level 2's table in the engine's memory checks. Exact
equality throughout; a slice's entries are compared as a multiset (the
kernels place them in the order their shared-memory atomics land)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from commet_tpu.core import kernels
from commet_tpu.core import stream as jstream
from commet_tpu_torch.core import keys, planes
from commet_tpu_torch.engine import engine as tengine
from test_torch_bulk_build import _batch, _fasta, _two_level, _wrappers_build
from torch_helpers import encode, random_seqs, read_set


def _jax_bulk(codes, chunks, k):
    """commet_tpu's bulk build of ``codes`` in the given row chunks."""
    wide, w = k > 32, kernels.plane_words(k)
    want = kernels.alloc_planes(k)
    jcodes = jnp.asarray(codes.astype(np.int32))
    for rows in chunks:
        ka, kb, hib, fl, _cnt = jstream.chunk_index_keys_codes(jcodes[rows],
                                                               k)
        for p in range(4):
            word, or_mask = kernels.bulk_plane_sorted(
                ka, kb, hib if wide else fl, fl, k, p, wide)
            scratch = kernels.bulk_scatter_set(jnp.zeros(w, jnp.uint32),
                                               word, or_mask)
            want = kernels.bulk_or_plane(want, scratch, p * w, w)
    return np.asarray(want)


@pytest.mark.parametrize("k", [15, 21, 32, 33])
def test_two_level_chain_matches_jax(k):
    """On numpy-seeded reads with 3% invalid bases (one all-T read: bit 31
    of its words), two chunks through the plain two-level chain equal
    commet_tpu's bulk build word for word."""
    rng = np.random.default_rng(60 + k)
    n, lpad = 300, 64
    codes = rng.integers(0, 4, size=(n, lpad)).astype(np.uint8)
    codes[rng.random(size=codes.shape) < 0.03] = 4
    codes[0] = 3
    want = _jax_bulk(codes, (slice(0, 170), slice(170, n)), k)
    got = planes.alloc_planes(k, "cpu")
    _wrappers_build(got, [_batch(codes[:90]), _batch(codes[90:170])], k)
    _wrappers_build(got, [_batch(codes[170:])], k)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    assert (want >= 1 << 31).any()


def _single_level(batches, k):
    """(bins, offsets) of the design before the two levels: every entry
    appended to its fine bin (plane * nslices + (key >> sb)) in window
    order, plane by plane."""
    sb, _sw, ns, _rb = planes.bulk_layout(k)
    fine, entry = [], []
    for c2, aux, clean, length in batches:
        codes = (keys.unpack_codes_clean(c2, aux, length) if clean
                 else keys.unpack_codes(c2, aux, length))
        a, b = keys.index_keys(codes, k)
        for p, key in enumerate(planes.four_plane_keys(a, b)):
            fine.append(p * ns + (key >> sb))
            entry.append(key & ((1 << sb) - 1))
    fine, entry = torch.cat(fine), torch.cat(entry)
    offsets = torch.zeros(4 * ns + 1, dtype=torch.int64)
    offsets[1:] = torch.cumsum(torch.bincount(fine, minlength=4 * ns), 0)
    return entry[torch.argsort(fine, stable=True)].to(torch.int32), offsets


def _slice_view(mid, table, counts, cstart, k):
    """(bins, offsets) of the in-place layout in the single-level shape:
    each fine bin's runs, tile by tile (level 2's table), concatenated in
    bin order, slice-relative."""
    sb = planes.bulk_layout(k)[0]
    fine, first, n = planes.bulk_runs(table, cstart, k)
    bins = torch.cat([torch.zeros(0, dtype=torch.int32)] + [
        mid[int(first[r]):int(first[r] + n[r])]
        for r in torch.argsort(fine, stable=True).tolist()])  # tiles in order
    offsets = torch.zeros(counts.numel() + 1, dtype=torch.int64)
    offsets[1:] = torch.cumsum(counts, 0)
    return bins & ((1 << sb) - 1), offsets


def _slices(bins, offsets):
    """Each entry keyed by its slice, sorted: the slices as multisets."""
    n = offsets[1:] - offsets[:-1]
    s = torch.repeat_interleave(torch.arange(n.numel()), n)
    return torch.sort(s * (1 << 32) + bins[:s.numel()].to(torch.int64)).values


def test_two_level_layout_matches_single_level():
    """At k = 21, 27 and 33, dirty and clean batches of 1-300 bp reads (more
    than one histogram block a batch): the fine counts of the two-level
    chain equal the single-level design's, and each slice's runs, tile by
    tile through level 2's table, hold the same entries."""
    rng = np.random.default_rng(70)
    for k in (21, 27, 33):
        batches = [_batch(encode(random_seqs(rng, 400, 1, 300, n_frac=f),
                                 lpad=320), f == 0.0) for f in (0.02, 0.0)]
        assert planes.bulk_blocks(batches[0][0]) == 2
        bins, offsets = _slice_view(*_two_level(batches, k), k)
        want_bins, want_offsets = _single_level(batches, k)
        assert torch.equal(offsets, want_offsets)
        assert torch.equal(_slices(bins, offsets),
                           _slices(want_bins, want_offsets))


def test_two_level_edges():
    """Planes smaller than a slice (k = 4, 18) or one region (k = 20, 26),
    a chunk with no complete window (reads shorter than k, all-N reads, a
    batch padded to less than k), 300 bp reads, and a chunk skewed into
    plane D's last region (2% A: one coarse bin holds more than a level-2
    tile) build the per-batch build's planes; the histogram's rows are
    blocks of 256 reads, their scan puts coarse bin c's runs at cstart[c]
    in (batch, block) order."""
    rng = np.random.default_rng(71)
    for k in (4, 18, 20, 26, 33):
        short = encode(random_seqs(rng, 30, 1, k - 1, n_frac=0.0), lpad=k + 8)
        empty = [_batch(short, True), _batch(np.full((5, k + 8), 4, np.uint8)),
                 _batch(np.full((7, max(1, k - 2)), 2, np.uint8), True)]
        _mid, table, counts, _cstart = _two_level(empty, k)
        assert not counts.any() and not table.any()
        assert not _wrappers_build(planes.alloc_planes(k, "cpu"), empty,
                                   k).any()
        long = encode(random_seqs(rng, 300, 250, 300, n_frac=0.01), lpad=320)
        skew = np.full((300, 320), 4, dtype=np.uint8)
        skew[:, :300] = rng.choice(4, (300, 300), p=[0.02, 0.33, 0.33, 0.32])
        full = [_batch(long), _batch(skew, True)] + empty
        want = planes.alloc_planes(k, "cpu")
        for bt in full:
            planes.build_planes(want, *bt, k)
        got = _wrappers_build(planes.alloc_planes(k, "cpu"), full, k)
        assert torch.equal(got, want)
        tables = [planes.bulk_histogram(*bt, k) for bt in full]
        assert [t.shape[0] for t in tables] == [2, 2, 1, 1, 1]
        starts, cstart = planes.bulk_starts(torch.cat(tables))
        assert torch.equal(starts[:, 0], cstart[:-1])
        assert torch.equal(starts[:, 1] - starts[:, 0],
                           tables[0][0].to(torch.int64))
        if k == 33:
            # plane D's last region (coarse bin 255) against a tile
            assert int(cstart[-1] - cstart[-2]) > planes.BULK_TILE


def test_workspace_counts_second_buffer(tmp_path, monkeypatch):
    """The second entry buffer is gone from the chunk workspace:
    bulk_workspace_bytes counts one entry buffer (16 B a window slot,
    level 2 sorting it in place) and level 2's table beside
    each kept batch and its tables; with the memory faked so that the
    planes and the buffer fit and the table does not, Engine.build_planes
    raises its MemoryError before allocating and build_resident_planes
    declines the set."""
    slots, upload = 65536 * 68, 65536 * 40
    chunk = 1 << 27
    n_batches = chunk // slots + 1
    work = planes.bulk_workspace_bytes(33, chunk, slots, upload, 65536)
    # the table: 257 int16 slice starts a tile, at most ceil(entries /
    # 16,384) + 256 tiles (about 17 MB at 31 batches)
    table = 2 * 257 * (-(-4 * n_batches * slots // 16384) + 256)
    assert table == 2 * planes.bulk_table_size(4 * n_batches * slots, 33)
    assert 16e6 < table < 18e6
    # the tables: 31 batches x 256 blocks x 256 coarse bins x 20 B
    assert work - n_batches * (16 * slots + upload) == (
        n_batches * 256 * 256 * 20 + table + 8 * 4 * (1 << 14)
        + 4 * 8 * 257)
    assert 16 * chunk < work < 2 * 16 * chunk
    k = 15
    monkeypatch.setenv("COMMET_TPU_BULK_BUILD", "force")
    rs = read_set("I", _fasta(tmp_path, 8, n=100))
    enc, elig = tengine.EncodedSet(rs), rs.eligible()
    eng = tengine.Engine(k=k, t=2, device="cpu")
    eng.device = torch.device("cuda")  # the memory checks only: no card used
    chunk = eng.bulk_chunk()
    work = eng._bulk_bytes(tengine._geometry(enc.read_lengths(elig), k),
                           chunk)
    batch_slots = 65536 * (96 - k + 1)  # 70 bp reads, lpad 96
    n_batches = chunk // batch_slots + 1
    no_table = work - 2 * planes.bulk_table_size(4 * n_batches * batch_slots,
                                                 k)
    assert no_table > n_batches * 16 * batch_slots
    free = {"bytes": planes.plane_bytes(k) + no_table}
    monkeypatch.setattr(eng, "_free_bytes", lambda dev=None: free["bytes"])
    with pytest.raises(MemoryError, match="chunk workspace"):
        eng.build_planes(enc, elig)
    free["bytes"] = (planes.plane_bytes(k) + no_table
                     + tengine.PLANES_WORKSPACE_BYTES)
    assert eng.build_resident_planes(rs) is None
    free["bytes"] += work - no_table
    assert eng._planes_budget(None) >= planes.plane_bytes(k) + work
