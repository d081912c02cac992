"""Level 2 of the port's bulk plane build (K9) as an in-place tile sort:
bulk_refine (its plain version on CPU tensors) sorts each tile of level 1's
buffer by slice over its own range, writes each tile's slice starts into
level 2's table and adds each slice's entries to the fine counts;
bulk_apply ORs each slice's runs in, tile by tile, through that table. Held
against a numpy reference on ``mid`` buffers alone, against commet_tpu's
bulk build (kernels.bulk_plane_sorted, bulk_scatter_set, bulk_or_plane)
and against the port's per-batch build, at edge shapes; and the chunk
workspace with one entry buffer and the table. Exact equality
throughout."""

import numpy as np
import pytest
import torch

from commet_tpu_torch.core import planes
from test_torch_bulk_build import _batch, _two_level, _wrappers_build
from test_torch_bulk_two_level import _jax_bulk
from torch_helpers import encode, random_seqs

TILE = planes.BULK_TILE


def _synthetic_mid(rng, k):
    """(mid, cstart, before): coarse bins of 0, 1, TILE, TILE + 1 (a
    one-entry last tile), 3 TILE + 17 and random sizes, region entries
    random or crowded into one slice or into the last slices, and 5 spare
    entries past cstart[-1] holding -7."""
    nbins, spr = planes.bulk_bins(k)
    rb = planes.bulk_layout(k)[3]
    sb = planes.bulk_layout(k)[0]
    sizes = rng.integers(0, 300, size=nbins)
    special = [0, 1, TILE, TILE + 1, 3 * TILE + 17]
    for c, size in zip(rng.permutation(nbins)[:len(special)], special):
        sizes[c] = size
    cstart = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    vals = []
    for c, size in enumerate(sizes):
        mode = c % 3
        if mode == 0:
            v = rng.integers(0, 1 << rb, size=size)
        elif mode == 1:  # one slice
            v = (rng.integers(0, spr) << sb) + rng.integers(0, 1 << sb,
                                                            size=size)
        else:  # the last slices, as plane D's a | b keys crowd
            v = (1 << rb) - 1 - rng.geometric(0.3, size=size) * (
                rng.integers(1, 1 << sb, size=size))
            v = np.clip(v, 0, (1 << rb) - 1)
        vals.append(v)
    before = np.concatenate(vals + [np.full(5, -7)]).astype(np.int32)
    return torch.from_numpy(before.copy()), torch.from_numpy(cstart), before


@pytest.mark.parametrize("k", [15, 21, 27, 33])
def test_refine_plain_sorts_tiles_in_place(k):
    """On mid buffers alone (no planes): every tile of BULK_TILE entries
    of a coarse bin is left a stable sort by slice of its own entries, the
    entries past the chunk are untouched, the table holds each tile's
    spr + 1 slice starts at its place (a coarse bin's rows as
    [slice][tile]), and the fine counts equal a bincount of
    _fine_entries."""
    rng = np.random.default_rng(120 + k)
    nbins, spr = planes.bulk_bins(k)
    sb = planes.bulk_layout(k)[0]
    mid, cstart, before = _synthetic_mid(rng, k)
    want_counts = torch.bincount(planes._fine_entries(mid, cstart, k)[0],
                                 minlength=4 * planes.bulk_layout(k)[2])
    c0 = cstart.numpy()
    cbin = np.repeat(np.arange(nbins), np.diff(c0))
    assert np.array_equal(want_counts.numpy(), np.bincount(
        cbin * spr + (before[:c0[-1]] >> sb), minlength=want_counts.numel()))
    table = planes.bulk_table(mid, k)
    counts = torch.zeros(4 * planes.bulk_layout(k)[2], dtype=torch.int64)
    planes.bulk_refine(mid, table, counts, cstart, k)
    assert torch.equal(counts, want_counts)
    got, tab = mid.numpy(), table.numpy()
    tiles = 0
    for c in range(nbins):
        nt = -(-(c0[c + 1] - c0[c]) // TILE)
        for t in range(nt):
            lo = c0[c] + t * TILE
            hi = min(c0[c + 1], lo + TILE)
            tile = before[lo:hi]
            order = np.argsort(tile >> sb, kind="stable")
            np.testing.assert_array_equal(got[lo:hi], tile[order])
            starts = np.concatenate([[0], np.cumsum(np.bincount(
                tile >> sb, minlength=spr))])
            at = (spr + 1) * tiles + np.arange(spr + 1) * nt + t
            np.testing.assert_array_equal(tab[at], starts)
        tiles += nt
    assert tiles <= -(-int(c0[-1]) // TILE) + nbins
    assert (tab[(spr + 1) * tiles:] == 0).all()
    np.testing.assert_array_equal(got[c0[-1]:], before[c0[-1]:])


@pytest.mark.parametrize("k", [27, 31])
def test_in_place_chain_matches_jax(k):
    """On numpy-seeded reads with 3% invalid bases (one all-T read: bit 31
    of its words), two chunks through the plain chain (histogram tables,
    their scan, level 1, level 2 in place, the apply through the table)
    equal commet_tpu's bulk build word for word; after level 2 each tile
    of the chunk is sorted by slice."""
    rng = np.random.default_rng(130 + k)
    n, lpad = 260, 72
    codes = rng.integers(0, 4, size=(n, lpad)).astype(np.uint8)
    codes[rng.random(size=codes.shape) < 0.03] = 4
    codes[0] = 3
    want = _jax_bulk(codes, (slice(0, 150), slice(150, n)), k)
    got = planes.alloc_planes(k, "cpu")
    chunks = [[_batch(codes[:70]), _batch(codes[70:150])],
              [_batch(codes[150:])]]
    sb, spr = planes.bulk_layout(k)[0], planes.bulk_bins(k)[1]
    for chunk in chunks:
        mid, table, counts, cstart = _two_level(chunk, k)
        fine, first, size = planes.bulk_runs(table, cstart, k)
        # the runs tile the chunk in buffer order, each of one slice
        assert torch.equal(first, torch.cumsum(size, 0) - size)
        slices = torch.repeat_interleave(fine % spr, size)
        assert torch.equal(mid[:int(cstart[-1])].to(torch.int64) >> sb,
                           slices)
        planes.bulk_apply(got, mid, table, counts, cstart, k)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    assert (want >= 1 << 31).any()


def test_in_place_edges():
    """Through the wrappers' plain versions, equal to the per-batch build:
    a batch skewed into plane D's last region (2% A: a coarse bin of many
    tiles) at k = 33, one read of exactly k bases (four one-entry tiles
    beside empty regions), reads shorter than k (an empty chunk: zero counts,
    zero table, planes untouched), k < 19 (one slice a plane) and k < 27
    (one region a plane)."""
    rng = np.random.default_rng(140)
    for k in (9, 18, 20, 26, 33):
        nbins, spr = planes.bulk_bins(k)
        short = _batch(encode(random_seqs(rng, 40, 1, k - 1, n_frac=0.0),
                              lpad=k + 8), True)
        mid, table, counts, cstart = _two_level([short], k)
        assert not counts.any() and not table.any() and int(cstart[-1]) == 0
        assert not planes.bulk_apply(planes.alloc_planes(k, "cpu"), mid,
                                     table, counts, cstart, k).any()
        one = _batch(rng.integers(0, 4, size=(1, k)).astype(np.uint8), True)
        mid, table, counts, cstart = _two_level([one], k)
        n = (cstart[1:] - cstart[:-1]).numpy()
        assert sorted(n[n > 0].tolist()) == [1, 1, 1, 1]  # one a plane
        assert int((n == 0).sum()) == nbins - 4  # empty regions
        lone = planes.alloc_planes(k, "cpu")
        planes.build_planes(lone, *one, k)
        assert torch.equal(planes.bulk_apply(planes.alloc_planes(k, "cpu"),
                                             mid, table, counts, cstart, k),
                           lone)
        skew = np.full((300, 320), 4, dtype=np.uint8)
        skew[:, :300] = rng.choice(4, (300, 300), p=[0.02, 0.33, 0.33, 0.32])
        full = [_batch(encode(random_seqs(rng, 200, 1, 300, n_frac=0.01),
                              lpad=320)), _batch(skew, True), one, short]
        want = planes.alloc_planes(k, "cpu")
        for bt in full:
            planes.build_planes(want, *bt, k)
        got = _wrappers_build(planes.alloc_planes(k, "cpu"), full, k)
        assert torch.equal(got, want)
        if k == 33:
            _mid, _table, counts, cstart = _two_level(full, k)
            n = cstart[1:] - cstart[:-1]
            assert int(n[-1]) > 2 * TILE
            # plane D's last region: its slices' counts sum to its entries
            assert int(counts[-spr:].sum()) == int(n[-1])


def test_apply_plain_reads_tile_runs():
    """bulk_apply_plain ORs each fine bin's runs through the table: on
    synthetic level-1 entries sorted in place at k = 21 it sets exactly
    the bits of the entries' keys (plane, region, entry) onto a set that
    holds bits already, and a fine bin whose count is 0 is not touched;
    with the table rows of one tile swapped it sets other bits."""
    k = 21
    rng = np.random.default_rng(150)
    nbins, spr = planes.bulk_bins(k)
    sb, _sw, ns, rb = planes.bulk_layout(k)
    mid, cstart, before = _synthetic_mid(rng, k)
    table = planes.bulk_table(mid, k)
    counts = torch.zeros(4 * ns, dtype=torch.int64)
    planes.bulk_refine(mid, table, counts, cstart, k)
    base = planes.alloc_planes(k, "cpu")
    base[::7] = 1 << 3
    got = planes.bulk_apply(base.clone(), mid, table, counts, cstart, k)
    c0 = cstart.numpy()
    cbin = np.repeat(np.arange(nbins), np.diff(c0))
    key = (cbin % (nbins // 4)).astype(np.int64) << rb | before[:c0[-1]]
    plane = cbin // (nbins // 4)
    want = base.numpy().view(np.uint32).copy()
    word = plane * planes.plane_words(k) + (key >> 5)
    np.bitwise_or.at(want, word, (1 << (key & 31)).astype(np.uint32))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    skip = int(torch.argmax(counts))
    zeroed = counts.clone()
    zeroed[skip] = 0
    got = planes.bulk_apply(base.clone(), mid, table, zeroed, cstart, k)
    fine = cbin * spr + (before[:c0[-1]] >> sb)
    keep = fine != skip
    want = base.numpy().view(np.uint32).copy()
    np.bitwise_or.at(want, word[keep],
                     (1 << (key[keep] & 31)).astype(np.uint32))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def test_workspace_counts_one_buffer_and_table():
    """bulk_workspace_bytes at k 15, 21, 27 and 33 and chunks of 2^26 and
    2^27 slots: the kept batches (upload, 16 B a window slot in the one
    entry buffer, 20 B a coarse bin a histogram block), level 2's table (2 B
    for each of spr + 1 slice starts of at most ceil(entries / BULK_TILE) +
    nbins tiles), the fine counts and the coarse bins' scans; the table a
    small share of the buffer."""
    slots, upload, rows = 65536 * 68, 65536 * 40, 65536
    for k in (15, 21, 27, 33):
        nbins, spr = planes.bulk_bins(k)
        ns = planes.bulk_layout(k)[2]
        for chunk in (1 << 26, 1 << 27):
            n_b = chunk // slots + 1
            entries = 4 * n_b * slots
            table = 2 * (spr + 1) * (-(-entries // TILE) + nbins)
            assert planes.bulk_workspace_bytes(k, chunk, slots, upload,
                                               rows) == (
                n_b * (16 * slots + upload + 20 * nbins * 256) + table
                + 8 * 4 * ns + 32 * (nbins + 1))
            assert table < 0.01 * 4 * entries
    mid = torch.empty(3 * TILE + 1, dtype=torch.int32)
    assert planes.bulk_table(mid, 33).numel() == 257 * (4 + 256)
    assert planes.bulk_table(mid, 33).dtype == torch.int16
