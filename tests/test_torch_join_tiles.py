"""The tile join's invariants, held on the CPU with the plain versions: the
bracket a block computes for its tile of queries (stream.join_tile_ranges)
holds every query's lower bound and whole equal-keya run; the plain join
restricted tile by tile to its bracket equals the plain join over the whole
index; the launch geometry (stream.join_launch_geometry) is consistent with
the kernel's limits in csrc/join.cu; and against commet_tpu's Pallas join in
interpret mode the JAX CONF and NONMEM verdicts hold as proofs. Verdicts and
positions are integers: exact equality throughout."""

import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from commet_tpu.core import stream as jstream
from commet_tpu_torch.core import _cuda
from commet_tpu_torch.core import stream as tstream
from torch_helpers import U32, index_pairs, query_pairs

TILE = 64  # small tiles, so that a few thousand queries make many


def _case(seed, k=32, n=6000, m=5000, run=500):
    """A lexsorted index with a long equal-keya run (several tiles of
    queries fall inside it) and queries of all three verdicts, m not a
    multiple of TILE."""
    rng = np.random.default_rng(seed)
    a, b = index_pairs(rng, k, n)
    key = int(a[7])
    a = np.concatenate([a, np.full(run, key, dtype=np.int64)])
    b = np.concatenate([b, 2 * np.arange(run, dtype=np.int64)])
    qa, qb = query_pairs(rng, k, a, b, m)
    qa[100:100 + 5 * TILE] = key  # tiles wholly inside the run
    qb[100:100 + 5 * TILE] = rng.integers(0, 2 * run, 5 * TILE)
    sidx = tstream.finalize_index([torch.from_numpy(a)],
                                  [torch.from_numpy(b)])
    return sidx, torch.from_numpy(qa), torch.from_numpy(qb)


def _per_query(ranges, m, tile):
    """Each query's tile bracket: (L, R) [m]."""
    t = torch.arange(m) // tile
    return ranges[t, 0], ranges[t, 1]


@pytest.mark.parametrize("order", ["sorted", "unsorted"])
def test_tile_ranges_hold_every_run(order):
    sidx, qa, qb = _case(11)
    assert qa.shape[0] % TILE != 0
    if order == "sorted":
        qa = torch.sort(qa).values
    r = tstream.join_tile_ranges(sidx.ika, sidx.mi, qa, TILE)
    assert r.shape == (-(-qa.shape[0] // TILE), 2)
    left, right = _per_query(r, qa.shape[0], TILE)
    lo = torch.searchsorted(sidx.ika, qa)
    hi = torch.searchsorted(sidx.ika, qa, right=True)
    assert bool(((left <= lo) & (lo <= right)).all())
    assert bool((hi <= right).all())  # the whole run, never cut
    assert int((hi - lo).max()) > 3 * TILE  # a run spanning tiles
    if order == "sorted":  # consecutive tiles' brackets do not overlap much
        assert bool((r[1:, 0] >= r[:-1, 0]).all())
        assert int((r[:, 1] - r[:, 0]).median()) < sidx.mi // 8
    else:
        assert int((r[:, 1] - r[:, 0]).median()) > sidx.mi // 2


@pytest.mark.parametrize("mi", [0, 1])
def test_tile_ranges_tiny_index(mi):
    sidx, qa, _qb = _case(12)
    qa = torch.sort(qa).values
    r = tstream.join_tile_ranges(sidx.ika, mi, qa, TILE)
    assert r.shape[0] == -(-qa.shape[0] // TILE)
    assert bool(((r >= 0) & (r <= mi)).all())
    if mi == 1:  # tiles on either side of, and holding, the only entry
        only = sidx.ika[0]
        below = qa.view(-1)[:r.shape[0] * TILE - TILE].view(-1, TILE)
        holds = (below.min(dim=1).values <= only) & (
            below.max(dim=1).values >= only)
        assert torch.equal(r[:-1, 1] - r[:-1, 0], holds.to(torch.int64))
    empty = tstream.join_tile_ranges(sidx.ika, sidx.mi, qa[:0], TILE)
    assert empty.shape == (0, 2)


def _join_by_tiles(sidx, qa, qb, tile):
    """join_membership_plain of each tile against its bracket alone."""
    r = tstream.join_tile_ranges(sidx.ika, sidx.mi, qa, tile)
    out = []
    for t, (left, right) in enumerate(r.tolist()):
        sl = slice(t * tile, (t + 1) * tile)
        out.append(tstream.join_membership_plain(
            sidx.ika[left:right], sidx.ikb[left:right], right - left,
            qa[sl], qb[sl]))
    return torch.cat(out)


def test_plain_join_tile_by_tile_equals_whole():
    sidx, qa, qb = _case(13)
    order = torch.argsort(qa)
    for x, y in ((qa, qb), (qa[order], qb[order])):
        want = tstream.join_membership_plain(sidx.ika, sidx.ikb, sidx.mi, x,
                                             y)
        assert set(torch.unique(want).tolist()) == {
            tstream.NONMEM, tstream.CAND, tstream.CONF}
        for tile in (TILE, 1000, tstream.JOIN_TILE):
            assert torch.equal(_join_by_tiles(sidx, x, y, tile), want)


def test_join_by_tiles_holds_jax_proofs():
    """commet_tpu's join_membership (Pallas, interpret mode) on the same
    pairs: its CONF and NONMEM are proofs and equal the tile-by-tile plain
    join's; its CAND may be CAND or CONF here (the pair past its window's
    edge), and its RESIDUAL (not bracketed by its window) is undecided."""
    k = 32
    rng = np.random.default_rng(14)
    a, b = index_pairs(rng, k, 2500)
    qa, qb = query_pairs(rng, k, a, b, 3000)
    lo = lambda x: jnp.asarray((x & U32).astype(np.uint32))  # noqa: E731
    ika, ikb, _hib, mi = jstream.finalize_index_keys(
        [lo(a)], [lo(b)], None, [jnp.zeros(len(a), jnp.uint32)], [len(a)],
        ki=2, wide=False)
    order = np.argsort(qa, kind="stable")
    chunk = 512
    pad = np.full(-len(qa) % chunk, U32, dtype=np.int64)
    sqa, sqb = (np.concatenate([q[order], pad]) for q in (qa, qb))
    want = np.asarray(jstream.join_membership(
        ika, ikb, mi, lo(sqa), lo(sqb), chunk=chunk, ki=2,
        interpret=True))[:len(qa)]
    sidx = tstream.finalize_index([torch.from_numpy(a)],
                                  [torch.from_numpy(b)])
    got = _join_by_tiles(sidx, torch.from_numpy(qa[order]),
                         torch.from_numpy(qb[order]), TILE).numpy()
    for verdict in (jstream.CONF, jstream.NONMEM):
        sel = want == verdict
        assert sel.any()
        assert (got[sel] == verdict).all()
    cand = want == jstream.CAND
    assert cand.any()
    assert np.isin(got[cand], (tstream.CAND, tstream.CONF)).all()


def test_launch_geometry_follows_density():
    tile_max, cap = tstream.JOIN_TILE, tstream.JOIN_CAPACITY
    m = 65536 * 2 * 69  # one batch of 100 bp reads at k = 32
    assert tstream.join_launch_geometry(64 << 20, m) == (tile_max, cap)
    assert tstream.join_launch_geometry(128 << 20, m) == (tile_max, 0)
    shortened = 0
    for mi in [0, 1, 1000] + [n << 20 for n in range(8, 300, 4)]:
        tile, c = tstream.join_launch_geometry(mi, m)
        assert 1 <= tile <= tile_max and c in (0, cap)
        if c:  # the tile's span fits, and no longer tile's would
            assert tile % tstream.JOIN_TILE_STEP == 0
            assert tile >= tstream.JOIN_TILE_MIN
            assert tile * mi <= 0.94 * cap * m
            bigger = tile + tstream.JOIN_TILE_STEP
            assert tile == tile_max or bigger * mi > 0.94 * cap * m
            shortened += tile < tile_max
        else:
            assert tile == tile_max
            assert tstream.JOIN_TILE_MIN * mi > 0.94 * cap * m
    assert shortened > 0
    # denser indexes never stage where sparser ones do not
    caps = [tstream.join_launch_geometry(n << 20, m)[1]
            for n in range(8, 300, 4)]
    assert caps == sorted(caps, reverse=True)
    assert tstream.join_launch_geometry(0, 0)[0] >= 1


def test_tiles_staged_and_kernel_limits():
    """join_tiles_staged against the geometry, and the module's limits
    against the constants of csrc/join.cu."""
    sidx, qa, qb = _case(15, n=40_000, m=9000, run=9000)
    qa = torch.sort(qa).values
    geometry = tstream.join_launch_geometry(sidx.mi, qa.shape[0])
    assert geometry[1] == tstream.JOIN_CAPACITY
    staged = tstream.join_tiles_staged(sidx.ika, sidx.mi, qa)
    r = tstream.join_tile_ranges(sidx.ika, sidx.mi, qa, geometry[0])
    assert torch.equal(staged, r[:, 1] - r[:, 0] < geometry[1])
    assert bool(staged.any()) and not bool(staged.all())  # the long run
    none = tstream.join_tiles_staged(sidx.ika, sidx.mi, qa,
                                     (tstream.JOIN_TILE, 0))
    assert not bool(none.any())
    with open(os.path.join(_cuda.CSRC, "join.cu")) as f:
        src = f.read()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    assert const("kThreads") * const("kPer") == tstream.JOIN_TILE
    assert const("kCap") == tstream.JOIN_CAPACITY
    assert tstream.JOIN_TILE_STEP == 32  # a warp's queries
    slots = tstream.JoinSlots([sidx.ika] * 4, [sidx.ikb] * 4,
                              [5, sidx.mi, 0, 70])
    assert slots.typical_mi == 70
