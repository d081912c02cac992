"""The word-sharded plane kernels' plain versions (core/planes.py) on meshes
of CPU shards: the ranged probe's two passes (probe_planes_part_a, then
probe_planes_part given the merged A words) and the ranged build
(build_planes_range), against commet_tpu's build_search_step
on its virtual CPU devices (tests/conftest.py: build_fn planes, search_fn
tags), against the port's single-set build_planes_plain /
probe_planes_plain, and on a window whose four plane words lie on four
different shards. Clean and dirty batches with ragged lengths and reads
shorter than k; k in {15, 18} over 2 and 4 ranges. Exact equality
throughout."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from commet_tpu.core import kernels
from commet_tpu.parallel import sharded as jsharded
from commet_tpu_torch.core import keys, planes
from commet_tpu_torch.parallel import sharded

T = 2


def _need_devices(n):
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} virtual devices")


def _reads(seed, k, n=64, lpad=96):
    """Index and query codes [n, lpad] (4 = N or past the read's end):
    ragged lengths, an eighth of them shorter than k, 3% Ns in the dirty
    copies; half the queries carry a 2k fragment of an index read. Returns
    {"clean": (idx, qry), "dirty": (idx, qry)}."""
    rng = np.random.default_rng(seed)
    out = {}
    base_i = rng.integers(0, 4, size=(n, lpad)).astype(np.int32)
    base_q = rng.integers(0, 4, size=(n, lpad)).astype(np.int32)
    base_q[: n // 2, 20: 20 + 2 * k] = base_i[: n // 2, 8: 8 + 2 * k]
    for name in ("clean", "dirty"):
        pair = []
        for codes in (base_i.copy(), base_q.copy()):
            lens = rng.integers(20 + 2 * k, lpad + 1, size=n)
            short = rng.choice(n, n // 8, replace=False)
            lens[short] = rng.integers(1, k, size=len(short))
            codes[np.arange(lpad)[None, :] >= lens[:, None]] = 4
            if name == "dirty":
                codes[rng.random(codes.shape) < 0.03] = 4
            pair.append(codes)
        out[name] = tuple(pair)
    return out


def _batch(codes, clean):
    """The port's wire format of [n, L] codes: (codes2, aux, clean, L),
    aux the lengths (clean: every base before the first 4 is valid) or the
    validity words."""
    c2, vd = kernels.pack_codes_np(codes.astype(np.uint8))
    if clean:
        lens = (codes < 4).sum(axis=1).astype(np.int32)
        return (keys.host_u32(c2), torch.from_numpy(lens), True,
                codes.shape[1])
    return keys.host_u32(c2), keys.host_u32(vd), False, codes.shape[1]


def _jax_step(n, k, idx, qry):
    """commet_tpu's build_search_step over n devices: (planes [4, W]
    uint32 as numpy, tags)."""
    jmesh = jsharded.make_mesh(n)
    build_fn, search_fn = jsharded.build_search_step(jmesh, k, T)
    jplanes = build_fn(jsharded.alloc_planes_sharded(k, jmesh),
                       jnp.asarray(idx))
    return np.asarray(jplanes), np.asarray(search_fn(jplanes,
                                                     jnp.asarray(qry)))


def _passes(ps, batch, wmax):
    """Per shard the plain passes, merged as probe_planes_sharded merges
    them: (A words, vetoes)."""
    ahit = None
    for d, shard in enumerate(ps.shards):
        a = planes.probe_planes_part_a_plain(shard, *batch, ps.k, d * ps.wl,
                                             ps.wl, wmax)
        ahit = a if ahit is None else ahit | a
    veto = None
    for d, shard in enumerate(ps.shards):
        v = planes.probe_planes_part_plain(shard, *batch, ps.k, d * ps.wl,
                                           ps.wl, wmax, ahit)
        veto = v if veto is None else veto | v
    return ahit, veto


def _build_ranges(ps, batch):
    for d, shard in enumerate(ps.shards):
        planes.build_planes_range(shard, *batch, ps.k, d * ps.wl, ps.wl)


@pytest.mark.parametrize("k,n", [(15, 2), (15, 4), (18, 2), (18, 4)])
def test_two_pass_probe_matches_jax(k, n):
    """Over n ranges, clean and dirty: the shards (built by the plain
    ranged build) reassemble to commet_tpu's build_fn planes and to the
    single-set build; the two-pass membership (A & ~vetoes) is exactly the
    single-set membership, and no window without A is vetoed;
    probe_planes_sharded's tags equal commet_tpu's search_fn and
    probe_planes_plain's."""
    _need_devices(n)
    mesh = sharded.Mesh(["cpu"] * n)
    for name, (idx, qry) in _reads(10 * k + n, k).items():
        jplanes, jtags = _jax_step(n, k, idx, qry)
        ps = sharded.alloc_planes_sharded(k, mesh)
        _build_ranges(ps, _batch(idx, name == "clean"))
        np.testing.assert_array_equal(ps.assembled().numpy().view(np.uint32),
                                      jplanes.reshape(-1))
        single = planes.alloc_planes(k, "cpu")
        planes.build_planes_plain(single, *_batch(idx, name == "clean"), k)
        assert torch.equal(ps.assembled(), single)

        batch = _batch(qry, name == "clean")
        wmax = batch[3] - k + 1
        ahit, veto = _passes(ps, batch, wmax)
        assert not bool((veto & ~ahit).any())  # no veto without A
        member = planes.unpack_window_bits(ahit & ~veto, wmax)
        wk = keys.window_keys(planes._unpack(batch[0], batch[1], batch[2],
                                             batch[3]), k, "both", wmax)
        for s, strand in enumerate(("f", "r")):
            a = torch.where(wk["ok"], wk[strand + "a"], 0)
            b = torch.where(wk["ok"], wk[strand + "b"], 0)
            want = planes._plane_member(single, a, b, k) & wk["ok"]
            assert torch.equal(member[:, s], want)
        tags = sharded.probe_planes_sharded(ps, *batch, T)
        np.testing.assert_array_equal(tags.numpy(), jtags)
        assert torch.equal(tags, planes.probe_planes_plain(single, *batch,
                                                           k, T))
        assert int(tags.sum()) > 0


@pytest.mark.parametrize("k", [15, 18])
def test_ranged_build_matches_jax(k):
    """build_planes_range's plain version over 4 ranges of a dirty batch
    with ragged lengths and reads shorter than k: each range is its words
    of the single-set build, and the shards reassemble to commet_tpu's
    build_fn planes; a second build of the same batch changes nothing (bits
    already set), nor does a batch of reads all shorter than k."""
    n = 4
    _need_devices(n)
    idx, _qry = _reads(7 * k, k)["dirty"]
    batch = _batch(idx, False)
    jplanes, _jtags = _jax_step(n, k, idx, idx)
    ps = sharded.alloc_planes_sharded(k, sharded.Mesh(["cpu"] * n))
    wl = ps.wl
    single = planes.alloc_planes(k, "cpu")
    planes.build_planes_plain(single, *batch, k)
    _build_ranges(ps, batch)
    for d, shard in enumerate(ps.shards):
        assert torch.equal(shard.view(4, wl),
                           single.view(4, -1)[:, d * wl:(d + 1) * wl])
        assert int(shard.ne(0).sum()) > 0
    np.testing.assert_array_equal(ps.assembled().numpy().view(np.uint32),
                                  jplanes.reshape(-1))
    before = [x.clone() for x in ps.shards]
    _build_ranges(ps, batch)
    short = idx.copy()
    short[:, k - 1:] = 4
    _build_ranges(ps, _batch(short, False))
    assert all(torch.equal(x, y) for x, y in zip(ps.shards, before))


def test_window_on_four_shards():
    """k = 15 over 8 ranges: a read starting CGT has its first window's
    A, B, C, D words on shards 3, 5, 6 and 7 (a key's shard is its top 3
    bits: keya 011, keyb 101, xor 110, or 111). Only shard 3's pass A sees
    the A hit, no shard vetoes it; the window is a member and commet_tpu's
    search_fn agrees. With its D bit cleared on shard 7,
    only shard 7 vetoes it, and the tags follow the single-set probe."""
    k, n = 15, 8
    _need_devices(n)
    rng = np.random.default_rng(3)
    read = np.concatenate([[1, 2, 3], rng.integers(0, 4, 2 * k - 3)])
    idx = rng.integers(0, 4, (8, 2 * k)).astype(np.int32)
    idx[0] = read
    qry = idx.copy()
    jplanes, jtags = _jax_step(n, k, idx, qry)
    ps = sharded.alloc_planes_sharded(k, sharded.Mesh(["cpu"] * n))
    ibatch, qbatch = _batch(idx, True), _batch(qry, True)
    _build_ranges(ps, ibatch)
    np.testing.assert_array_equal(ps.assembled().numpy().view(np.uint32),
                                  jplanes.reshape(-1))
    wk = keys.window_keys(planes._unpack(*qbatch), k, "fwd", k + 1)
    fa, fb = int(wk["fa"][0, 0]), int(wk["fb"][0, 0])
    words = [key >> 5 for key in (fa, fb, fa ^ fb, fa | fb)]
    assert [w // ps.wl for w in words] == [3, 5, 6, 7]
    wmax = k + 1
    for d, shard in enumerate(ps.shards):
        a = planes.probe_planes_part_a_plain(shard, *qbatch, k, d * ps.wl,
                                             ps.wl, wmax)
        assert bool(a[0, 0, 0] & 1) == (d == 3)
    ahit, veto = _passes(ps, qbatch, wmax)
    assert bool(ahit[0, 0, 0] & 1) and not bool(veto[0, 0, 0] & 1)
    tags = sharded.probe_planes_sharded(ps, *qbatch, T)
    np.testing.assert_array_equal(tags.numpy(), jtags)
    assert bool(tags[0])

    d_word = words[3] - 7 * ps.wl + 3 * ps.wl
    d_bit = planes._bit_value(torch.tensor([(fa | fb) & 31]))[0]
    ps.shards[7][d_word] &= ~d_bit
    for d, shard in enumerate(ps.shards):
        v = planes.probe_planes_part_plain(shard, *qbatch, k, d * ps.wl,
                                           ps.wl, wmax, ahit)
        assert bool(v[0, 0, 0] & 1) == (d == 7)
    ahit2, veto2 = _passes(ps, qbatch, wmax)
    assert torch.equal(ahit2, ahit) and bool(veto2[0, 0, 0] & 1)
    whole = ps.assembled()
    assert torch.equal(sharded.probe_planes_sharded(ps, *qbatch, T),
                       planes.probe_planes_plain(whole, *qbatch, k, T))


def test_packed_window_words_edges():
    """wmax not a multiple of 32 and above it: pass A's and the vetoes'
    tail bits stay 0; pack and unpack are inverse over the int32 sign bit;
    the wrappers OR into ``out`` and check its shape and ``ahit``'s; an
    empty batch gives zero words."""
    k = 15
    bits = torch.zeros((3, 2, 70), dtype=torch.bool)
    bits[0, 0, [0, 31, 32, 63, 69]] = True
    bits[2, 1, 31] = True
    words = planes.pack_window_bits(bits)
    assert words.shape == (3, 2, 3) and words.dtype == torch.int32
    assert int(words[0, 0, 0]) == 1 - (1 << 31) and int(words[2, 1, 0]) < 0
    assert torch.equal(planes.unpack_window_bits(words, 70), bits)

    rng = np.random.default_rng(5)
    codes = rng.integers(0, 4, (16, 100)).astype(np.int32)
    codes[3, 10:] = 4
    batch = _batch(codes, False)
    ps = sharded.alloc_planes_sharded(k, sharded.Mesh(["cpu"] * 2))
    _build_ranges(ps, batch)
    for wmax in (70, 86):
        nw = planes.window_words(wmax)
        tail = torch.arange(nw * 32) >= wmax
        ahit, veto = _passes(ps, batch, wmax)
        for got in (ahit, veto):
            flat = planes.unpack_window_bits(got, nw * 32)
            assert not bool(flat[..., tail].any())
        assert not bool(planes.unpack_window_bits(ahit, wmax)[3].any())
        out = torch.zeros_like(ahit)
        for d, shard in enumerate(ps.shards):
            got = planes.probe_planes_part_a(shard, *batch, k, d * ps.wl,
                                             ps.wl, wmax, out)
            assert got is out
        assert torch.equal(out, ahit)
    with pytest.raises(ValueError, match="out"):
        planes.probe_planes_part(ps.shards[0], *batch, k, 0, ps.wl, 70, ahit,
                                 torch.zeros((16, 2, 2), dtype=torch.int32))
    with pytest.raises(ValueError, match="ahit"):
        planes.probe_planes_part(ps.shards[0], *batch, k, 0, ps.wl, 70,
                                 ahit[:, :, :2])
    empty = planes.probe_planes_part_a(ps.shards[0], batch[0][:0],
                                       batch[1][:0], False, 100, k, 0, ps.wl)
    assert empty.shape == (0, 2, planes.window_words(86))


def test_one_word_ranges():
    """k = 7 cut into ranges of one word (lo = 0 .. 3, wl = 1), where every
    key's word lies below or above most ranges (the unsigned wrap of
    key >> 5 - lo): each range's build is its word of the single-set
    build, and pass A and the vetoes merged over the ranges give exactly
    the single-set membership on a dirty batch."""
    k = 7
    rng = np.random.default_rng(8)
    codes = rng.integers(0, 4, (32, 40)).astype(np.int32)
    codes[rng.random(codes.shape) < 0.05] = 4
    batch = _batch(codes, False)
    single = planes.alloc_planes(k, "cpu")
    planes.build_planes_plain(single, *batch, k)
    pw = planes.plane_words(k)
    shards = []
    for lo in range(pw):
        shard = torch.zeros(4, dtype=torch.int32)
        planes.build_planes_range(shard, *batch, k, lo, 1)
        assert torch.equal(shard, single.view(4, pw)[:, lo])
        shards.append(shard)
    wmax = batch[3] - k + 1
    ahit = veto = 0
    for lo, shard in enumerate(shards):
        ahit = ahit | planes.probe_planes_part_a_plain(shard, *batch, k, lo,
                                                       1, wmax)
    for lo, shard in enumerate(shards):
        veto = veto | planes.probe_planes_part_plain(shard, *batch, k, lo, 1,
                                                     wmax, ahit)
    member = planes.unpack_window_bits(ahit & ~veto, wmax)
    wk = keys.window_keys(planes._unpack(*batch), k, "both", wmax)
    for s, strand in enumerate(("f", "r")):
        a = torch.where(wk["ok"], wk[strand + "a"], 0)
        b = torch.where(wk["ok"], wk[strand + "b"], 0)
        want = planes._plane_member(single, a, b, k) & wk["ok"]
        assert torch.equal(member[:, s], want)
        assert bool(want.any()) and not bool(want.all())
