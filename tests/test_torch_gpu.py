"""Card-only tests of the PyTorch port: the hand-written CUDA join kernels
(single-index and grouped) and plane kernels (build, probe, grouped probe)
against their plain PyTorch versions, and the engine on the card against the
engine on the CPU. Each skips without a CUDA card. The file imports no JAX,
so on a machine without JAX it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_gpu.py
"""

import os

import numpy as np
import pytest
import torch

from commet_tpu_torch.core import keys
from commet_tpu_torch.core import planes as tplanes
from commet_tpu_torch.core import stream as tstream
from commet_tpu_torch.engine import engine as tengine
from commet_tpu_torch.io.reads import ReadSet
from torch_helpers import (encode, implant, index_pairs, long_seq,
                           make_fastas, query_pairs, random_seqs, run_engine)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _misaligned(x):
    """A copy of the 1-D tensor x that starts 8 bytes off a 16-byte
    boundary."""
    buf = torch.empty(x.numel() + 2, dtype=x.dtype, device=x.device)
    out = buf[1 if buf.data_ptr() % 16 == 0 else 2:][:x.numel()]
    out.copy_(x)
    assert out.data_ptr() % 16 == 8 and out.is_contiguous()
    return out


def _long_run_case(rng, k, device, run):
    """An index with one equal-keya run of ``run`` entries (even keyb) and
    three full tiles of sorted queries: below the run, inside it (even keyb
    CONF, odd CAND) and above it."""
    tile = tstream.JOIN_TILE
    top = 1 << k
    key = top // 2
    other = rng.integers(0, top, 4000, dtype=np.int64)
    other[other == key] += 1
    a = np.concatenate([other, np.full(run, key, dtype=np.int64)])
    b = np.concatenate([rng.integers(0, 8, 4000, dtype=np.int64),
                        2 * np.arange(run, dtype=np.int64)])
    qa = np.concatenate([np.sort(rng.integers(0, key, tile - 100)),
                         np.full(tile + 200, key),
                         np.sort(rng.integers(key + 1, top, tile - 100))])
    qb = rng.integers(0, 2 * run, len(qa))
    sidx = tstream.finalize_index([torch.from_numpy(a).to(device)],
                                  [torch.from_numpy(b).to(device)])
    inside = torch.from_numpy(qa == key).to(device)
    want = torch.from_numpy(np.where(qb % 2 == 0, tstream.CONF,
                                     tstream.CAND)).to(device)[inside]
    return (sidx, torch.from_numpy(qa).to(device),
            torch.from_numpy(qb).to(device), inside, want.to(torch.int8))


@pytest.mark.gpu
@pytest.mark.parametrize("k", [15, 32, 33])
def test_join_kernel_matches_plain_on_card(cuda_device, k):
    """The kernel (csrc/join.cu) against join_membership_plain on the card:
    sorted and unsorted queries, the full index, a prefix and an empty one,
    long equal-keya runs; m around the tile size, columns 8 bytes off a
    16-byte boundary, an equal-keya run longer than the staging capacity
    (searched in device memory) and a shorter one (staged). Verdicts are
    integers: exact equality."""
    rng = np.random.default_rng(80 + k)
    a, b = index_pairs(rng, k, 200_000)
    qa, qb = query_pairs(rng, k, a, b, 300_000)
    sidx = tstream.finalize_index([torch.from_numpy(a).to(cuda_device)],
                                  [torch.from_numpy(b).to(cuda_device)])
    qa_t = torch.from_numpy(qa).to(cuda_device)
    qb_t = torch.from_numpy(qb).to(cuda_device)
    order = torch.argsort(qa_t)
    for mi in (sidx.mi, sidx.mi // 3, 0):
        for x, y in ((qa_t, qb_t), (qa_t[order], qb_t[order])):
            before = tstream.join_membership.launches
            got = tstream.join_membership(sidx.ika, sidx.ikb, mi, x, y)
            torch.cuda.synchronize()
            assert tstream.join_membership.launches == before + 1
            want = tstream.join_membership_plain(sidx.ika, sidx.ikb, mi, x, y)
            assert torch.equal(got, want)
    tile, cap = tstream.JOIN_TILE, tstream.JOIN_CAPACITY
    sa, sb = qa_t[order], qb_t[order]
    for m in (1, tile - 1, tile, tile + 1, 3 * tile + 5):
        for x, y in ((sa[:m], sb[:m]), (sa[-m:], sb[-m:])):
            got = tstream.join_membership(sidx.ika, sidx.ikb, sidx.mi, x, y)
            assert torch.equal(got, tstream.join_membership_plain(
                sidx.ika, sidx.ikb, sidx.mi, x, y))
    cols = [sidx.ika, sidx.ikb, sa, sb]
    want = tstream.join_membership_plain(sidx.ika, sidx.ikb, sidx.mi, sa, sb)
    for which in ((0,), (1,), (2,), (3,), (0, 1, 2, 3)):
        ika, ikb, x, y = (_misaligned(c) if i in which else c
                          for i, c in enumerate(cols))
        assert torch.equal(
            tstream.join_membership(ika, ikb, sidx.mi, x, y), want)
        assert torch.equal(
            tstream.join_membership(ika, ikb, sidx.mi - 1, x, y),
            tstream.join_membership_plain(ika, ikb, sidx.mi - 1, x, y))
    for run in (cap + 3000, 3000):
        rsidx, x, y, inside, verdicts = _long_run_case(rng, k, cuda_device,
                                                       run)
        staged = tstream.join_tiles_staged(rsidx.ika, rsidx.mi, x)
        assert staged.tolist() == [run < cap] * 3
        got = tstream.join_membership(rsidx.ika, rsidx.ikb, rsidx.mi, x, y)
        assert torch.equal(got, tstream.join_membership_plain(
            rsidx.ika, rsidx.ikb, rsidx.mi, x, y))
        assert torch.equal(got[inside], verdicts)


@pytest.mark.gpu
def test_join_kernel_rejects_bad_inputs(cuda_device):
    x = torch.zeros(8, dtype=torch.int64, device=cuda_device)
    wide = torch.zeros(16, dtype=torch.int64, device=cuda_device)
    with pytest.raises(ValueError):  # a strided column: the kernel copies
        tstream.join_membership(wide[::2], x, 8, x, x)  # 16 bytes at a time
    with pytest.raises(ValueError):
        tstream.join_membership(x, x, 8, wide[::2], x)
    with pytest.raises(ValueError):
        tstream.join_membership(x, x, 8, x, x[:4])  # qa and qb differ
    with pytest.raises(ValueError):
        tstream.join_membership(x, x, 9, x, x)  # mi past the index
    with pytest.raises(ValueError):
        tstream.join_membership(x.to(torch.int32), x, 8, x, x)
    with pytest.raises(ValueError):
        tstream.join_membership(x, x, 8, x.cpu(), x)


@pytest.mark.gpu
def test_engine_cuda_matches_cpu(tmp_path, monkeypatch, cuda_device):
    """The same sets through Engine(device="cuda") (join kernel, pinned
    non-blocking uploads, several prefetched batches) and
    Engine(device="cpu") (plain version): identical bytes and counters."""
    idx_fa, qry_fas, _ = make_fastas(tmp_path, 909, 21, 0.02, n_queries=2)
    monkeypatch.setattr(tengine, "STREAM_BATCH", 64)
    monkeypatch.setenv("COMMET_TPU_STREAM", "force")
    before = tstream.join_membership.launches
    _c, got = run_engine(tengine.Engine(k=21, t=2, device=cuda_device),
                         idx_fa, qry_fas, str(tmp_path / "cuda"))
    assert tstream.join_membership.launches > before
    _c, want = run_engine(tengine.Engine(k=21, t=2, device="cpu"), idx_fa,
                          qry_fas, str(tmp_path / "cpu"))
    assert got == want


@pytest.mark.gpu
def test_join_multi_kernel_matches_plain_on_card(cuda_device):
    """The grouped kernel (commet_join_multi) against
    join_membership_multi_plain: slots of different sizes and mi, an empty
    prefix (mi = 0), the all-G/T key at k = 32, sorted and unsorted
    queries; then S = 33 slots (a misaligned column and an index with an
    equal-keya run longer than the staging capacity among them) at query
    counts from one slot a block to all 33. Exact equality."""
    k = 32
    rng = np.random.default_rng(90)
    idx = [index_pairs(rng, k, n) for n in (150_000, 40_000, 90_000)]
    top = (1 << k) - 1
    idx[0][0][0], idx[0][1][0] = top, top  # the all-G/T pair
    cols = [tstream.finalize_index([torch.from_numpy(a).to(cuda_device)],
                                   [torch.from_numpy(b).to(cuda_device)])
            for a, b in idx]
    qa, qb = query_pairs(rng, k, *idx[0], 200_000)
    half = len(qa) // 2
    qa[half:], qb[half:] = query_pairs(rng, k, *idx[1], len(qa) - half)
    qa[0], qb[0] = top, top
    qa_t = torch.from_numpy(qa).to(cuda_device)
    qb_t = torch.from_numpy(qb).to(cuda_device)
    order = torch.argsort(qa_t)
    mis = [cols[0].mi, 0, cols[2].mi // 3, cols[1].mi]
    picks = [cols[0], cols[1], cols[2], cols[1]]
    slots = tstream.JoinSlots([c.ika for c in picks], [c.ikb for c in picks],
                              mis)
    for x, y in ((qa_t, qb_t), (qa_t[order], qb_t[order])):
        before = tstream.join_membership_multi.launches
        got = tstream.join_membership_multi(slots, x, y)
        torch.cuda.synchronize()
        assert tstream.join_membership_multi.launches == before + 1
        want = tstream.join_membership_multi_plain(
            slots.ikas, slots.ikbs, slots.mis, x, y)
        assert got.shape == (4, len(qa))
        assert torch.equal(got, want)
        assert int(got[1].max()) == tstream.NONMEM
        gt = (x == top) & (y == top)
        assert int(gt.sum()) >= 1
        assert (got[0][gt] == tstream.CONF).all()
        for s in (0, 3):
            assert set(torch.unique(got[s]).tolist()) == {
                tstream.NONMEM, tstream.CAND, tstream.CONF}
    tile, cap = tstream.JOIN_TILE, tstream.JOIN_CAPACITY
    rsidx, _x, _y, _inside, _v = _long_run_case(rng, k, cuda_device,
                                                cap + 3000)
    cycle = [(cols[0].ika, cols[0].ikb, cols[0].mi),
             (cols[1].ika, cols[1].ikb, 0),
             (_misaligned(cols[2].ika), cols[2].ikb, cols[2].mi - 1),
             (rsidx.ika, rsidx.ikb, rsidx.mi),
             (cols[1].ika, _misaligned(cols[1].ikb), 7)]
    picks = [cycle[j % len(cycle)] for j in range(33)]
    slots = tstream.JoinSlots(*zip(*picks))
    sa, sb = qa_t[order], qb_t[order]
    reps = -(-400 * tile // len(qa))
    long_a, perm = torch.sort(sa.repeat(reps))
    long_b = sb.repeat(reps)[perm]
    for m in (1, tile + 1, 3 * tile + 5, len(long_a)):
        x, y = long_a[:m], long_b[:m]
        got = tstream.join_membership_multi(slots, x, y)
        torch.cuda.synchronize()
        assert torch.equal(got, tstream.join_membership_multi_plain(
            slots.ikas, slots.ikbs, slots.mis, x, y))


@pytest.mark.gpu
def test_join_multi_rejects_bad_inputs(cuda_device):
    x = torch.zeros(8, dtype=torch.int64, device=cuda_device)
    with pytest.raises(ValueError):  # mismatched S
        tstream.JoinSlots([x, x], [x], [8, 8])
    with pytest.raises(ValueError):
        tstream.JoinSlots([x], [x], [9])  # mi past the index
    with pytest.raises(ValueError):
        tstream.JoinSlots([x, x.to(torch.int32)], [x, x], [8, 8])
    with pytest.raises(ValueError):
        tstream.JoinSlots([x, x.cpu()], [x, x], [8, 8])
    slots = tstream.JoinSlots([x], [x], [8])
    with pytest.raises(ValueError):
        tstream.join_membership_multi(slots, x.cpu(), x.cpu())
    with pytest.raises(ValueError):
        tstream.join_membership_multi(slots, x.to(torch.int32), x)
    with pytest.raises(ValueError):
        tstream.join_membership_multi(slots, x, x[:4])


@pytest.mark.gpu
def test_search_multi_set_cuda_matches_cpu(tmp_path, monkeypatch,
                                           cuda_device):
    """search_multi_set on the card (grouped kernel, several batches, two
    slot groups) and on the CPU: identical bytes, log lines and counters."""
    paths, qrys = [], []
    for s in range(3):
        (tmp_path / f"s{s}").mkdir()
        idx_fa, qry_fas, _ = make_fastas(tmp_path / f"s{s}", 500 + s, 21,
                                         0.02)
        paths.append(idx_fa)
        qrys += qry_fas
    qry = qrys[0]  # holds fragments of I0
    monkeypatch.setattr(tengine, "STREAM_BATCH", 64)
    monkeypatch.setenv("COMMET_TPU_STREAM", "force")
    got = {}
    for dev in (cuda_device, "cpu"):
        eng = tengine.Engine(k=21, t=2, device=dev, max_kmer=2000)
        res = []
        for s, p in enumerate(paths):
            rs = ReadSet(f"I{s}")
            rs.add_file(p)
            res.append(eng.build_resident(rs))
        assert sum(len(r.partitions) for r in res) > 3
        out = str(tmp_path / str(dev))
        os.makedirs(out)
        q = ReadSet("Q")
        q.add_file(qry)
        before = tstream.join_membership_multi.launches
        c = eng.search_multi_set(q, res, out_dir=out, log_dir=out,
                                 max_slots=3)
        if dev != "cpu":
            assert tstream.join_membership_multi.launches > before + 2
        blobs = {}
        for name in sorted(os.listdir(out)):
            with open(os.path.join(out, name), "rb") as f:
                data = f.read()
            blobs[name] = data.splitlines()[-1] if name.endswith(".log") \
                else data
        got[str(dev)] = ({n: {f: v[f] for f in ("indexed", "searched",
                                                "shared")}
                          for n, v in c.items()}, blobs)
    assert got[str(cuda_device)] == got["cpu"]
    assert got["cpu"][0]["I0"]["shared"] > 0


def _pack(codes, clean):
    """[n, L] uint8 codes -> (codes2, aux) int32 tensors: aux the lengths
    (clean) or the validity words; packed as the native packer does."""
    n, length = codes.shape
    w16, w32 = -(-length // 16), -(-length // 32)
    c = np.zeros((n, w16 * 16), dtype=np.uint64)
    c[:, :length] = np.where(codes < 4, codes, 0)
    c2 = (c.reshape(n, w16, 16) << (2 * np.arange(16, dtype=np.uint64))
          ).sum(axis=2).astype(np.uint32)
    if clean:
        return (keys.host_u32(c2),
                torch.from_numpy((codes < 4).sum(axis=1).astype(np.int32)))
    v = np.zeros((n, w32 * 32), dtype=np.uint64)
    v[:, :length] = codes < 4
    vd = (v.reshape(n, w32, 32) << np.arange(32, dtype=np.uint64)).sum(
        axis=2).astype(np.uint32)
    return keys.host_u32(c2), keys.host_u32(vd)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [15, 21, 31, 33])
def test_plane_kernels_match_plain_on_card(cuda_device, k):
    """commet_build_planes, commet_probe_planes and
    commet_probe_planes_multi against their plain versions on the card:
    dirty and clean batches, reads shorter than k, 300 bp reads (up to nine
    32-window chunks a strand), an all-T read, t in {1, 2, 17}, reads
    holding 2k and 18k fragments, the grouped probe at S in {1, 3, 32}
    against its plain version and S = 3 against single probes. Exact
    equality."""
    rng = np.random.default_rng(300 + k)
    idx = [long_seq(rng, 700)] + random_seqs(rng, 3000, 40, 120,
                                             n_frac=0.01)
    idx += random_seqs(rng, 300, 1, k - 1, n_frac=0.01)
    idx += random_seqs(rng, 600, 300, 300, n_frac=0.01)
    idx.append(b"T" * 90)
    order = rng.permutation(len(idx) - 1) + 1
    idx = [idx[0]] + [idx[i] for i in order]
    dirty = encode(idx[:1900])
    clean = encode([s for s in idx[1900:] if b"N" not in s.upper()])
    qry = random_seqs(rng, 2000, 20, 150, n_frac=0.01)
    qry += random_seqs(rng, 200, 1, k - 1, n_frac=0.01)
    qry += random_seqs(rng, 600, 300, 300, n_frac=0.01)
    implant(rng, idx[1:], qry, k, span=2)
    q = bytearray(long_seq(rng, 700))
    q[100:100 + 18 * k] = idx[0][50:50 + 18 * k]
    qry.append(bytes(q))
    sets = []
    for batches in ([(dirty, False), (clean, True)], [(clean, True)]):
        got = tplanes.alloc_planes(k, cuda_device)
        want = tplanes.alloc_planes(k, cuda_device)
        for codes, is_clean in batches:
            c2, aux = (x.to(cuda_device) for x in _pack(codes, is_clean))
            before = tplanes.build_planes.launches
            tplanes.build_planes(got, c2, aux, is_clean, codes.shape[1], k)
            torch.cuda.synchronize()
            assert tplanes.build_planes.launches == before + 1
            tplanes.build_planes_plain(want, c2, aux, is_clean,
                                       codes.shape[1], k)
        assert torch.equal(got, want)
        sets.append(got)
        del want
    sets.append(tplanes.alloc_planes(k, cuda_device))
    groups = {s: tplanes.PlaneSlots([sets[j % 3] for j in range(s)])
              for s in (1, 3, 32)}
    dirty = encode(qry)
    inside = np.arange(dirty.shape[1]) < np.array([len(s) for s in qry])[
        :, None]
    clean = np.where((dirty == 4) & inside, 0, dirty).astype(np.uint8)
    for t in (1, 2, 17):
        for codes, is_clean in ((dirty, False), (clean, True)):
            c2, aux = (x.to(cuda_device) for x in _pack(codes, is_clean))
            length = codes.shape[1]
            wmax = int((codes < 4).sum(axis=1).max()) - k + 1
            want = tplanes.probe_planes_multi_plain(
                groups[3].planes, c2, aux, is_clean, length, k, t, wmax)
            for s, slots in groups.items():
                before = (tplanes.probe_planes.launches,
                          tplanes.probe_planes_multi.launches)
                one = tplanes.probe_planes(sets[0], c2, aux, is_clean,
                                           length, k, t, wmax)
                multi = tplanes.probe_planes_multi(slots, c2, aux, is_clean,
                                                   length, k, t, wmax)
                torch.cuda.synchronize()
                assert (tplanes.probe_planes.launches,
                        tplanes.probe_planes_multi.launches) == (
                            before[0] + 1, before[1] + 1)
                assert torch.equal(one, want[0])
                assert torch.equal(multi, want[[j % 3 for j in range(s)]])
            assert bool(want[0, -1])  # the 18k fragment
            assert not want[2].any()
            if t <= 2:  # the reads holding 2k fragments
                assert int(want[0].sum()) > 100


@pytest.mark.gpu
def test_plane_kernels_reject_bad_inputs(cuda_device):
    k = 15
    pl = tplanes.alloc_planes(k, cuda_device)
    c2 = torch.zeros((4, 2), dtype=torch.int32, device=cuda_device)
    ln = torch.full((4,), 30, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):  # planes of another k
        tplanes.build_planes(pl, c2, ln, True, 32, k + 1)
    with pytest.raises(ValueError):  # planes on the CPU
        tplanes.probe_planes(pl.cpu(), c2, ln, True, 32, k, 2)
    with pytest.raises(ValueError):  # int64 lengths
        tplanes.probe_planes(pl, c2, ln.long(), True, 32, k, 2)
    with pytest.raises(ValueError):  # too few words for the length
        tplanes.probe_planes(pl, c2, ln, True, 33, k, 2)
    with pytest.raises(ValueError):
        tplanes.PlaneSlots([pl, pl.cpu()])
    slots = tplanes.PlaneSlots([pl, pl])
    with pytest.raises(ValueError):  # batch on the CPU
        tplanes.probe_planes_multi(slots, c2.cpu(), ln.cpu(), True, 32, k, 2)
    out = tplanes.probe_planes_multi(slots, c2[:0], ln[:0], True, 32, k, 2)
    assert out.shape == (2, 0)


@pytest.mark.gpu
def test_search_multi_set_planes_cuda_matches_cpu(tmp_path, monkeypatch,
                                                  cuda_device):
    """The plane route on the card (build and probe kernels, several
    batches, slot groups of two, a lone slot) and on the CPU: identical
    bytes, log lines and counters, for search_multi_set_planes and for
    index_and_search."""
    monkeypatch.setenv("COMMET_TPU_STREAM", "0")
    monkeypatch.setattr(tengine, "STREAM_BATCH", 64)
    paths, qrys = [], []
    for s in range(3):
        (tmp_path / f"s{s}").mkdir()
        idx_fa, qry_fas, _ = make_fastas(tmp_path / f"s{s}", 520 + s, 21,
                                         0.02)
        paths.append(idx_fa)
        qrys += qry_fas
    got = {}
    for dev in (cuda_device, "cpu"):
        eng = tengine.Engine(k=21, t=2, device=dev, max_kmer=2000)
        res = []
        for s, p in enumerate(paths):
            rs = ReadSet(f"I{s}")
            rs.add_file(p)
            res.append(eng.build_resident_planes(rs))
        assert sum(len(r.partitions) for r in res) > 3
        out = str(tmp_path / str(dev))
        os.makedirs(out)
        q = ReadSet("Q")
        q.add_file(qrys[0])
        before = tplanes.probe_planes_multi.launches
        c = eng.search_multi_set_planes(q, res, out_dir=out, log_dir=out,
                                        max_slots=2)
        if dev != "cpu":
            assert tplanes.probe_planes_multi.launches > before + 2
        _c, pair = run_engine(eng, paths[1], qrys[1:], out + "/pair")
        blobs = {}
        for name in sorted(os.listdir(out)):
            if os.path.isdir(os.path.join(out, name)):
                continue
            with open(os.path.join(out, name), "rb") as f:
                data = f.read()
            blobs[name] = data.splitlines()[-1] if name.endswith(".log") \
                else data
        got[str(dev)] = ({n: {f: v[f] for f in ("indexed", "searched",
                                                "shared")}
                          for n, v in c.items()}, blobs, pair)
    assert got[str(cuda_device)] == got["cpu"]
    assert got["cpu"][0]["I0"]["shared"] > 0
