"""The batches packed on the device (core/pack.py, engine.py's device route)
against the host's pack (EncodedSet.gather_packed, the native
cio_gather_packed), on the CPU through the plain version: the same codes2,
valid and lengths bits and the same ``clean`` for clean reads, an N at the
first, a middle and the last base, empty reads and reads of length 1, k-1,
16, 32 and lpad, several lpads, and sets of several files with filtered and
already-tagged rows; the device route's batch generator yields the host
route's batches and slices; the engine's outputs and last_io_stats on
either route; and the sets a call's route choice uploads. The kernel's own
tests are in test_torch_gpu_pack.py."""

import numpy as np
import pytest
import torch

from commet_tpu_torch.core import pack
from commet_tpu_torch.engine import engine as tengine
from torch_helpers import (make_fastas, random_seqs, read_set, run_amortized,
                           run_engine, write_fasta)

K = 21
T = 2
ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)


def _acgt(rng, n):
    return bytes(ACGT[rng.integers(0, 4, n)])


def _with_n(rng, where):
    """Reads of 40-90 ACGT bases with an N at ``where`` (first, middle,
    last), and every fourth read clean."""
    seqs = []
    for i in range(60):
        s = bytearray(_acgt(rng, int(rng.integers(40, 91))))
        if i % 4:
            at = {"first": 0, "middle": len(s) // 2, "last": len(s) - 1}
            s[at[where]] = ord("N" if i % 2 else "n")
        seqs.append(bytes(s))
    return seqs


def _case(rng, name):
    """[per file: reads], [per file: filter mask or None], [per file:
    tagged positions]."""
    if name == "clean":
        return [[_acgt(rng, int(rng.integers(30, 120))) for _ in range(70)]],\
            [None], [[]]
    if name.startswith("n_"):
        return [_with_n(rng, name[2:])], [None], [[]]
    if name == "lengths":
        sizes = [0, 1, K - 1, 16, 32, 64, 0, 33, 15, 17, 31, 63]
        return [[_acgt(rng, n) for n in sizes]
                + random_seqs(rng, 30, 0, 64, n_frac=0.05)], [None], [[]]
    files = [random_seqs(rng, n, 0, 100, n_frac=0.03) for n in (40, 1, 55)]
    masks = [rng.random(len(f)) < 0.8 for f in files]
    tagged = [np.nonzero(rng.random(len(f)) < 0.25)[0] for f in files]
    return files, masks, tagged


def _read_set(tmp_path, files, masks, tagged):
    """A read set of the files, with the filter masks and tags applied."""
    paths = []
    for fi, seqs in enumerate(files):
        paths.append(str(tmp_path / f"f{fi}.fa"))
        write_fasta(paths[-1], seqs)
    rs = read_set("S", *paths)
    for f, m in zip(rs.files, masks):
        if m is not None:
            f.filter_bv = type(f.filter_bv).from_bool_array(m)
    for fi, pos in enumerate(tagged):
        rs.tag(np.full(len(pos), fi), np.asarray(pos, dtype=np.int64))
    return rs


@pytest.mark.parametrize("case", ["clean", "n_first", "n_middle", "n_last",
                                  "lengths", "multi_file"])
def test_plain_pack_matches_host_gather(tmp_path, case):
    """pack.gather_pack on the CPU (gather_pack_plain) from EncodedSet's
    upload gives EncodedSet.gather_packed's codes2, valid and lengths bit
    for bit, and the host's count of invalid bases its ``clean``, for the
    rows still to search at lpad the longest read (rounded up to 32, and not
    rounded), 16 and 45 past it, the rows in order and shuffled."""
    rng = np.random.default_rng(sum(map(ord, case)))
    rs = _read_set(tmp_path, *_case(rng, case))
    enc = tengine.EncodedSet(rs)
    dev = enc.upload("cpu")
    assert dev.codes.numel() % pack.CODES_ALIGN == 0
    assert enc.device_bytes() == dev.codes.numel() + 20 * sum(
        f.nb_reads for f in rs.files)
    idx = rs.untagged_eligible()
    assert len(idx) > 10
    geom = tengine._geometry(enc.read_lengths(idx), K)
    lmax = geom.lmax
    lpads = {geom.lpad, lmax, lmax + 16, lmax + 45}
    for lpad in sorted(lpads):
        for rows in (idx, idx[rng.permutation(len(idx))]):
            c2, vd, ln, clean = enc.gather_packed(rows, lpad)
            ids = torch.from_numpy(dev.ids(rows))
            g2, gv, gl = pack.gather_pack(dev.codes, dev.offsets,
                                          dev.lengths, ids, lpad)
            assert np.array_equal(g2.numpy().view(np.uint32), c2), lpad
            assert np.array_equal(gv.numpy().view(np.uint32), vd), lpad
            assert np.array_equal(gl.numpy(), ln), lpad
            assert (not dev.dirty[dev.ids(rows)].any()) == clean
    assert (case == "clean") == clean


def _batches(gen):
    """The batches of a generator as numpy bits (codes2, valid, lengths
    from wherever they lie) with their slices and clean flags."""
    return [(sl, c2.cpu().numpy(), vd.cpu().numpy(), ln.cpu().numpy(), clean)
            for sl, c2, vd, ln, clean in gen]


def test_device_batches_match_host_batches(tmp_path):
    """The device route's generator (_device_batches, on the CPU through
    the plain pack) yields the host route's slices and batches, bit for bit
    and clean for clean, over a multi-file set's filtered and untagged rows
    at several batch sizes, some batches clean and some not, from one
    upload of the set; it counts its reads and its uploads."""
    rng = np.random.default_rng(7)
    files = [[_acgt(rng, int(rng.integers(20, 90))) for _ in range(50)],
             random_seqs(rng, 70, 0, 90, n_frac=0.01),
             [_acgt(rng, 40) for _ in range(30)]]
    masks = [rng.random(len(f)) < 0.9 for f in files]
    tagged = [np.nonzero(rng.random(len(f)) < 0.2)[0] for f in files]
    rs = _read_set(tmp_path, files, masks, tagged)
    eng = tengine.Engine(k=K, t=T, device="cpu")
    enc = tengine.EncodedSet(rs)
    idx = rs.untagged_eligible()
    lpad = tengine._geometry(enc.read_lengths(idx), K).lpad
    eng._io_reset()
    eng._upload_set(enc)
    first = enc.on_device
    for size in (1, 7, 32, len(idx), len(idx) + 5):
        want = _batches(eng._host_batches(enc, idx, lpad, size))
        got = _batches(eng._device_batches(enc, idx, lpad, size))
        assert len(got) == len(want) == -(-len(idx) // size)
        for g, w in zip(got, want):
            assert g[0] == w[0] and g[4] == w[4]
            for a, b in zip(g[1:4], w[1:4]):
                assert a.dtype == b.dtype and np.array_equal(a, b)
        if size == 32:
            assert {b[4] for b in got} == {True, False}
    assert enc.on_device is first
    eng._io_stash(0.0)
    stats = eng.last_io_stats
    assert stats["device_packed"] == 5 * len(idx)
    assert stats["upload_s"] > 0.0 and stats["host_block_s"] > 0.0


@pytest.mark.parametrize("route", ["planes", "sorted"])
def test_engine_device_route_outputs_and_io_stats(tmp_path, monkeypatch,
                                                  route):
    """The engine with every set of every call sent down the device route
    (the plain pack on the CPU) writes the host route's .bv bytes and .log
    counter lines through index_and_search and the resident calls, the
    planes route and the sorted one; last_io_stats carries upload_s and
    device_packed, the reads searched on the device route and 0 on the
    host's, and the resident searches' own counters."""
    monkeypatch.setenv("COMMET_TPU_STREAM", "0" if route == "planes"
                       else "force")
    monkeypatch.setattr(tengine, "STREAM_BATCH", 40)
    idx_fa, qry_fas, _ = make_fastas(tmp_path, 96, K, 0.02, n_queries=2)
    host = tengine.Engine(k=K, t=T, device="cpu")
    want = (run_engine(host, idx_fa, qry_fas, str(tmp_path / "h"))[1],
            run_amortized(host, idx_fa, qry_fas, str(tmp_path / "hm"),
                          route == "planes"))
    assert host.last_io_stats["device_packed"] == 0
    assert host.last_io_stats["upload_s"] == 0.0
    eng = tengine.Engine(k=K, t=T, device="cpu")
    monkeypatch.setattr(eng, "_upload", lambda sets, reserve: [
        eng._upload_set(enc) for enc in sets])
    got = (run_engine(eng, idx_fa, qry_fas, str(tmp_path / "d"))[1],
           run_amortized(eng, idx_fa, qry_fas, str(tmp_path / "dm"),
                         route == "planes"))
    assert got == want
    stats = eng.last_io_stats
    # the resident searches also count the slots a read is probed
    # against, and the sorted one its exact fallback's reads and seconds
    assert set(stats) == {"wall_s", "host_pack_s", "host_block_s",
                          "upload_s", "upload_pinned_bytes", "device_packed",
                          "fetch_s", "slots"} | (
                              set() if route == "planes"
                              else {"ambig", "exact_s"})
    assert stats["device_packed"] == 150 and stats["upload_s"] > 0.0


class _Sized:
    """A stand-in EncodedSet of a given device_bytes."""

    def __init__(self, n_bytes):
        self.n_bytes = n_bytes

    def device_bytes(self):
        return self.n_bytes


@pytest.mark.parametrize("where", ["card", "cpu", "mesh"])
def test_upload_gives_the_route_to_the_sets_that_fit(monkeypatch, where):
    """Engine._upload uploads, in turn, each set whose device bytes fit in
    the free bytes less the call's reserve and the sets before it, and
    none on the CPU or with a mesh (the card is faked: only the choice
    runs)."""
    eng = tengine.Engine(k=K, t=T, device="cpu")
    if where != "cpu":
        eng.device = torch.device("cuda", 0)
    if where == "mesh":
        eng.mesh = object()
    monkeypatch.setattr(eng, "_free_bytes", lambda device=None: 1000)
    uploaded = []
    monkeypatch.setattr(eng, "_upload_set", uploaded.append)
    sets = [_Sized(n) for n in (800, 500, 150, 60, 1)]
    eng._upload(sets, 300)
    assert uploaded == ([sets[1], sets[2], sets[4]] if where == "card"
                        else [])
    uploaded.clear()
    eng._upload(sets, 1000)
    assert uploaded == []
