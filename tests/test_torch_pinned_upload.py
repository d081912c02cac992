"""The device route's uploads from page-locked memory (engine.py:
_page_locked, Engine._pin, EncodedSet.upload, _device_batches;
io/reads.py: ReadFile.move_to), on the CPU with the page-lock helper
replaced by a plain allocator: a read file uploaded at most
PAGEABLE_UPLOADS times, as each set of a one-shot call is, keeps its
pageable arrays; a read file uploaded more often moves once, at its next
upload, and keeps the parse's bytes;
later calls copy from the moved tensors and move nothing; the
``pack.upload`` spans' ``bytes`` and ``pinned`` and
``last_io_stats["upload_pinned_bytes"]`` count what moved; the outputs are
the host route's. A CPU engine, whose device gains nothing from
page-locked memory, moves nothing and counts 0. The card's own tests are
in test_torch_gpu_pack.py."""

import gc
import weakref

import numpy as np
import pytest
import torch

from commet_tpu_torch import trace
from commet_tpu_torch.engine import engine as tengine
from commet_tpu_torch.io.reads import ReadFile
from torch_helpers import (make_fastas, outputs, random_seqs, read_set,
                           write_fasta)

K = 21
T = 2
# the searches of a query set before the one that moves its files
P = tengine.PAGEABLE_UPLOADS


def _query_set(tmp_path, files, seed):
    """The query set "Q0" of ``files`` fastas of make_fastas' query reads
    (the first holds its implants) and random reads; with several files,
    a fifth of each file's reads filtered out and a sixth tagged."""
    idx_fa, qry_fas, _ = make_fastas(tmp_path, seed, K, 0.02, n_qry=90)
    rng = np.random.default_rng(seed)
    paths = qry_fas[:1]
    for fi in range(1, files):
        paths.append(str(tmp_path / f"more{fi}.fa"))
        write_fasta(paths[-1], random_seqs(rng, 40 + 25 * fi, 0, 90,
                                           n_frac=0.03))
    rs = read_set("Q0", *paths)
    if files > 1:
        for fi, f in enumerate(rs.files):
            keep = rng.random(f.nb_reads) >= 0.2
            f.filter_bv = type(f.filter_bv).from_bool_array(keep)
            pos = np.nonzero(rng.random(f.nb_reads) < 1 / 6)[0]
            rs.tag(np.full(len(pos), fi), pos.astype(np.int64))
    return idx_fa, paths, rs


def _device_route(monkeypatch, eng):
    """Send every set of every call of ``eng`` down the device route."""
    monkeypatch.setattr(eng, "_upload", lambda sets, reserve: [
        eng._upload_set(enc) for enc in sets])


def _traced(fn):
    """fn()'s result and the spans it recorded."""
    trace.clear()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            out = fn()
        return out, trace.recorded()
    finally:
        trace.clear()


def _searches(eng, idx_fa, rs, out):
    """The index set made resident (build_resident_planes) and ``rs``
    searched against it P + 2 times (search_multi_set_planes), each call
    traced: [(its spans, its last_io_stats)], and the outputs."""
    calls = []
    resident, spans = _traced(
        lambda: eng.build_resident_planes(read_set("I", idx_fa)))
    calls.append((spans, dict(eng.last_io_stats)))
    for _ in range(P + 2):
        _r, spans = _traced(lambda: eng.search_multi_set_planes(
            rs, [resident], out_dir=out, log_dir=out))
        calls.append((spans, dict(eng.last_io_stats)))
    return calls


def _set_bytes(rs):
    """The bytes an upload of ``rs`` copies: every file's codes, offsets
    (int64, one a read) and lengths (int32)."""
    return sum(len(f.encoded()[0]) + 12 * f.nb_reads for f in rs.files)


@pytest.mark.parametrize("files", [1, 3])
def test_two_calls_pin_each_file_once(tmp_path, monkeypatch, files):
    """With the page-lock helper a plain allocator, on the device route:
    the resident build of a fresh index set and the first P searches of a
    query set move nothing (their uploads ``pinned`` 0); the next search
    moves each of the query set's read files once (one ``pack.pin`` a
    file, of its bytes, inside the set's ``pack.upload``), and the one
    after it moves none; the moved arrays hold the parse's bytes and back
    ``encoded``; each upload's ``bytes`` are the set's codes, offsets and
    lengths or the rows' ids, its ``pinned`` all of them from the moving
    search on, and last_io_stats' upload_pinned_bytes sums them; the .bv
    bytes and .log lines are the host route's."""
    monkeypatch.setenv("COMMET_TPU_STREAM", "0")
    monkeypatch.setattr(tengine, "STREAM_BATCH", 40)
    monkeypatch.setattr(tengine, "_page_locked", lambda device: torch.empty)
    host_dir, dev_dir = tmp_path / "h", tmp_path / "d"
    host_dir.mkdir()
    dev_dir.mkdir()
    idx_fa, paths, rs = _query_set(tmp_path, files, 220 + files)
    _i, _p, rs_host = _query_set(tmp_path, files, 220 + files)
    host = tengine.Engine(k=K, t=T, device="cpu")
    _searches(host, idx_fa, rs_host, str(host_dir))
    eng = tengine.Engine(k=K, t=T, device="cpu")
    _device_route(monkeypatch, eng)
    calls = _searches(eng, idx_fa, rs, str(dev_dir))
    assert outputs(str(dev_dir), paths[:1]) == outputs(str(host_dir),
                                                       paths[:1])
    for name in [p.rsplit("/", 1)[1] for p in paths[1:]]:
        assert ((dev_dir / f"{name}_in_I.bv").read_bytes()
                == (host_dir / f"{name}_in_I.bv").read_bytes())
    sets = [[read_set("I", idx_fa)]] + [[rs]] * (P + 2)
    assert len(calls) == len(sets)
    for ci, ((spans, stats), (want,)) in enumerate(zip(calls, sets)):
        ids = {s.id: s for s in spans}
        pins = [s for s in spans if s.name == "pack.pin"]
        if ci != P + 1:
            assert pins == []
        else:
            assert [s.attrs["bytes"] for s in pins] == [
                sum(a.nbytes for a in ReadFile(f.path).encoded())
                for f in want.files]
            assert {ids[s.parent].name for s in pins} == {"pack.upload"}
        uploads = [s.attrs for s in spans if s.name == "pack.upload"]
        assert len(uploads) == 2
        moved = _set_bytes(want)
        assert uploads[0] == {"bytes": moved,
                              "pinned": moved if ci > P else 0}
        searched = stats["device_packed"]
        assert searched > 0
        assert uploads[1] == {"bytes": 8 * searched,
                              "pinned": 8 * searched if ci > P else 0}
        assert stats["upload_pinned_bytes"] == sum(u["pinned"]
                                                   for u in uploads)
    for f in rs.files:
        parsed = ReadFile(f.path).encoded()
        assert f.held is not None
        for a, t, p in zip(f.encoded(), f.held, parsed):
            assert a.dtype == p.dtype and np.array_equal(a, p)
            assert a.ctypes.data == t.data_ptr()


def test_move_to_keeps_the_host_route(tmp_path):
    """ReadFile.move_to copies the parse's codes, offsets and lengths into
    the tensors its allocator makes and leaves the file's other views
    alone: the host route's pack (EncodedSet.gather_packed, the native
    gather) gives the same batch before and after, and the plain pack on
    the moved set's upload gives it too; DeviceCodes.ids writes into a
    given buffer what it returns without one; the upload copies the moved
    codes and lengths."""
    rng = np.random.default_rng(224)
    paths = []
    for fi, n in enumerate((30, 1, 45)):
        paths.append(str(tmp_path / f"f{fi}.fa"))
        write_fasta(paths[-1], random_seqs(rng, n, 0, 80, n_frac=0.05))
    rs = read_set("S", *paths)
    idx = rs.eligible()[::2]
    before = tengine.EncodedSet(rs).gather_packed(idx, 96)
    counts = [f.class_counts()[0].copy() for f in rs.files]
    made = []

    def alloc(shape, dtype):
        made.append((tuple(shape), dtype))
        return torch.full(shape, 7, dtype=dtype)

    for f in rs.files:
        f.move_to(alloc)
    assert made == [(a.shape, torch.from_numpy(a).dtype)
                    for f in rs.files for a in f.encoded()]
    enc = tengine.EncodedSet(rs)
    after = enc.gather_packed(idx, 96)
    for a, b in zip(before[:3], after[:3]):
        assert np.array_equal(a, b)
    assert before[3] == after[3]
    for f, c in zip(rs.files, counts):
        assert np.array_equal(f.class_counts()[0], c)
    dev = enc.upload("cpu")
    codes = np.concatenate([t.numpy() for f in rs.files for t in f.held[:1]])
    assert np.array_equal(dev.codes.numpy()[:len(codes)], codes)
    assert np.array_equal(dev.lengths.numpy(), np.concatenate(enc.lengths))
    out = np.full(len(idx), -1, dtype=np.int64)
    got = dev.ids(idx, out=out)
    assert got is out and np.array_equal(out, dev.ids(idx))
    from commet_tpu_torch.core import pack
    packed = pack.gather_pack(dev.codes, dev.offsets, dev.lengths,
                              torch.from_numpy(out), 96)
    for g, h in zip(packed, before[:3]):
        assert np.array_equal(g.numpy().view(h.dtype), h)


@pytest.mark.parametrize("route", ["host", "device"])
def test_cpu_engine_pins_nothing(tmp_path, monkeypatch, route):
    """A CPU engine moves no read file, on the host route and with every
    set sent down the device route: no ``pack.pin``, every ``pack.upload``
    (on the device route) ``pinned`` 0 beside its bytes, and
    upload_pinned_bytes 0."""
    monkeypatch.setenv("COMMET_TPU_STREAM", "0")
    idx_fa, _paths, rs = _query_set(tmp_path, 3, 225)
    eng = tengine.Engine(k=K, t=T, device="cpu")
    if route == "device":
        _device_route(monkeypatch, eng)
    out = tmp_path / "o"
    out.mkdir()
    for spans, stats in _searches(eng, idx_fa, rs, str(out)):
        assert not any(s.name == "pack.pin" for s in spans)
        uploads = [s.attrs for s in spans if s.name == "pack.upload"]
        assert len(uploads) == (2 if route == "device" else 0)
        assert all(u["pinned"] == 0 < u["bytes"] for u in uploads)
        assert stats["upload_pinned_bytes"] == 0
    assert all(f.held is None for f in rs.files)


def test_moved_memory_goes_with_the_read_set(tmp_path, monkeypatch):
    """A read set's moved tensors live as long as the set and no longer:
    the engine keeps none of them after the device-route call that moved
    them (the set's search after P of them), and once the set is dropped they are
    freed (to PyTorch's caching host allocator on the card, which keeps
    the blocks page-locked for the process's later requests)."""
    monkeypatch.setenv("COMMET_TPU_STREAM", "0")
    monkeypatch.setattr(tengine, "_page_locked", lambda device: torch.empty)
    idx_fa, _paths, rs = _query_set(tmp_path, 3, 226)
    eng = tengine.Engine(k=K, t=T, device="cpu")
    _device_route(monkeypatch, eng)
    out = tmp_path / "o"
    out.mkdir()
    resident = eng.build_resident_planes(read_set("I", idx_fa))
    for _ in range(P + 1):
        eng.search_multi_set_planes(rs, [resident], out_dir=str(out),
                                    log_dir=str(out))
    held = [weakref.ref(t) for f in rs.files for t in f.held]
    assert len(held) == 9 and all(r() is not None for r in held)
    del rs
    gc.collect()
    assert all(r() is None for r in held)


def test_fresh_read_sets_pin_nothing(tmp_path, monkeypatch):
    """Each call of a one-shot flow parses its sets anew (as the command
    line tools do), so each read file is uploaded once and none moves,
    however many calls (here P + 1) read the same files: no ``pack.pin``,
    every upload ``pinned`` 0 beside its bytes, upload_pinned_bytes 0, and
    the files keep the parse's arrays."""
    monkeypatch.setenv("COMMET_TPU_STREAM", "0")
    monkeypatch.setattr(tengine, "_page_locked", lambda device: torch.empty)
    idx_fa, paths, _rs = _query_set(tmp_path, 3, 227)
    eng = tengine.Engine(k=K, t=T, device="cpu")
    _device_route(monkeypatch, eng)
    resident = eng.build_resident_planes(read_set("I", idx_fa))
    for ci in range(P + 1):
        out = tmp_path / f"o{ci}"
        out.mkdir()
        rs = read_set("Q0", *paths)
        _r, spans = _traced(lambda: eng.search_multi_set_planes(
            rs, [resident], out_dir=str(out), log_dir=str(out)))
        assert not any(s.name == "pack.pin" for s in spans)
        uploads = [s.attrs for s in spans if s.name == "pack.upload"]
        assert len(uploads) == 2
        assert all(u["pinned"] == 0 < u["bytes"] for u in uploads)
        assert eng.last_io_stats["upload_pinned_bytes"] == 0
        assert all(f.held is None and f.uploads == 1 for f in rs.files)
