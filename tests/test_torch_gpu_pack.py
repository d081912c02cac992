"""Card-only tests of the gather and pack on the card: the hand-written
kernel (csrc/pack.cu, pack.gather_pack) against its plain version and the
host's pack, and the engine's device route against its host route
(the same tags, counters, .bv bytes and planes), the route a set takes when
its codes do not fit, the resident-plane budget counting them, and the
device route's uploads from page-locked memory (each read file uploaded
often moved once, its memory let go with it). Each
skips without a CUDA card. The file imports no JAX, so on a machine without
it it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_gpu_pack.py
"""

import gc
import weakref

import numpy as np
import pytest
import torch

from commet_tpu_torch import trace
from commet_tpu_torch.core import pack, planes
from commet_tpu_torch.engine import engine as tengine
from commet_tpu_torch.io.reads import ReadFile
from torch_helpers import (make_fastas, outputs, random_seqs, read_set,
                           run_amortized, run_engine, write_fasta)

K = 21
T = 2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _host_route(monkeypatch, eng):
    """Send every set of every call of ``eng`` down the host route."""
    monkeypatch.setattr(eng, "_upload", lambda sets, reserve: None)


@pytest.mark.gpu
def test_pack_kernel_matches_plain_on_card(tmp_path, cuda_device):
    """The kernel gives the plain version's and the host pack's codes2,
    valid and lengths bit for bit over three files (reads of 0 to 300
    bases, Ns, every read starting anywhere in the buffer) at lpads on and
    off a 16- and 32-base boundary, rows in order, shuffled and repeated,
    and a batch of none; one launch a batch; the wrapper refuses a codes
    buffer off its 4-byte alignment and tensors of another type."""
    rng = np.random.default_rng(18)
    paths = []
    for fi, (n, lmax) in enumerate(((20000, 150), (3, 7), (5000, 300))):
        paths.append(str(tmp_path / f"f{fi}.fa"))
        write_fasta(paths[-1], random_seqs(rng, n, 0, lmax, n_frac=0.02))
    rs = read_set("S", *paths)
    enc = tengine.EncodedSet(rs)
    idx = rs.eligible()
    dev = enc.upload(cuda_device)
    cpu = tengine.EncodedSet(rs).upload("cpu")
    launched = pack.gather_pack.launches
    runs = 0
    for lpad in (300, 301, 312, 320, 416):
        for rows in (idx, idx[rng.permutation(len(idx))],
                     idx[rng.integers(0, len(idx), 7000)], idx[:0]):
            ids = dev.ids(rows)
            got = pack.gather_pack(dev.codes, dev.offsets, dev.lengths,
                                   torch.from_numpy(ids).to(cuda_device),
                                   lpad)
            runs += len(rows) > 0
            plain = pack.gather_pack_plain(cpu.codes, cpu.offsets,
                                           cpu.lengths,
                                           torch.from_numpy(ids), lpad)
            c2, vd, ln, _clean = enc.gather_packed(rows, lpad)
            for g, p, h in zip(got, plain, (c2, vd, ln)):
                g = g.cpu()
                assert g.dtype == p.dtype and torch.equal(g, p), lpad
                assert np.array_equal(g.numpy().view(h.dtype), h), lpad
    torch.cuda.synchronize()
    assert pack.gather_pack.launches - launched == runs
    ids = torch.zeros(4, dtype=torch.int64, device=cuda_device)
    with pytest.raises(ValueError):
        pack.gather_pack(dev.codes[1:], dev.offsets, dev.lengths, ids, 320)
    with pytest.raises(ValueError):
        pack.gather_pack(dev.codes, dev.offsets, dev.lengths.long(), ids, 320)
    with pytest.raises(ValueError):
        pack.gather_pack(dev.codes, dev.offsets, dev.lengths, ids.int(), 320)


@pytest.mark.gpu
def test_device_route_matches_host_route_on_card(tmp_path, monkeypatch,
                                                 cuda_device):
    """On the card the engine packs on the card by default and writes the
    host route's .bv bytes and .log counter lines through
    build_resident_planes and search_multi_set_planes (the same planes) and
    through index_and_search on a sorted-index partition, in batches of 500
    reads; last_io_stats counts the reads packed on the card, and no
    prefetch thread is made."""
    monkeypatch.setattr(tengine, "STREAM_BATCH", 500)
    idx_fa, qry_fas, _ = make_fastas(tmp_path, 180, K, 0.02, n_idx=3000,
                                     n_qry=4000, n_queries=2)
    got = {}

    def no_thread(*args, **kwargs):
        raise AssertionError("a prefetch thread was made")

    for route in ("host", "device"):
        if route == "device":
            monkeypatch.setattr(tengine, "ThreadPoolExecutor", no_thread)
        launched = pack.gather_pack.launches
        engines = {}
        for mode in ("0", "force"):
            monkeypatch.setenv("COMMET_TPU_STREAM", mode)
            engines[mode] = tengine.Engine(k=K, t=T, device=cuda_device)
            if route == "host":
                _host_route(monkeypatch, engines[mode])
        eng = engines["0"]
        resident = eng.build_resident_planes(read_set("I", idx_fa))
        assert resident is not None
        multi = run_amortized(eng, idx_fa, qry_fas,
                              str(tmp_path / (route + "_m")))
        searched = dict(eng.last_io_stats)
        _c, pair = run_engine(engines["force"], idx_fa, qry_fas,
                              str(tmp_path / (route + "_p")))
        torch.cuda.synchronize()
        got[route] = (multi, pair, resident.partitions[0].cpu())
        assert searched["device_packed"] == (4000 if route == "device"
                                             else 0)
        assert (pack.gather_pack.launches > launched) == (route == "device")
    assert got["device"][:2] == got["host"][:2]
    assert torch.equal(got["device"][2], got["host"][2])


@pytest.mark.gpu
def test_codes_that_do_not_fit_take_the_host_route(tmp_path, monkeypatch,
                                                   cuda_device):
    """A set whose device_bytes do not fit in the free bytes beside what
    its call reserves packs on the host (pinned host batches, nothing
    uploaded); one that fits packs on the card. build_resident_planes
    declines a set only where its planes and bulk workspace do not fit,
    builds it on the host route where its codes do not fit beside them and
    on the card where they do, the same planes each time."""
    rng = np.random.default_rng(181)
    path = str(tmp_path / "i.fa")
    write_fasta(path, random_seqs(rng, 3000, 20, 150, n_frac=0.01))
    rs = read_set("I", path)
    eng = tengine.Engine(k=K, t=T, device=cuda_device)
    enc = tengine.EncodedSet(rs)
    idx = rs.eligible()
    geom = tengine._geometry(enc.read_lengths(idx), K)
    lpad = geom.lpad
    free = eng._free_bytes()
    monkeypatch.setattr(eng, "_free_bytes",
                        lambda device=None, free=free: free)
    eng._upload([enc], free - enc.device_bytes() + 1)
    assert enc.on_device is None
    sl, c2, _vd, _ln, _clean = next(eng._batched_packed(enc, idx, lpad, 256))
    assert c2.device.type == "cpu" and c2.is_pinned()
    eng._upload([enc], free - enc.device_bytes())
    assert enc.on_device is not None
    sl, c2, _vd, _ln, _clean = next(eng._batched_packed(enc, idx, lpad, 256))
    assert c2.is_cuda
    need = (planes.plane_bytes(K) + eng._bulk_bytes(geom, eng.bulk_chunk())
            + tengine.PLANES_WORKSPACE_BYTES)
    built = []
    for free, route in ((need - 1, None), (need, "host"),
                        (need + enc.device_bytes() - 1, "host"),
                        (need + enc.device_bytes(), "device")):
        monkeypatch.setattr(eng, "_free_bytes",
                            lambda device=None, free=free: free)
        resident = eng.build_resident_planes(rs)
        assert (resident is None) == (route is None), free
        if resident is not None:
            assert (eng.last_io_stats["device_packed"] > 0) == (
                route == "device"), free
            built.append(resident.partitions[0].cpu())
    assert all(torch.equal(pl, built[0]) for pl in built[1:])


@pytest.mark.gpu
def test_multi_partition_call_reserves_its_later_partitions(
        tmp_path, monkeypatch, cuda_device):
    """On a card simulated to hold ``cap`` bytes (free: cap less what
    PyTorch holds allocated beyond the start), index_and_search over
    several plane partitions uploads its sets only where they fit beside
    the most one partition takes (its planes and bulk workspace, or its
    planes and a search's workspace), so no later partition's build runs
    out: from the least cap the call needs on the host route to one that
    holds every set's codes, the call writes the host route's .bv bytes
    and .log counter lines, packing on the card only at the caps that hold
    a set's codes."""
    monkeypatch.setenv("COMMET_TPU_STREAM", "0")
    monkeypatch.setattr(tengine, "PLANES_WORKSPACE_BYTES", 1 << 20)
    idx_fa, qry_fas, _ = make_fastas(tmp_path, 182, K, 0.02, n_idx=3000,
                                     n_qry=2000, n_queries=2)
    host = tengine.Engine(k=K, t=T, device=cuda_device, max_kmer=40000)
    _host_route(monkeypatch, host)
    _c, want = run_engine(host, idx_fa, qry_fas, str(tmp_path / "host"))
    eng = tengine.Engine(k=K, t=T, device=cuda_device, max_kmer=40000)
    rs = read_set("I", idx_fa, engine=eng)
    plan = eng._plan(rs)
    assert len(plan.parts) > 2
    least = max(eng._partition_bytes(p) for p in plan.parts)
    sizes = [plan.enc.device_bytes()] + [
        tengine.EncodedSet(read_set(f"Q{qi}", path, engine=eng))
        .device_bytes() for qi, path in enumerate(qry_fas)]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(cuda_device)
    for cap in (least, least + min(sizes) - 1, least + min(sizes),
                least + sum(sizes) - 1, least + sum(sizes)):
        monkeypatch.setattr(eng, "_free_bytes", lambda device=None, cap=cap:
                            cap - torch.cuda.memory_allocated(cuda_device)
                            + base)
        launched = pack.gather_pack.launches
        _c, got = run_engine(eng, idx_fa, qry_fas,
                             str(tmp_path / f"cap{cap}"))
        assert got == want, cap
        assert (pack.gather_pack.launches > launched) == (
            cap >= least + min(sizes)), cap


def _traced(fn):
    """fn()'s result and the engine spans it recorded."""
    trace.clear()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            out = fn()
        return out, trace.recorded()
    finally:
        trace.clear()


def _three_files(tmp_path, seed):
    """An index fasta and a query set "Q0" of three files (make_fastas'
    query reads with their implants, then random reads), a fifth of each
    file's reads filtered out and a sixth tagged; and the query paths."""
    idx_fa, qry_fas, _ = make_fastas(tmp_path, seed, K, 0.02, n_idx=3000,
                                     n_qry=4000)
    rng = np.random.default_rng(seed)
    paths = qry_fas + [str(tmp_path / f"more{fi}.fa") for fi in (1, 2)]
    for fi, path in enumerate(paths[1:], 1):
        write_fasta(path, random_seqs(rng, 1500 * fi, 0, 150, n_frac=0.03))
    rs = read_set("Q0", *paths)
    for fi, f in enumerate(rs.files):
        f.filter_bv = type(f.filter_bv).from_bool_array(
            rng.random(f.nb_reads) >= 0.2)
        pos = np.nonzero(rng.random(f.nb_reads) < 1 / 6)[0]
        rs.tag(np.full(len(pos), fi), pos.astype(np.int64))
    return idx_fa, paths, rs


@pytest.mark.gpu
def test_uploads_come_from_page_locked_memory_on_card(tmp_path, monkeypatch,
                                                      cuda_device):
    """On the card, the index set's one upload (its build) and the query
    set's first P uploads (P = PAGEABLE_UPLOADS searches) move no file and
    copy nothing from page-locked memory (pinned 0); the next search
    moves each of the query set's files (one pack.pin a file), which then
    hold their codes, offsets and lengths page-locked (is_pinned) with
    the parse's bytes, and from then on every upload copies all its bytes
    from page-locked memory (pinned == bytes); the search after it moves
    no file. Through build_resident_planes and P + 2
    search_multi_set_planes of a three-file query set with filtered and
    tagged rows, in batches of 500 reads, the device route writes the host
    route's .bv bytes and .log lines and builds its planes."""
    P = tengine.PAGEABLE_UPLOADS
    monkeypatch.setattr(tengine, "STREAM_BATCH", 500)
    monkeypatch.setenv("COMMET_TPU_STREAM", "0")
    got = {}
    for route in ("host", "device"):
        idx_fa, paths, rs = _three_files(tmp_path, 183)
        eng = tengine.Engine(k=K, t=T, device=cuda_device)
        if route == "host":
            _host_route(monkeypatch, eng)
        out = tmp_path / route
        out.mkdir()
        rs_i = read_set("I", idx_fa)
        resident, spans = _traced(lambda: eng.build_resident_planes(rs_i))
        calls = [(spans, dict(eng.last_io_stats))]
        for _ in range(P + 2):
            _r, spans = _traced(lambda: eng.search_multi_set_planes(
                rs, [resident], out_dir=str(out), log_dir=str(out)))
            calls.append((spans, dict(eng.last_io_stats)))
        torch.cuda.synchronize()
        got[route] = (outputs(str(out), paths[:1]),
                      [(out / (p.rsplit("/", 1)[1] + "_in_I.bv"))
                       .read_bytes() for p in paths],
                      resident.partitions[0].cpu())
        pins = [[s for s in spans if s.name == "pack.pin"]
                for spans, _stats in calls]
        uploads = [[s.attrs for s in spans if s.name == "pack.upload"]
                   for spans, _stats in calls]
        if route == "host":
            assert pins == [[]] * (P + 3) and uploads == [[]] * (P + 3)
            assert all(f.held is None for f in rs_i.files + rs.files)
            continue
        assert [len(p) for p in pins] == [0] * (P + 1) + [3, 0]
        for ci, ((spans, stats), up) in enumerate(zip(calls, uploads)):
            assert len(up) == 2
            assert all(u["pinned"] == (u["bytes"] if ci > P else 0)
                       and u["bytes"] > 0 for u in up)
            assert stats["upload_pinned_bytes"] == sum(u["pinned"]
                                                       for u in up)
        assert all(f.held is None for f in rs_i.files)
        for f in rs.files:
            assert all(t.is_pinned() for t in f.held)
            for a, p in zip(f.encoded(), ReadFile(f.path).encoded()):
                assert np.array_equal(a, p)
    assert got["device"][:2] == got["host"][:2]
    assert torch.equal(got["device"][2], got["host"][2])


@pytest.mark.gpu
def test_dropped_read_set_lets_its_page_locked_memory_go(tmp_path,
                                                         cuda_device):
    """A read set dropped right after the device-route build that moved
    it into page-locked memory (its build after PAGEABLE_UPLOADS others)
    frees its tensors without error, to PyTorch's caching host allocator,
    which keeps the blocks page-locked; page-locked blocks of the same
    sizes taken at once and overwritten leave the build's planes as a
    fresh build of the set makes them (the allocator hands out no block a
    copy still reads)."""
    rng = np.random.default_rng(184)
    path = str(tmp_path / "i.fa")
    write_fasta(path, random_seqs(rng, 20000, 20, 150, n_frac=0.01))
    eng = tengine.Engine(k=K, t=T, device=cuda_device)
    rs = read_set("I", path)
    for _ in range(tengine.PAGEABLE_UPLOADS):
        eng.build_resident_planes(rs)
        assert rs.files[0].held is None
    first = eng.build_resident_planes(rs)
    sizes = [(t.shape, t.dtype) for t in rs.files[0].held]
    held = [weakref.ref(t) for t in rs.files[0].held]
    del rs
    gc.collect()
    assert all(r() is None for r in held)
    taken = [torch.empty(shape, dtype=dtype, pin_memory=True).fill_(3)
             for shape, dtype in sizes]
    torch.cuda.synchronize()
    again = eng.build_resident_planes(read_set("I", path))
    torch.cuda.synchronize()
    assert torch.equal(first.partitions[0], again.partitions[0])
    assert all(t.is_pinned() for t in taken)
