"""Card-only tests of the gather and pack on the card: the hand-written
kernel (csrc/pack.cu, pack.gather_pack) against its plain version and the
host's pack, and the engine's device route against its host route
(the same tags, counters, .bv bytes and planes), the route a set takes when
its codes do not fit, and the resident-plane budget counting them. Each
skips without a CUDA card. The file imports no JAX, so on a machine without
it it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_gpu_pack.py
"""

import numpy as np
import pytest
import torch

from commet_tpu_torch.core import pack, planes
from commet_tpu_torch.engine import engine as tengine
from torch_helpers import (make_fastas, random_seqs, read_set, run_amortized,
                           run_engine, write_fasta)

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
