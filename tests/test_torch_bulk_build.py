"""The port's bulk plane build (K9: core/planes.py BulkChunk,
bulk_build_planes and its plain version, the plain versions of the four
kernel wrappers bulk_histogram / bulk_scatter / bulk_refine / bulk_apply) and its switches
in engine/engine.py (COMMET_TPU_BULK_BUILD, COMMET_TPU_BULK_CHUNK, the plane
cohorts' smaller chunk) against commet_tpu's bulk build
(kernels.bulk_plane_sorted, bulk_scatter_set, bulk_or_plane;
Engine._build_planes_bulk) and the port's per-batch build, on the same
numpy-seeded reads. Plane words: exact equality throughout."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from commet_tpu.core import kernels
from commet_tpu.core import stream as jstream
from commet_tpu.engine.engine import EncodedSet as JEncodedSet
from commet_tpu.engine.engine import Engine as JEngine
from commet_tpu.io.reads import ReadSet as JReadSet
from commet_tpu_torch.cli import commet as tcommet
from commet_tpu_torch.core import planes
from commet_tpu_torch.engine import engine as tengine
from commet_tpu_torch.parallel import sharded
from test_torch_gpu import _pack
from torch_helpers import encode, random_seqs, read_set, write_fasta


def _as_u32(pl):
    return pl.numpy().view(np.uint32)


def _batch(codes, clean=False):
    c2, aux = _pack(codes, clean)
    return c2, aux, clean, codes.shape[1]


def _two_level(batches, k):
    """The chunk through the kernel wrappers on CPU tensors (their plain
    versions): histogram tables, their scan, level 1, level 2 sorting each
    tile in place; returns (mid, table, counts, cstart) and checks that the
    fine counts sum to the chunk's entries."""
    ns, nbins = planes.bulk_layout(k)[2], planes.bulk_bins(k)[0]
    tables = torch.cat([torch.zeros((0, nbins), dtype=torch.int32)]
                       + [planes.bulk_histogram(*bt, k) for bt in batches])
    starts, cstart = planes.bulk_starts(tables)
    mid = torch.empty(4 * sum(planes.bulk_slots(bt[0], bt[3], k)
                              for bt in batches), dtype=torch.int32)
    row0 = 0
    for bt in batches:
        planes.bulk_scatter(mid, starts, row0, *bt, k)
        row0 += planes.bulk_blocks(bt[0])
    counts = torch.zeros(4 * ns, dtype=torch.int64)
    table = planes.bulk_table(mid, k)
    planes.bulk_refine(mid, table, counts, cstart, k)
    assert int(counts.sum()) == int(cstart[-1])
    return mid, table, counts, cstart


def _wrappers_build(pl, batches, k):
    """The chunk through the kernel wrappers' plain versions (_two_level),
    then one apply."""
    return planes.bulk_apply(pl, *_two_level(batches, k), k)


@pytest.mark.parametrize("k", [15, 32, 33])
def test_bulk_build_matches_jax_bulk(k):
    """Two flushes of the same reads (3% invalid bases) as
    tests/test_kernels.py runs commet_tpu's bulk build: the port's
    bulk_build_planes (its plain version on the CPU), the four wrappers'
    plain versions in turn, and the per-batch build give commet_tpu's
    planes word for word."""
    rng = np.random.default_rng(11)
    n, lpad = 96, 64
    codes = rng.integers(0, 4, size=(n, lpad)).astype(np.uint8)
    codes[rng.random(size=codes.shape) < 0.03] = 4
    codes[0] = 3  # an all-T read: keya all ones, bit 31 of its words
    wide = k > 32
    w = kernels.plane_words(k)
    want = kernels.alloc_planes(k)
    jcodes = jnp.asarray(codes.astype(np.int32))
    for rows in (slice(0, 40), slice(40, n)):
        ka, kb, hib, fl, _cnt = jstream.chunk_index_keys_codes(jcodes[rows],
                                                               k)
        for p in range(4):
            word, or_mask = kernels.bulk_plane_sorted(
                ka, kb, hib if wide else fl, fl, k, p, wide)
            scratch = kernels.bulk_scatter_set(jnp.zeros(w, jnp.uint32),
                                               word, or_mask)
            want = kernels.bulk_or_plane(want, scratch, p * w, w)
    want = np.asarray(want)
    chunks = [[_batch(codes[:25]), _batch(codes[25:40])],
              [_batch(codes[40:])]]
    got = planes.alloc_planes(k, "cpu")
    for chunk in chunks:
        assert planes.bulk_build_planes(got, chunk, k) is got
    np.testing.assert_array_equal(_as_u32(got), want)
    assert (want >= 1 << 31).any()
    wrapped = planes.alloc_planes(k, "cpu")
    for chunk in chunks:
        _wrappers_build(wrapped, chunk, k)
    assert torch.equal(wrapped, got)
    per_batch = planes.alloc_planes(k, "cpu")
    for chunk in chunks:
        for bt in chunk:
            planes.build_planes(per_batch, *bt, k)
    assert torch.equal(per_batch, got)


def _fasta(tmp_path, seed, n=300, length=70):
    rng = np.random.default_rng(seed)
    seqs = random_seqs(rng, n, length // 2, length, n_frac=0.01)
    path = str(tmp_path / "i.fa")
    write_fasta(path, seqs)
    return path


def _count_flushes(monkeypatch):
    """Record the window slots of every BulkChunk flush that has batches."""
    seen = []
    real = planes.BulkChunk.flush

    def spy(self):
        if self.batches:
            seen.append(self.slots)
        return real(self)

    monkeypatch.setattr(planes.BulkChunk, "flush", spy)
    return seen


def test_engine_bulk_force_matches_jax(tmp_path, monkeypatch):
    """COMMET_TPU_BULK_BUILD=force and COMMET_TPU_BULK_CHUNK=8192 on the
    CPU, at k = 15 and 21: the port's Engine.build_planes flushes a chunk
    each time it reaches 8,192 window slots, and its planes equal
    commet_tpu's Engine._build_planes_bulk under the same environment and
    the port's per-batch build (COMMET_TPU_BULK_BUILD=0)."""
    fa = _fasta(tmp_path, 12)
    monkeypatch.setenv("COMMET_TPU_BULK_CHUNK", "8192")
    monkeypatch.setenv("COMMET_TPU_BUILD_BATCH", "64")
    rs = JReadSet("I")
    rs.add_file(fa)
    trs = read_set("I", fa)
    enc = tengine.EncodedSet(trs)
    flushes = _count_flushes(monkeypatch)
    for k, slots in ((15, 64 * (96 - 15 + 1)), (21, 64 * (96 - 21 + 1))):
        monkeypatch.setenv("COMMET_TPU_BULK_BUILD", "force")
        want = np.asarray(JEngine(k=k, t=2, batch=64)._build_planes_bulk(
            kernels.alloc_planes(k), JEncodedSet(rs), rs.eligible()))
        eng = tengine.Engine(k=k, t=2, device="cpu")
        assert eng.uses_bulk_build() and eng.bulk_chunk() == 8192
        flushes.clear()
        got = eng.build_planes(enc, trs.eligible())
        np.testing.assert_array_equal(_as_u32(got), want)
        # batches of 64 reads (the last of 44): a flush every second batch
        assert flushes == [2 * slots, 2 * slots, 44 * slots // 64]
        monkeypatch.setenv("COMMET_TPU_BULK_BUILD", "0")
        eng0 = tengine.Engine(k=k, t=2, device="cpu")
        assert not eng0.uses_bulk_build()
        assert torch.equal(eng0.build_planes(enc, trs.eligible()), got)
        assert len(flushes) == 3


def test_bulk_switch_values(tmp_path, monkeypatch):
    """COMMET_TPU_BULK_BUILD: unset and 1 take the per-batch build on the
    CPU and the bulk build on the card, 0 never the bulk build, force
    always (also an unknown value reads as 1, as commet_tpu reads it).
    COMMET_TPU_BULK_CHUNK replaces the default chunk, 2^28 below k = 32 and
    2^27 from it, 2^26 beside resident plane sets at k >= 32; a value that
    is not an integer raises when the engine is made."""
    cases = {None: True, "1": True, "yes": True, "0": False, "force": True}
    for value, on_card in cases.items():
        if value is None:
            monkeypatch.delenv("COMMET_TPU_BULK_BUILD", raising=False)
        else:
            monkeypatch.setenv("COMMET_TPU_BULK_BUILD", value)
        eng = tengine.Engine(k=21, t=2, device="cpu")
        assert eng.uses_bulk_build() == (value == "force")
        eng.device = torch.device("cuda")  # the decision only: no card used
        assert eng.uses_bulk_build() == on_card
    monkeypatch.delenv("COMMET_TPU_BULK_BUILD")
    chunks = {k: tengine.Engine(k=k, t=2, device="cpu") for k in (21, 31, 32,
                                                                  33)}
    assert [(e.bulk_chunk(), e.bulk_chunk(beside_residents=True))
            for e in chunks.values()] == [(1 << 28, 1 << 28)] * 2 + [
                (1 << 27, 1 << 26)] * 2
    monkeypatch.setenv("COMMET_TPU_BULK_CHUNK", "5000")
    eng = tengine.Engine(k=33, t=2, device="cpu")
    assert (eng.bulk_chunk(), eng.bulk_chunk(True)) == (5000, 5000)
    monkeypatch.setenv("COMMET_TPU_BULK_CHUNK", "2^27")
    with pytest.raises(ValueError):
        tengine.Engine(k=33, t=2, device="cpu")
    # the CPU default builds batch by batch
    monkeypatch.delenv("COMMET_TPU_BULK_CHUNK")
    made = []
    monkeypatch.setattr(planes.BulkChunk, "__init__",
                        lambda *a: made.append(a))
    rs = read_set("I", _fasta(tmp_path, 3, n=40))
    tengine.Engine(k=15, t=2, device="cpu").build_planes(
        tengine.EncodedSet(rs), rs.eligible())
    assert made == []


def test_no_bulk_under_mesh(tmp_path, monkeypatch):
    """With a mesh the engine never takes the bulk build, even with
    COMMET_TPU_BULK_BUILD=force (commet_tpu requires no mesh): dp and plane
    mode build the planes the one-device bulk build gives."""
    k = 15
    monkeypatch.setenv("COMMET_TPU_BULK_BUILD", "force")
    rs = read_set("I", _fasta(tmp_path, 5, n=120))
    enc = tengine.EncodedSet(rs)
    alone = tengine.Engine(k=k, t=2, device="cpu")
    assert alone.uses_bulk_build()
    flushes = _count_flushes(monkeypatch)
    want = alone.build_planes(enc, rs.eligible())
    assert len(flushes) == 1
    mesh = sharded.Mesh(["cpu"] * 2)
    for mode in ("dp", "plane"):
        eng = tengine.Engine(k=k, t=2, device="cpu", mesh=mesh,
                             mesh_mode=mode)
        assert not eng.uses_bulk_build()
        got = eng.build_planes(enc, rs.eligible())
        whole = got.copies[0] if mode == "dp" else got.assembled()
        assert torch.equal(whole, want)
    assert len(flushes) == 1


def test_cohort_chunk_reaches_the_build(tmp_path, monkeypatch):
    """run_plane_cohorts hands Engine.build_resident_planes the chunk of
    Engine.bulk_chunk: at k = 33 2^27 for a cohort's first set and 2^26
    for each set built beside it (commet_tpu's halving, without touching
    the environment), COMMET_TPU_BULK_CHUNK where set, 2^28 at k = 21; and
    build_resident_planes hands it to build_planes, whose chunks flush at
    it."""
    seen = []

    def fake_build(self, rs, budget=None, bulk_chunk=None):
        seen.append(bulk_chunk)
        return tengine.ResidentPlanes(rs.name, [], [], 0, 0, 0.0)

    monkeypatch.setattr(tengine.Engine, "build_resident_planes", fake_build)
    monkeypatch.setattr(tengine.Engine, "search_multi_set_planes",
                        lambda *a, **kw: None)
    monkeypatch.setattr(tcommet, "_load_set", lambda name, *a: JReadSet(name))
    monkeypatch.setattr(tcommet, "refine_pair", lambda *a: None)
    names = ["s0", "s1", "s2"]
    for k, env, want in ((33, None, [1 << 27, 1 << 26, 1 << 26]),
                         (33, "5000", [5000] * 3), (21, None, [1 << 28] * 3)):
        if env is None:
            monkeypatch.delenv("COMMET_TPU_BULK_CHUNK", raising=False)
        else:
            monkeypatch.setenv("COMMET_TPU_BULK_CHUNK", env)
        seen.clear()
        eng = tengine.Engine(k=k, t=2, device="cpu")
        assert tcommet.run_plane_cohorts([[]] * 3, [[]] * 3, names,
                                         str(tmp_path), 3, eng, "test")
        assert seen == want
    monkeypatch.undo()
    monkeypatch.setenv("COMMET_TPU_BULK_BUILD", "force")
    monkeypatch.setenv("COMMET_TPU_BUILD_BATCH", "16")
    rs = read_set("I", _fasta(tmp_path, 6, n=100))
    flushes = _count_flushes(monkeypatch)
    res = tengine.Engine(k=15, t=2, device="cpu").build_resident_planes(
        rs, bulk_chunk=3000)
    assert len(res.partitions) == 1
    # batches of 16 reads x (96 - 15 + 1) slots: a flush every third batch
    assert len(flushes) == 3 and flushes[:2] == [3936, 3936]
    monkeypatch.setenv("COMMET_TPU_BULK_BUILD", "0")
    per_batch = tengine.Engine(k=15, t=2, device="cpu").build_planes(
        tengine.EncodedSet(rs), rs.eligible())
    assert torch.equal(res.partitions[0], per_batch)


def test_bulk_edges():
    """A chunk with no complete window (reads shorter than k, all-N reads)
    leaves the planes zero and its bins empty; k < 5 (one plane word), k <
    19 (one slice a plane), two slices a plane at k = 20 and a last chunk
    smaller than the others equal the per-batch build, through
    bulk_build_planes and the wrappers."""
    rng = np.random.default_rng(40)
    for k in (3, 4, 9, 18, 19, 20):
        short = encode(random_seqs(rng, 30, 1, k - 1, n_frac=0.0), lpad=k + 8)
        all_n = np.full((5, k + 8), 4, dtype=np.uint8)
        empty = [_batch(short, True), _batch(all_n)]
        pl = planes.alloc_planes(k, "cpu")
        planes.bulk_build_planes(pl, empty, k)
        assert not pl.any()
        for bt in empty:
            assert not planes.bulk_histogram(*bt, k).any()
        assert not _wrappers_build(pl, empty, k).any()
        full = [_batch(encode(random_seqs(rng, n, 1, 4 * k + 9,
                                          n_frac=0.02)))
                for n in (50, 50, 7)]
        want = planes.alloc_planes(k, "cpu")
        for bt in full:
            planes.build_planes(want, *bt, k)
        got = planes.alloc_planes(k, "cpu")
        planes.bulk_build_planes(got, full[:2], k)
        planes.bulk_build_planes(got, full[2:] + empty, k)
        assert torch.equal(got, want)
        wrapped = planes.alloc_planes(k, "cpu")
        _wrappers_build(wrapped, full[:2], k)
        _wrappers_build(wrapped, full[2:], k)
        assert torch.equal(wrapped, want)
    assert planes.bulk_layout(4) == (5, 1, 1, 5)
    assert planes.bulk_layout(18) == (18, 1 << 13, 1, 18)
    assert planes.bulk_layout(33) == (19, 1 << 14, 1 << 14, 27)
    assert planes.bulk_layout(36) == (19, 1 << 14, 1 << 17, 27)


def test_bulk_memory_checks(tmp_path, monkeypatch):
    """On the card the bulk build's chunk workspace counts beside the
    planes: build_planes raises a MemoryError naming COMMET_TPU_BULK_BUILD
    and COMMET_TPU_BULK_CHUNK when the planes fit and the workspace does
    not (before allocating), and build_resident_planes declines a set whose
    planes and workspace exceed the budget. The memory is faked; no card is
    used."""
    k = 15
    monkeypatch.setenv("COMMET_TPU_BULK_BUILD", "force")
    rs = read_set("I", _fasta(tmp_path, 7, n=100))
    enc, elig = tengine.EncodedSet(rs), rs.eligible()
    eng = tengine.Engine(k=k, t=2, device="cpu")
    eng.device = torch.device("cuda")
    chunk = eng.bulk_chunk()
    geom = tengine._geometry(enc.read_lengths(elig), k)
    work = eng._bulk_bytes(geom, chunk)
    lpad, rows = 96, 65536  # 70 bp reads; one batch holds them all
    assert work == planes.bulk_workspace_bytes(
        k, chunk, rows * (lpad - k + 1), rows * 4 * (6 + 3 + 1), rows)
    assert 16 * chunk < work < 32 * chunk  # one entry buffer, not two
    free = {"bytes": planes.plane_bytes(k) + work - 1}
    monkeypatch.setattr(eng, "_free_bytes", lambda dev=None: free["bytes"])
    with pytest.raises(MemoryError, match="COMMET_TPU_BULK_CHUNK") as err:
        eng.build_planes(enc, elig)
    assert "COMMET_TPU_BULK_BUILD" in str(err.value)
    free["bytes"] = planes.plane_bytes(k) - 1
    with pytest.raises(MemoryError, match="four bit planes"):
        eng.build_planes(enc, elig)
    free["bytes"] = (planes.plane_bytes(k) + work
                     + tengine.PLANES_WORKSPACE_BYTES - 1)
    assert eng.build_resident_planes(rs) is None
    monkeypatch.setenv("COMMET_TPU_BULK_BUILD", "0")
    per_batch = tengine.Engine(k=k, t=2, device="cpu")
    per_batch.device = torch.device("cuda")
    assert per_batch._bulk_bytes(geom, chunk) == 0
