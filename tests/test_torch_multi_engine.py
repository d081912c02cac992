"""The port's amortized engine path against commet_tpu's and against its own
pairwise path: build_resident (and its refusals), search_multi_set
(counters, .bv bytes, log counter lines, several partitions, edge
residents, slot grouping, long reads) and the stream batch geometry that
follows the read length. The JAX side runs with the stream forced on and the
Pallas join in interpret mode; tags, counter lines and bytes must be
identical. The port's resident sorted indexes are asked for with
COMMET_TPU_STREAM=force: these small sets are above the fill gate."""

import glob
import os

import numpy as np
import pytest
import torch

import commet_tpu.engine.engine as jengine
from commet_tpu_torch.engine import engine as tengine
from commet_tpu_torch.io.bv import BitVector
from commet_tpu_torch.io.reads import ReadSet
from torch_helpers import (file_bytes, force_jax_stream, implant, last_line,
                           long_seq, multi_sets, random_seqs, read_set,
                           write_fasta)

T = 2


def _empty_set(path, bv_path):
    rs = ReadSet("NONE")
    rs.add_file(path, bv_path)
    return rs


def _run_multi(eng, idx_paths, qpath, out, **kw):
    os.makedirs(out, exist_ok=True)
    residents = [eng.build_resident(read_set(f"I{s}", p, engine=eng))
                 for s, p in enumerate(idx_paths)]
    assert all(r is not None for r in residents)
    counters = eng.search_multi_set(read_set("Q", qpath, engine=eng),
                                    residents,
                                    out_dir=out, log_dir=out, **kw)
    return residents, counters


def _pair_outputs(out, idx_names, qpath):
    blobs = {}
    for name in idx_names:
        blobs[name] = (file_bytes([os.path.join(
            out, os.path.basename(qpath) + "_in_" + name + ".bv")]),
            last_line(os.path.join(out, f"Q_in_{name}.log")))
    return blobs


@pytest.mark.parametrize("max_kmer", [None, 900])
def test_search_multi_set_matches_jax(tmp_path, monkeypatch, max_kmer):
    """Counters, .bv bytes and log counter lines: port multi = JAX multi =
    port pairwise, including several partitions per resident."""
    k = 15
    idx_paths, qpath = multi_sets(tmp_path, 91, k)
    names = [f"I{s}" for s in range(len(idx_paths))]
    force_jax_stream(monkeypatch)
    jout, tout, pout = (str(tmp_path / d) for d in ("jax", "torch", "pair"))
    _jr, want_c = _run_multi(jengine.Engine(k=k, t=T, batch=64,
                                            max_kmer=max_kmer),
                             idx_paths, qpath, jout)
    teng = tengine.Engine(k=k, t=T, device="cpu", max_kmer=max_kmer)
    residents, got_c = _run_multi(teng, idx_paths, qpath, tout)
    if max_kmer is not None:
        assert all(len(r.partitions) > 1 for r in residents)
    os.makedirs(pout)
    for s, p in enumerate(idx_paths):
        pair = teng.index_and_search(read_set(names[s], p),
                                     [read_set("Q", qpath)], out_dir=pout,
                                     log_dir=pout)["Q"]
        for field in ("indexed", "searched", "shared"):
            assert got_c[names[s]][field] == want_c[names[s]][field] \
                == pair[field], (names[s], field)
    got = _pair_outputs(tout, names, qpath)
    assert got == _pair_outputs(jout, names, qpath)
    assert got == _pair_outputs(pout, names, qpath)
    assert got_c["I0"]["shared"] > 0 and got_c["I2"]["shared"] > 0


def test_search_multi_set_edge_residents(tmp_path, monkeypatch):
    """A resident without eligible reads (no partitions), one whose last
    partition holds only reads shorter than k (mi = 0), and a plain one:
    the pairwise bytes and counters."""
    k = 15
    idx_paths, qpath = multi_sets(tmp_path, 5, k, n_sets=2)
    rng = np.random.default_rng(6)
    short_tail = [long_seq(rng, 60) for _ in range(12)] + [
        long_seq(rng, 10) for _ in range(4)]
    write_fasta(tmp_path / "tail.fa", short_tail)
    none = tmp_path / "none.bv"
    with open(qpath, "rb") as f:
        n_reads = f.read().count(b">")
    BitVector(n_reads).write(str(none))  # no read passes the filter
    monkeypatch.setenv("COMMET_TPU_STREAM", "force")
    sets = [lambda: read_set("I0", idx_paths[0]),
            lambda: read_set("TAIL", str(tmp_path / "tail.fa")),
            lambda: _empty_set(qpath, str(none))]
    # TAIL: reads 0..10 (46 k-mers each) reach 506 >= 500, read 11 is
    # dropped, and the last partition holds only the four 10 bp reads
    eng = tengine.Engine(k=k, t=T, device="cpu", max_kmer=500)
    residents = [eng.build_resident(mk()) for mk in sets]
    assert [r.partitions[-1].mi for r in residents[1:2]] == [0]
    assert residents[2].partitions == []
    out, pout = str(tmp_path / "multi"), str(tmp_path / "pair")
    os.makedirs(out)
    os.makedirs(pout)
    got_c = eng.search_multi_set(read_set("Q", qpath), residents,
                                 out_dir=out, log_dir=out)
    for mk in sets:
        rs = mk()
        want = eng.index_and_search(rs, [read_set("Q", qpath)],
                                    out_dir=pout, log_dir=pout)["Q"]
        for field in ("indexed", "searched", "shared"):
            assert got_c[rs.name][field] == want[field], (rs.name, field)
    names = ["I0", "TAIL", "NONE"]
    assert _pair_outputs(out, names, qpath) == _pair_outputs(pout, names,
                                                              qpath)
    assert got_c["NONE"]["searched"] == 0 and got_c["NONE"]["shared"] == 0


def test_max_slots_grouping(tmp_path, monkeypatch):
    """One-slot groups and one 32-slot group give the same counters and
    bytes."""
    k = 15
    monkeypatch.setenv("COMMET_TPU_STREAM", "force")
    idx_paths, qpath = multi_sets(tmp_path, 17, k, n_sets=4, n_idx=40,
                                   n_qry=80)
    eng = tengine.Engine(k=k, t=T, device="cpu", max_kmer=900)
    res = {}
    for slots in (1, 32):
        out = str(tmp_path / f"s{slots}")
        _r, c = _run_multi(eng, idx_paths, qpath, out, max_slots=slots)
        res[slots] = ({n: {f: v[f] for f in ("indexed", "searched",
                                             "shared")}
                       for n, v in c.items()},
                      file_bytes(glob.glob(out + "/*.bv")))
    assert res[1] == res[32]
    assert len(res[1][1]) == 4


# --------------------------------------------------------------------------
# Refusals
# --------------------------------------------------------------------------

def test_build_resident_refusals(tmp_path, monkeypatch):
    idx_paths, _q = multi_sets(tmp_path, 3, 15, n_sets=1)
    rs = read_set("I0", idx_paths[0])
    monkeypatch.setenv("COMMET_TPU_STREAM", "force")
    assert tengine.Engine(k=35, t=T, device="cpu").build_resident(rs) is None
    eng = tengine.Engine(k=15, t=T, device="cpu")
    assert eng.build_resident(rs, budget=10.0) is None
    monkeypatch.setenv("COMMET_TPU_RESIDENT_BUDGET", "10")
    assert eng.build_resident(rs) is None
    monkeypatch.delenv("COMMET_TPU_RESIDENT_BUDGET")
    r = eng.build_resident(rs)
    assert r is not None and r.nb_indexed == 50
    assert r.device_bytes() == r.total_kmers * tengine.INDEX_BYTES_PER_KMER


def test_build_resident_refuses_before_the_build_check(tmp_path,
                                                       monkeypatch):
    """On the card (faked: only the checks run) a set whose build fits but
    whose resident index with the build workspace does not is refused
    before build_index's own memory check could raise."""
    idx_paths, _q = multi_sets(tmp_path, 4, 15, n_sets=1)
    rs = read_set("I0", idx_paths[0])
    monkeypatch.setenv("COMMET_TPU_STREAM", "force")
    eng = tengine.Engine(k=15, t=T, device="cpu")
    eng.device = torch.device("cuda", 0)
    free = tengine.STREAM_BATCH_BYTES + 1000
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda dev: (free, 80 << 30))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda dev: 0)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda dev: 0)
    monkeypatch.setattr(eng, "_build_index", None)  # must not be reached
    assert eng.build_resident(rs) is None


def test_search_multi_set_declines_long_reads(tmp_path, monkeypatch):
    """A query set holding one 300 kb read: even a 2,048-read batch would
    hold more window keys than a batch may, so both packages decline and
    the driver takes the classic rounds."""
    k = 15
    idx_paths, qpath = multi_sets(tmp_path, 7, k, n_sets=1)
    rng = np.random.default_rng(7)
    long_fa = str(tmp_path / "long.fa")
    write_fasta(long_fa, [long_seq(rng, 300_000)])
    force_jax_stream(monkeypatch)
    for eng in (jengine.Engine(k=k, t=T, batch=64),
                tengine.Engine(k=k, t=T, device="cpu")):
        r = eng.build_resident(read_set("I0", idx_paths[0], engine=eng))
        assert r is not None
        assert eng.search_multi_set(read_set("QL", long_fa, engine=eng), [r],
                                    save=False) is None


# --------------------------------------------------------------------------
# The stream batch follows the read length
# --------------------------------------------------------------------------

def test_stream_batch_size_follows_read_length():
    sbs = tengine.stream_batch_size
    k = 32
    assert sbs(1_000_000, 100 - k + 1) == 65536  # 9.0M keys per batch
    assert sbs(1_000_000, 100 - k + 1, slots=32) == 65536
    assert sbs(1000, 100 - k + 1) == 1000
    sizes = [sbs(1_000_000, w) for w in (500, 2_000, 5_000, 10_000)]
    assert sizes == sorted(sizes, reverse=True) and sizes[-1] < 65536
    for s, w in zip(sizes, (500, 2_000, 5_000, 10_000)):
        assert s >= tengine.STREAM_MIN_BATCH
        assert s * 2 * w <= tengine.stream_max_keys()
    assert sbs(1_000_000, 300_000 - k + 1) is None
    assert sbs(3, 300_000 - k + 1) is None  # the floor decides
    # the fallback and an index build the geometry cannot serve take as
    # many reads as the key budget holds, one at the least
    assert tengine.row_batch_size(4096, 100) == 4096
    assert tengine.row_batch_size(4096, 300_000) == \
        tengine.stream_max_keys() // 600_000
    assert tengine.row_batch_size(4096, 10 ** 9) == 1


def test_search_set_long_read_matches_jax(tmp_path, monkeypatch):
    """One 300 kb read (holding index fragments) among short ones: the
    port's search takes the exact probe for every read, in batches the key
    budget bounds, and gives JAX's tags."""
    k = 21
    rng = np.random.default_rng(11)
    idx = random_seqs(rng, 40, 60, 90, n_frac=0.0)
    write_fasta(tmp_path / "idx.fa", idx)
    qry = random_seqs(rng, 6, 60, 90, n_frac=0.01)
    implant(rng, idx, qry, k, span=2)
    long_read = bytearray(long_seq(rng, 300_000))
    long_read[150_000:150_000 + 2 * k] = idx[3][:2 * k]
    qry.append(bytes(long_read))
    write_fasta(tmp_path / "qry.fa", qry)
    force_jax_stream(monkeypatch)
    outs = {}
    fallback = []
    teng = tengine.Engine(k=k, t=T, device="cpu")
    real = teng._search_stream_fallback

    def spy(sidx, enc, rows_idx, *args):
        fallback.append(len(rows_idx))
        return real(sidx, enc, rows_idx, *args)

    monkeypatch.setattr(teng, "_search_stream_fallback", spy)
    for name, eng in (("jax", jengine.Engine(k=k, t=T, batch=8)),
                      ("torch", teng)):
        out = str(tmp_path / name)
        os.makedirs(out)
        c = eng.index_and_search(read_set("I", str(tmp_path / "idx.fa"),
                                          engine=eng),
                                 [read_set("Q", str(tmp_path / "qry.fa"),
                                           engine=eng)],
                                 out_dir=out, log_dir=out)["Q"]
        outs[name] = (c["shared"], file_bytes(glob.glob(out + "/*.bv")),
                      last_line(out + "/Q_in_I.log"))
    assert fallback == [7]
    assert outs["torch"] == outs["jax"]
    bv = BitVector.read(str(tmp_path / "torch" / "qry.fa_in_I.bv"))
    assert bv.as_bool_array()[-1]  # the long read is tagged
