"""The driver's sorted residents (cli/commet.py build_sorted_residents) and
the grouped join against them (Engine.search_multi_set), on the CPU at
k = 21 with sets below the fill gate, so that the sorted route serves them
unforced, held against the benchmark's plain references
(commet_bench/reference/commet_ref.py, sorted_index.py) on seeded sets laid
out as the sorted-cohort cell lays them out: the builds stop at the first
set that does not fit the budget; one call against sixteen residents writes
the .bv bytes and .log counters of sixteen pairwise reference runs, over
residents of one partition and of several; the exact fallback decides reads
the join leaves AMBIG, tagging some that the four value sets hold though
their pairs are absent; each resident's index reduces to the reference's
distinct pairs and value sets; and under a profiler each slot's fallback
runs in a search.exact span that last_io_stats adds up."""

import os

import numpy as np
import pytest
import torch

from commet_bench import data
from commet_bench.reference import commet_ref, sorted_index
from commet_bench.traffic.sorted_search import make_inputs
from commet_tpu_torch import trace
from commet_tpu_torch.cli.commet import build_sorted_residents
from commet_tpu_torch.engine.engine import Engine
from commet_tpu_torch.io.reads import ReadSet
from torch_helpers import encode, long_seq, write_fasta

K = 21
T = 2
SEED = 2**31 + 2323
N_INDEX = 16
# a cap that cuts each index set into three partitions
SMALL_CAP = 12000


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    """Sixteen index sets of 400 reads of 100 bp (1.5% of 2^21 each) and
    two query sets of 320 reads whose read 2i holds a 42 bp fragment of
    index set i mod 16: their codes and fasta paths."""
    index, query = make_inputs(
        {"k": K, "set_reads": 400, "read_len": 100, "n_share": 0.01},
        {"residents": N_INDEX, "queries": 2, "query_reads": 320}, SEED)
    names = [f"S{i}" for i in range(N_INDEX)] + ["Q0", "Q1"]
    paths = data.write_sets(str(tmp_path_factory.mktemp("sets")), names,
                            index + query)
    return {"index": index, "query": query, "paths": paths, "names": names}


def _loader(sets, loaded):
    def load(i):
        loaded.append(i)
        rs = ReadSet(sets["names"][i])
        rs.add_file(sets["paths"][i])
        return rs
    return load


def _residents(sets, max_kmer=None):
    eng = Engine(k=K, t=T, device="cpu", max_kmer=max_kmer)
    residents, _total = build_sorted_residents(eng, _loader(sets, []),
                                               N_INDEX, None)
    assert len(residents) == N_INDEX
    return eng, residents


def _reference(codes, query, cap):
    """The pairwise reference's tags and counters of reads ``query``
    against index reads ``codes``."""
    tags, counts = commet_ref.index_and_search(
        commet_ref.BytePlanes(K, "cpu"), codes,
        np.ones(len(codes), dtype=bool),
        [(query, np.ones(len(query), dtype=bool))], T, cap)
    return tags[0], counts[0]


@pytest.mark.parametrize("budget,built", [
    (None, N_INDEX),  # no budget: every set
    ("two", 2),  # room for two: the third set is loaded and declined
    ("below_one", 0),  # the first set alone is over: nothing is kept
], ids=["all", "budget_two", "below_one"])
def test_builds_stop_at_the_first_set_declined(sets, budget, built):
    eng = Engine(k=K, t=T, device="cpu")
    if budget is not None:
        _eng, full = _residents(sets)
        size = [r.device_bytes() for r in full]
        budget = sum(size[:2]) if budget == "two" else size[0] - 1
    loaded = []
    residents, total = build_sorted_residents(eng, _loader(sets, loaded),
                                              N_INDEX, budget)
    assert [r.name for r in residents] == sets["names"][:built]
    assert loaded == list(range(min(built + 1, N_INDEX)))
    assert total == sum(r.device_bytes() for r in residents)
    for r in residents:
        assert all(eng.serves_sorted(len(sx.ika)) for sx in r.partitions)


def test_builds_stop_above_the_fill_gate(sets, monkeypatch):
    """A set above the fill gate is declined before any other is
    loaded."""
    monkeypatch.setenv("COMMET_TPU_STREAM_MAX_FILL", "0.001")
    eng = Engine(k=K, t=T, device="cpu")
    loaded = []
    residents, total = build_sorted_residents(eng, _loader(sets, loaded),
                                              N_INDEX, None)
    assert residents == [] and total == 0 and loaded == [0]


@pytest.mark.parametrize("max_kmer", [None, SMALL_CAP],
                         ids=["one_partition", "partitions"])
def test_multi_search_equals_pairwise_reference(sets, tmp_path, max_kmer):
    eng, residents = _residents(sets, max_kmer)
    cap = commet_ref.max_kmer_for(K) if max_kmer is None else max_kmer
    slots = sum(len(r.partitions) for r in residents)
    assert slots == (N_INDEX if max_kmer is None else 3 * N_INDEX)
    for qi in range(2):
        name = sets["names"][N_INDEX + qi]
        q = ReadSet(name)
        q.add_file(sets["paths"][N_INDEX + qi])
        out = str(tmp_path / name)
        os.makedirs(out)
        eng.search_multi_set(q, residents, out_dir=out, log_dir=out)
        assert eng.last_io_stats["slots"] == slots
        assert eng.last_io_stats["ambig"] > 0
        base = os.path.basename(sets["paths"][N_INDEX + qi])
        for r, codes in zip(residents, sets["index"]):
            tags, counts = _reference(codes, sets["query"][qi], cap)
            # every resident gives fragments to the queries
            assert counts[2] > 0
            got = commet_ref.read_bv(
                os.path.join(out, f"{base}_in_{r.name}.bv"), len(tags))
            assert np.array_equal(got, tags)
            assert commet_ref.read_counters(os.path.join(
                out, f"{name}_in_{r.name}.log")) == counts


def test_index_reduces_to_the_reference(sets):
    """Each resident partition's summary (distinct pairs, digests, order)
    is the reference's, and a pair left out shows."""
    _eng, residents = _residents(sets, SMALL_CAP)
    for r, codes in zip(residents, sets["index"]):
        want = [sorted_index.pairs_summary(a, b)
                for a, b in sorted_index.partition_pairs(
                    codes, np.ones(len(codes), dtype=bool), K, SMALL_CAP,
                    "cpu")]
        got = [sorted_index.summary(sx.ika, sx.ikb, sx.sb, sx.sc, sx.sd)
               for sx in r.partitions]
        assert got == want and len(got) == 3
    sx = residents[-1].partitions[0]
    short = sorted_index.summary(sx.ika[1:], sx.ikb[1:], sx.sb, sx.sc,
                                 sx.sd)
    assert short["digest"][0] != want[0]["digest"][0]
    swapped = sorted_index.summary(sx.ika.flip(0), sx.ikb.flip(0), sx.sb,
                                   sx.sc, sx.sd)
    assert not swapped["sorted"]


def _kmer(a: int, b: int) -> bytes:
    """The k-mer whose forward keys are (a, b): base j (first at the top
    bit) is G/T where a's bit is set and C/T where b's is."""
    return bytes(b"ACGT"[2 * ((a >> (K - 1 - j)) & 1) + ((b >> (K - 1 - j))
                                                          & 1)]
                 for j in range(K))


@pytest.fixture(scope="module")
def crossed(tmp_path_factory):
    """An index set whose four value sets hold the values of pairs (a, b)
    that it does not hold: for each, k-mers (a, b1), (a2, b), (a3, b3) with
    a3 ^ b3 = a ^ b and (a | b, 0), beside 200 random reads; and a query set
    whose reads hold such an (a, b) k-mer twice, k apart, beside 200
    random reads."""
    rng = np.random.default_rng(SEED + 1)
    top = 1 << K
    index = [long_seq(rng, 100) for _ in range(200)]
    query = [long_seq(rng, 100) for _ in range(200)]
    for _ in range(12):
        a, b, b1, a2, a3 = (int(x) for x in rng.integers(1, top, 5))
        index += [_kmer(a, b1), _kmer(a2, b), _kmer(a3, a ^ b ^ a3),
                  _kmer(a | b, 0)]
        query.append(_kmer(a, b) * 2)
    d = tmp_path_factory.mktemp("crossed")
    write_fasta(d / "X.fa", index)
    write_fasta(d / "Y.fa", query)
    return str(d / "X.fa"), str(d / "Y.fa")


def test_fallback_decides_ambig_reads(crossed, tmp_path, monkeypatch):
    """The join leaves the crossed reads AMBIG; the exact fallback tags
    them, as the reference's planes do, where taking AMBIG as untagged
    would not."""
    idx_fa, qry_fa = crossed
    eng = Engine(k=K, t=T, device="cpu")

    def run(out):
        residents, _total = build_sorted_residents(
            eng, lambda _i: _read("X", idx_fa), 1, None)
        q = _read("Y", qry_fa)
        os.makedirs(out)
        eng.search_multi_set(q, residents, out_dir=out, log_dir=out)
        n = len(q.eligible())
        return commet_ref.read_bv(os.path.join(out, "Y.fa_in_X.bv"), n)

    tags = run(str(tmp_path / "exact"))
    assert eng.last_io_stats["ambig"] >= 12
    with monkeypatch.context() as m:
        m.setattr(Engine, "_search_stream_fallback",
                  lambda self, sidx, enc, rows, geom: np.zeros(len(rows),
                                                               dtype=bool))
        skipped = run(str(tmp_path / "skipped"))
    assert tags[200:].all() and not skipped[200:].any()
    assert (tags != skipped).sum() >= 12
    want, _counts = _reference(encode(_fasta_reads(idx_fa)),
                               encode(_fasta_reads(qry_fa)),
                               commet_ref.max_kmer_for(K))
    assert np.array_equal(tags, want)


def _read(name, path):
    rs = ReadSet(name)
    rs.add_file(path)
    return rs


def _fasta_reads(path):
    with open(path, "rb") as f:
        return f.read().split(b"\n")[1::2]


def test_exact_spans_and_io_stats(sets, tmp_path):
    eng, residents = _residents(sets)
    q = _read("Q0", sets["paths"][N_INDEX])
    trace.clear()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            eng.search_multi_set(q, residents, out_dir=str(tmp_path),
                                 log_dir=str(tmp_path))
    finally:
        spans = trace.recorded()
        trace.clear()
    stats = eng.last_io_stats
    exact = sorted((s for s in spans if s.name == "search.exact"),
                   key=lambda s: s.start_ns)
    assert [s.attrs["resident"] for s in exact] == sorted(
        s.attrs["resident"] for s in exact)
    assert len(exact) > N_INDEX // 2
    assert sum(s.attrs["reads"] for s in exact) == stats["ambig"] > 0
    (call,) = [s for s in spans if s.name == "call.search_multi_set"]
    assert {s.parent for s in exact} == {call.id}
    assert stats["slots"] == N_INDEX
    assert sum((s.end_ns - s.start_ns) * 1e-9 for s in exact) == \
        pytest.approx(stats["exact_s"], rel=1e-9, abs=1e-12)
