"""The driver's plane cohort (cli/commet.py build_plane_cohort) and the
grouped probe against it (Engine.search_multi_set_planes), on the CPU at
k = 21, held against the benchmark's plain reference
(commet_bench/reference/commet_ref.py) on seeded sets laid out as the
partition-cohort cell lays them out: the cohort builds its residents in
turn, every one after the first with bulk_chunk(beside_residents=True),
under the plane budget and the cohort cap, and declines below two plane
sets; one call against three residents writes the .bv bytes and .log
counters of three pairwise reference runs, over residents of one
partition and of several, from planes equal bit for bit; and under a
profiler the cohort.build, search.slots and finish.resident spans carry
their attributes."""

import os

import numpy as np
import pytest
import torch

from commet_bench import data
from commet_bench.reference import commet_ref
from commet_tpu_torch import trace
from commet_tpu_torch.cli.commet import build_plane_cohort
from commet_tpu_torch.core import planes
from commet_tpu_torch.engine.engine import Engine
from commet_tpu_torch.io.reads import ReadSet

K = 21
T = 2
SEED = 2**31 + 1919
N_INDEX = 3
# chunks of the bulk build, of the first set and of the sets built beside it
CHUNKS = {False: 1 << 14, True: 1 << 12}


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    """Three index sets and two query sets of 100 bp reads (the queries'
    even reads hold a 42 bp fragment of the first set's reads): their codes
    and fasta paths."""
    index, query = data.make_cohort(SEED, [1500] * N_INDEX, [400] * 2, 100,
                                    2 * K, 0.01)
    names = [f"S{i}" for i in range(N_INDEX)] + ["Q0", "Q1"]
    paths = data.write_sets(str(tmp_path_factory.mktemp("sets")), names,
                            index + query)
    return {"index": index, "query": query, "paths": paths, "names": names}


def _engine(monkeypatch, max_kmer=None):
    """A CPU engine on the bulk build (its plain version), whose chunks tell
    a set built beside residents from the first."""
    monkeypatch.setenv("COMMET_TPU_BULK_BUILD", "force")
    eng = Engine(k=K, t=T, device="cpu", max_kmer=max_kmer)
    monkeypatch.setattr(
        eng, "bulk_chunk",
        lambda beside_residents=False: CHUNKS[beside_residents])
    return eng


def _loader(sets, loaded):
    def load(i):
        loaded.append(i)
        rs = ReadSet(sets["names"][i])
        rs.add_file(sets["paths"][i])
        return rs
    return load


def _reference(sets, qi, max_kmer):
    """Per index set: the pairwise reference's tags and counters of query
    set ``qi`` and its packed planes, a partition each."""
    out = []
    for codes in sets["index"]:
        packed = []
        ref = commet_ref.BytePlanes(K, "cpu")
        tags, counts = commet_ref.index_and_search(
            ref, codes, np.ones(len(codes), dtype=bool),
            [(sets["query"][qi], np.ones(len(sets["query"][qi]), bool))],
            T, max_kmer, each_partition=lambda _pi, p: packed.append(
                p.packed()))
        out.append((tags[0], counts[0], packed))
    return out


@pytest.mark.parametrize("budget_sets,max_s,built,loads", [
    (None, 8, 3, 3),  # no budget: the whole cohort
    (2, 8, 2, 3),  # room for two: the third set is loaded and declined
    (2 - 1e-9, 8, 0, 0),  # below two plane sets: nothing is loaded
    (None, 2, 2, 2),  # the cohort cap
], ids=["all", "budget_two", "below_two", "cap_two"])
def test_cohort_builds_beside_residents(sets, monkeypatch, budget_sets,
                                        max_s, built, loads):
    eng = _engine(monkeypatch)
    chunks = []
    real = eng.build_resident_planes

    def build(rs, budget=None, bulk_chunk=None):
        chunks.append(bulk_chunk)
        return real(rs, budget=budget, bulk_chunk=bulk_chunk)

    monkeypatch.setattr(eng, "build_resident_planes", build)
    budget = (eng._planes_budget(None) if budget_sets is None
              else budget_sets * planes.plane_bytes(K))
    loaded = []
    cohort, total = build_plane_cohort(eng, _loader(sets, loaded), 0,
                                       N_INDEX, budget, max_s)
    assert [r.name for r in cohort] == sets["names"][:built]
    assert loaded == list(range(loads))
    assert chunks == [CHUNKS[i > 0] for i in range(loads)]
    assert total == sum(r.device_bytes() for r in cohort) \
        == built * planes.plane_bytes(K)
    for r, (_tags, _counts, packed) in zip(
            cohort, _reference(sets, 0, commet_ref.max_kmer_for(K))):
        assert len(r.partitions) == len(packed) == 1
        assert torch.equal(r.partitions[0].view(torch.uint8), packed[0])


@pytest.mark.parametrize("max_kmer", [None, 40000],
                         ids=["one_partition", "partitions"])
def test_multi_search_equals_pairwise_reference(sets, tmp_path, monkeypatch,
                                                max_kmer):
    eng = _engine(monkeypatch, max_kmer)
    cohort, _total = build_plane_cohort(
        eng, _loader(sets, []), 0, N_INDEX, eng._planes_budget(None), 8)
    assert len(cohort) == N_INDEX
    cap = commet_ref.max_kmer_for(K) if max_kmer is None else max_kmer
    for qi in range(2):
        name = sets["names"][N_INDEX + qi]
        q = ReadSet(name)
        q.add_file(sets["paths"][N_INDEX + qi])
        out = str(tmp_path / name)
        os.makedirs(out)
        eng.search_multi_set_planes(q, cohort, out_dir=out, log_dir=out)
        slots = sum(len(r.partitions) for r in cohort)
        assert eng.last_io_stats["slots"] == slots
        if max_kmer is not None:
            assert slots > N_INDEX
        base = os.path.basename(sets["paths"][N_INDEX + qi])
        ref = _reference(sets, qi, cap)
        # the first resident holds the queries' fragments
        assert ref[0][1][2] > 0
        for r, (tags, counts, packed) in zip(cohort, ref):
            got = commet_ref.read_bv(
                os.path.join(out, f"{base}_in_{r.name}.bv"), len(tags))
            assert np.array_equal(got, tags)
            assert commet_ref.read_counters(os.path.join(
                out, f"{name}_in_{r.name}.log")) == counts
            assert len(r.partitions) == len(packed)
            for mine, want in zip(r.partitions, packed):
                assert torch.equal(mine.view(torch.uint8), want)


def test_cohort_spans_and_slots(sets, tmp_path, monkeypatch):
    eng = _engine(monkeypatch)
    q = ReadSet("Q0")
    q.add_file(sets["paths"][N_INDEX])

    def calls():
        cohort, _total = build_plane_cohort(
            eng, _loader(sets, []), 0, N_INDEX, eng._planes_budget(None), 8)
        return eng.search_multi_set_planes(q, cohort, out_dir=str(tmp_path),
                                           log_dir=str(tmp_path))

    trace.clear()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            counters = calls()
    finally:
        spans = trace.recorded()
        trace.clear()
    builds = sorted((s for s in spans if s.name == "cohort.build"),
                    key=lambda s: s.start_ns)
    assert [s.attrs for s in builds] == [
        {"resident": i, "beside": i, "chunk": CHUNKS[i > 0]}
        for i in range(N_INDEX)]
    calls_under = [s.parent for s in spans
                   if s.name == "call.build_resident_planes"]
    assert sorted(calls_under) == sorted(s.id for s in builds)
    (slots,) = [s for s in spans if s.name == "search.slots"]
    assert slots.attrs == {"slots": N_INDEX}
    finish = sorted((s for s in spans if s.name == "finish.resident"),
                    key=lambda s: s.start_ns)
    assert [s.attrs for s in finish] == [
        {"resident": i, "shared": counters[f"S{i}"]["shared"]}
        for i in range(N_INDEX)]
    assert finish[0].attrs["shared"] > 0
    assert eng.last_io_stats["slots"] == N_INDEX
