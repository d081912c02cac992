"""The port's build plan (Engine._plan): each build call reads its index
set's eligible rows, k-mer counts and read lengths once, every partition's
rows are a view of the plan's, and each batch geometry (_geometry) is the
arithmetic the engine has always padded batches by. Also the one
dispatch-and-fetch loop of the probes (Engine._probe). No card is used."""

import numpy as np
import pytest
import torch

from commet_tpu_torch import trace
from commet_tpu_torch.engine import engine as tengine
from commet_tpu_torch.io.reads import ReadSet
from torch_helpers import make_fastas, read_set

K, T = 15, 2
# a cap of about nine index reads: many partitions
MAX_KMER = 600


def _sets(tmp_path):
    idx_fa, qry_fas, _ = make_fastas(tmp_path, 2101, K, 0.02, n_idx=200,
                                     n_qry=80, n_queries=2)
    return (read_set("I", idx_fa),
            [read_set(f"Q{qi}", p) for qi, p in enumerate(qry_fas)])


def _count_reads_of(monkeypatch, index_set):
    """Count the calls of ReadSet.eligible, Engine.count_kmers and
    EncodedSet.read_lengths that read ``index_set``."""
    calls = {"eligible": 0, "count_kmers": 0, "read_lengths": 0}

    def wrap(cls, name, of_index):
        real = getattr(cls, name)

        def counted(self, *args):
            if of_index(self, *args):
                calls[name] += 1
            return real(self, *args)

        monkeypatch.setattr(cls, name, counted)

    wrap(ReadSet, "eligible", lambda rs: rs is index_set)
    wrap(tengine.Engine, "count_kmers",
         lambda eng, enc, idx: enc.rs is index_set)
    wrap(tengine.EncodedSet, "read_lengths",
         lambda enc, idx: enc.rs is index_set)
    return calls


def _spy_plan_and_builds(monkeypatch, eng):
    """Keep the plan eng._plan makes and the rows and geometry each
    partition build receives."""
    seen = {"plans": [], "builds": []}
    real_plan = eng._plan

    def plan(index_set):
        seen["plans"].append(real_plan(index_set))
        return seen["plans"][-1]

    monkeypatch.setattr(eng, "_plan", plan)
    for name in ("_build_planes", "_build_index"):
        real = getattr(eng, name)

        def build(enc, rows, geom, *args, _real=real):
            seen["builds"].append((rows, geom))
            return _real(enc, rows, geom, *args)

        monkeypatch.setattr(eng, name, build)
    return seen


CALLS = {
    "index_and_search": (
        "1", lambda eng, rs, qs, out: eng.index_and_search(
            rs, qs, out_dir=out, log_dir=out)),
    "build_resident": ("force", lambda eng, rs, qs, out:
                       eng.build_resident(rs)),
    "build_resident_planes": ("0", lambda eng, rs, qs, out:
                              eng.build_resident_planes(rs)),
}


@pytest.mark.parametrize("call", list(CALLS))
def test_a_build_call_reads_its_index_set_once(tmp_path, monkeypatch, call):
    """Over many partitions, one build call asks for the index set's
    eligible rows, their k-mer counts and their read lengths once each;
    the rows each partition build receives are views of the plan's rows,
    in the cursor's ranges, with the geometry of the plan's lengths over
    that range."""
    mode, run = CALLS[call]
    monkeypatch.setenv("COMMET_TPU_STREAM", mode)
    rs, queries = _sets(tmp_path)
    eng = tengine.Engine(k=K, t=T, device="cpu", max_kmer=MAX_KMER)
    calls = _count_reads_of(monkeypatch, rs)
    seen = _spy_plan_and_builds(monkeypatch, eng)
    out = str(tmp_path / "out")
    (tmp_path / "out").mkdir()
    assert run(eng, rs, queries, out) is not None
    assert calls == {"eligible": 1, "count_kmers": 1, "read_lengths": 1}
    (plan,) = seen["plans"]
    ranges = eng._ranges(plan.counts)
    assert len(ranges) > 10
    assert len(seen["builds"]) == len(plan.parts) == len(ranges)
    for (rows, geom), part, (s, t) in zip(seen["builds"], plan.parts,
                                          ranges):
        assert rows is part.rows and np.shares_memory(rows, plan.rows)
        np.testing.assert_array_equal(rows, plan.rows[s:t])
        assert geom == tengine._geometry(plan.lengths[s:t], K)
        assert part.n_kmers == int(plan.counts[s:t].sum())


def _old_geometry(lengths, k):
    """The batch geometry as the engine worked it out before _geometry:
    _pad_length and the inline lmax and wmax."""
    lmax = int(np.asarray(lengths).max(initial=1))
    lpad = -(-max(lmax, k) // tengine.LENGTH_BUCKET) * tengine.LENGTH_BUCKET
    return lmax, lpad, max(1, lmax - k + 1)


@pytest.mark.parametrize("k", [15, 33])
def test_geometry_matches_the_old_arithmetic(k):
    """_geometry gives the lmax, lpad and wmax the engine padded batches by,
    for a longest read of 0, 1, below k, 32, 33, 100 and 1,000 bases, and
    for no reads at all."""
    for longest in (0, 1, k - 1, 32, 33, 100, 1000):
        lengths = np.array([0, longest // 2, longest], dtype=np.int32)
        got = tengine._geometry(lengths, k)
        assert (got.lmax, got.lpad, got.wmax) == _old_geometry(lengths, k)
        assert got.lpad % tengine.LENGTH_BUCKET == 0 and got.lpad >= k
    empty = tengine._geometry(np.zeros(0, dtype=np.int32), k)
    assert (empty.lmax, empty.wmax) == (1, 1)
    assert empty.lpad == _old_geometry([], k)[1]


class _Result:
    """A launch's result whose copy to the host is recorded."""

    def __init__(self, events, value):
        self.events, self.value = events, value

    def cpu(self):
        self.events.append("fetch")
        return self.value


@pytest.mark.parametrize("n_frac", [0.0, 0.02])
def test_probe_dispatches_then_fetches_by_row_slice(tmp_path, n_frac):
    """Engine._probe launches every batch before it fetches any result,
    passes a clean batch's lengths and the validity words of the others,
    and returns each batch's host result under its row slice, in row
    order, the copies inside one search.fetch span."""
    idx_fa, _q, _ = make_fastas(tmp_path, 2102, K, n_frac, n_idx=200)
    rs = read_set("I", idx_fa)
    eng = tengine.Engine(k=K, t=T, device="cpu")
    enc = tengine.EncodedSet(rs)
    rows = rs.eligible()
    geom = eng._geometry_of(enc, rows)
    events, cleans = [], []

    def launch(c2, aux, clean):
        events.append("launch")
        cleans.append(clean)
        words = -(-geom.lpad // 32)
        assert aux.shape == ((len(c2),) if clean else (len(c2), words))
        return _Result(events, torch.arange(len(c2)))

    trace.clear()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            fetched, seconds = eng._probe(enc, rows, geom, 37, launch)
        spans = [s.name for s in trace.recorded()]
    finally:
        trace.clear()
    n = -(-len(rows) // 37)
    assert events == ["launch"] * n + ["fetch"] * n
    assert set(cleans) == {n_frac == 0.0}
    assert [sl for sl, _got in fetched] == [
        slice(s, min(s + 37, len(rows))) for s in range(0, len(rows), 37)]
    for sl, got in fetched:
        np.testing.assert_array_equal(got, np.arange(sl.stop - sl.start))
    assert spans.count("search.fetch") == 1 and seconds >= 0.0
