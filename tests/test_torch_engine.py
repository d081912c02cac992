"""The port's Engine on its sorted-index route (COMMET_TPU_STREAM=force;
device="cpu": the join's plain PyTorch version) against commet_tpu's Engine
with the stream forced on (the Pallas join in interpret mode) or on its
dense planes, on the same numpy-seeded fasta sets: identical .bv bytes and
.log counter lines. k=33 is held against the reference oracle. The port's
plane route is tested in test_torch_planes_engine.py."""

import numpy as np
import pytest

import commet_tpu.engine.engine as jengine
from commet_tpu_torch.engine import engine as tengine
from commet_tpu_torch.io.bv import BitVector
from commet_tpu_torch.io.reads import ReadSet
from oracle import index_reads, search_read
from torch_helpers import make_fastas, run_engine

T = 2


def _jax_engine(monkeypatch, k, max_kmer, stream_mode):
    monkeypatch.setenv("COMMET_TPU_STREAM", stream_mode)
    monkeypatch.setattr(jengine, "_STREAM_SELFCHECK", {})
    eng = jengine.Engine(k=k, t=T, batch=2048, max_kmer=max_kmer)
    assert eng.stream == (stream_mode == "force")
    return eng


@pytest.mark.parametrize(
    "k,n_frac,max_kmer,n_queries,stream_batch,jax_stream", [
        # several partitions, dropped boundary reads
        (15, 0.0, 1500, 2, 65536, "force"),
        # dirty reads; several prefetched batches
        (21, 0.02, None, 1, 40, "force"),
        (32, 0.02, None, 1, 65536, "force"),
        # dense index: AMBIG reads take the exact fallback. Held against
        # the JAX dense-plane path (same tags; its interpret-mode stream is
        # too slow here at this fill)
        (11, 0.0, None, 1, 65536, "0"),
    ])
def test_engine_matches_jax(tmp_path, monkeypatch, k, n_frac, max_kmer,
                            n_queries, stream_batch, jax_stream):
    idx_fa, qry_fas, _ = make_fastas(tmp_path, 300 + k, k, n_frac,
                                      n_queries=n_queries)
    want_c, want = run_engine(_jax_engine(monkeypatch, k, max_kmer, jax_stream),
                        idx_fa, qry_fas, str(tmp_path / "jax"))
    monkeypatch.setattr(tengine, "STREAM_BATCH", stream_batch)
    monkeypatch.setenv("COMMET_TPU_STREAM", "force")
    eng = tengine.Engine(k=k, t=T, device="cpu", max_kmer=max_kmer)
    fallback_rows = []
    real = eng._search_stream_fallback

    def spy(sidx, enc, rows_idx, *args):
        fallback_rows.append(len(rows_idx))
        return real(sidx, enc, rows_idx, *args)

    monkeypatch.setattr(eng, "_search_stream_fallback", spy)
    got_c, got = run_engine(eng, idx_fa, qry_fas, str(tmp_path / "torch"))
    assert got == want
    if k == 11:
        assert sum(fallback_rows) > 0
    for name, c in want_c.items():
        for field in ("indexed", "searched", "shared"):
            assert got_c[name][field] == c[field]
        assert c["shared"] > 0
    if max_kmer is not None:
        rs = ReadSet("I")
        rs.add_file(idx_fa)
        elig = rs.eligible()
        parts = eng.partitions(eng.count_kmers(tengine.EncodedSet(rs), elig))
        assert len(parts) > 2
        assert sum(len(p) for p in parts) < len(elig)  # dropped reads


def test_partitions_match_jax(monkeypatch):
    monkeypatch.setenv("COMMET_TPU_STREAM", "0")
    rng = np.random.default_rng(3)
    for max_kmer in (1, 50, 400, 10 ** 6):
        counts = rng.integers(0, 120, 300).astype(np.int64)
        counts[::17] = 0
        want = jengine.Engine(k=15, t=T, max_kmer=max_kmer).partitions(
            counts)
        got = tengine.Engine(k=15, t=T, device="cpu",
                             max_kmer=max_kmer).partitions(counts)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def _cursor_loop(kmer_counts, max_kmer):
    """The partition cursor read by read, as the reference walks it
    (index_reads.h:49-61, index_and_search.cpp:255-277): the oracle of
    Engine.partitions."""
    n = len(kmer_counts)
    parts = []
    cursor = 0
    seen = 0
    while seen < n:
        nb = 0
        members = []
        seen += 1
        if cursor >= n:
            break
        r = cursor
        cursor += 1
        while True:
            if nb >= max_kmer:
                break  # read r is consumed but not indexed
            members.append(r)
            nb += int(kmer_counts[r])
            seen += 1
            if cursor >= n:
                r = None
                break
            r = cursor
            cursor += 1
        parts.append(np.array(members, dtype=np.int64))
        if r is None:
            break
    return parts


def _random_counts(seed, top):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, top + 1, 400).astype(np.int64)
    counts[rng.random(400) < 1 / 3] = 0
    return counts


CURSOR_CASES = [
    *[pytest.param(_random_counts(seed, top), cap,
                   id=f"random0-{top}-cap{cap}")
      for seed, top in ((5, 6), (6, 120))
      for cap in (1, 2, 7, 50, 10 ** 6, None)],
    pytest.param(np.zeros(0, dtype=np.int64), 5, id="empty"),
    pytest.param(np.array([3]), 5, id="one-read"),
    pytest.param(np.zeros(9, dtype=np.int64), 1, id="all-zero"),
    pytest.param(np.array([2, 9, 1, 5, 0, 12, 3]), 5,
                 id="read-alone-at-or-over-cap"),
    pytest.param(np.array([2, 2, 2, 2, 2]), 10, id="cap-at-last-read"),
    pytest.param(np.array([2, 2, 2, 2, 2]), 8, id="cap-at-last-but-one"),
    pytest.param(np.array([2, 2, 0, 0, 2, 2, 0]), 4,
                 id="zeros-around-cap"),
    pytest.param(np.array([1 << 40, 1 << 40, 7, 1 << 40, 1, 1]), 1 << 41,
                 id="counts-of-2^40"),
]


@pytest.mark.parametrize("counts,max_kmer", CURSOR_CASES)
def test_partitions_match_the_read_loop(counts, max_kmer):
    """Engine._ranges' prefix sum gives the read-by-read cursor's
    partitions as (start, stop) ranges, and Engine.partitions the same
    partitions, each an int64 array of positions; None: a cap above the
    counts' total."""
    if max_kmer is None:
        max_kmer = int(counts.sum()) + 1
    want = _cursor_loop(counts, max_kmer)
    eng = tengine.Engine(k=15, t=T, device="cpu", max_kmer=max_kmer)
    ranges = eng._ranges(counts)
    got = eng.partitions(counts)
    assert len(got) == len(ranges) == len(want)
    for g, (s, t), w in zip(got, ranges, want):
        assert g.dtype == np.int64
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(np.arange(s, t), w)


def test_engine_k33_matches_oracle(tmp_path):
    """k=33 (the reference default) with whole int64 keys: stream probe and
    exact fallback reproduce the oracle's tags."""
    k = 33
    idx_fa, qry_fas, idx = make_fastas(tmp_path, 77, k, 0.01, n_idx=60,
                                        n_qry=80, length=110)
    eng = tengine.Engine(k=k, t=T, device="cpu")
    _counters, got = run_engine(eng, idx_fa, qry_fas, str(tmp_path / "out"))
    with open(qry_fas[0]) as f:
        qry = [ln.strip() for ln in f if not ln.startswith(">")]
    bloom = index_reads([s.decode() for s in idx], k)
    expected = np.array([search_read(bloom, s, k, T) for s in qry])
    assert expected.sum() > 0
    bv = BitVector.read(str(tmp_path / "out" / "qry0.fa_in_I.bv"))
    np.testing.assert_array_equal(bv.as_bool_array(), expected)
    assert got["Q0.log"].endswith(f"shared {int(expected.sum())}]")


def test_engine_rejects_k_above_36():
    with pytest.raises(ValueError):
        tengine.Engine(k=37, t=T, device="cpu")

