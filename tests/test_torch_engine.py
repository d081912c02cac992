"""The port's Engine (device="cpu": the join's plain PyTorch version) against
commet_tpu's Engine with the stream forced on (COMMET_TPU_STREAM=force, the
Pallas join in interpret mode), on the same numpy-seeded fasta sets:
identical .bv bytes and .log counter lines. k=33 is held against the
reference oracle."""

import numpy as np
import pytest

import commet_tpu.engine.engine as jengine
from commet_tpu.io.bv import BitVector
from commet_tpu.io.reads import ReadSet
from commet_tpu_torch.engine import engine as tengine
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

