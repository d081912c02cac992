"""A build's plan in the port's engine: Engine.count_kmers, which takes a
read of only A, C, G and T (by the parse's class counts) at
max(0, length - k + 1) windows and scans the codes of the others, against
the native scan of every row, read for read; and the ``build.count``
(``reads``, ``scanned``) and ``build.partition`` (``parts``) attributes
recorded under torch.profiler. The cursor itself is held to the
read-by-read loop in test_torch_engine.py. Imports no JAX."""

import numpy as np
import pytest
import torch

from commet_tpu_torch import trace
from commet_tpu_torch.engine import engine as tengine
from commet_tpu_torch.io.bv import BitVector
from commet_tpu_torch.io.reads import ReadSet
from commet_tpu_torch.native import parser as native
from torch_helpers import LUT, write_fasta

K = 15


def _clean(rng, n):
    return bytes(LUT[rng.integers(0, 4, n)])


def _reads(case, rng):
    """Each file's reads for ``case`` (clean reads of 20-60 bp around the
    case's own), and each file's filter (None: every read)."""
    c = lambda n: _clean(rng, n)  # noqa: E731
    own = {
        "n-first": [b"N" + c(40), b"N" + c(K)],
        "n-middle": [c(20) + b"N" + c(20), c(K) + b"N" + c(K - 1)],
        "n-last": [c(40) + b"N", c(K) + b"N"],
        "several-n": [c(16) + b"NN" + c(17) + b"N" + c(30) + b"N",
                      b"N" * 30, b"N" + c(K) + b"N" + c(K) + b"N"],
        "lengths-around-k": [c(K - 1), c(K), c(K + 1), b"", c(1),
                             c(K - 1) + b"N", b"N" + c(K), c(K) + b"N"],
        "lower-case": [c(30).lower(), c(10) + c(25).lower(),
                       c(K).lower() + b"n" + c(K)],
        "other-byte": [c(20) + b"R" + c(20), c(K) + b"-" + c(K),
                       b"." + c(30), c(30) + b"*"],
    }
    if case != "multi-file-filtered":
        mixed = own[case] + [c(int(rng.integers(20, 61))) for _ in range(9)]
        return [[mixed[i] for i in rng.permutation(len(mixed))]], [None]
    files = [list(own[name]) + [c(int(rng.integers(20, 61)))
                                for _ in range(5)]
             for name in ("n-middle", "several-n", "lengths-around-k")]
    keep = [rng.random(len(f)) < 0.6 for f in files]
    return files, keep


CASES = ["n-first", "n-middle", "n-last", "several-n", "lengths-around-k",
         "lower-case", "other-byte", "multi-file-filtered"]


def _set(tmp_path, case, seed=7):
    files, keep = _reads(case, np.random.default_rng(seed))
    rs = ReadSet("I")
    for fi, (seqs, mask) in enumerate(zip(files, keep)):
        path = str(tmp_path / f"f{fi}.fa")
        write_fasta(path, seqs)
        bv_path = None
        if mask is not None:
            bv_path = str(tmp_path / f"f{fi}.bv")
            BitVector.from_bool_array(mask).write(bv_path)
        rs.add_file(path, bv_path)
    return rs


def _scanned_everywhere(enc, idx, k):
    """The native scan of every row's codes, file by file."""
    out = np.zeros(len(idx), dtype=np.int64)
    for fi in range(len(enc.flat_codes)):
        rows = np.nonzero(idx[:, 0] == fi)[0]
        out[rows] = native.count_kmers(enc.flat_codes[fi], enc.offsets[fi],
                                       enc.lengths[fi], idx[rows, 1], k)
    return out


def _dirty_rows(rs, idx):
    """Per row of ``idx``, whether its read holds a base other than A, C,
    G or T, by the file's class counts."""
    out = np.zeros(len(idx), dtype=bool)
    for fi, f in enumerate(rs.files):
        rows = np.nonzero(idx[:, 0] == fi)[0]
        out[rows] = f.class_counts()[0][idx[rows, 1], 4] > 0
    return out


def _recorded(fn):
    """``fn()``'s result and the spans recorded, by name, while it ran
    under torch.profiler."""
    trace.clear()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            out = fn()
        return out, {s.name: s for s in trace.recorded()}
    finally:
        trace.clear()


@pytest.mark.parametrize("case", CASES)
def test_count_kmers_match_the_scan_of_every_row(tmp_path, case):
    """Engine.count_kmers equals the native scan of every row, read for
    read, and scans only the reads with a base other than A, C, G, T: the
    build.count span's ``scanned`` is their number, ``reads`` the rows."""
    rs = _set(tmp_path, case)
    enc = tengine.EncodedSet(rs)
    idx = rs.eligible()
    if case == "multi-file-filtered":
        assert len(idx) < sum(f.nb_reads for f in rs.files)
        assert set(idx[:, 0]) == {0, 1, 2}
    want = _scanned_everywhere(enc, idx, K)
    dirty = _dirty_rows(rs, idx)
    assert dirty.any() and not dirty.all()
    eng = tengine.Engine(k=K, t=2, device="cpu")
    got, spans = _recorded(lambda: eng.count_kmers(enc, idx))
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    assert spans["build.count"].attrs == {"reads": len(idx),
                                          "scanned": int(dirty.sum())}


def test_plan_spans_count_reads_scanned_and_parts(tmp_path):
    """Under torch.profiler the build.count span carries the rows counted
    and those scanned (the rows with a base other than A, C, G, T), and
    build.partition the partitions cut; nothing is recorded without a
    profiler, and the counts and partitions are the same."""
    rs = _set(tmp_path, "multi-file-filtered")
    enc = tengine.EncodedSet(rs)
    idx = rs.eligible()
    eng = tengine.Engine(k=K, t=2, device="cpu", max_kmer=60)
    dirty = int(_dirty_rows(rs, idx).sum())
    trace.clear()
    off = eng.count_kmers(enc, idx)
    off_parts = eng.partitions(off)
    assert trace.recorded() == []

    def plan():
        counts = eng.count_kmers(enc, idx)
        return counts, eng.partitions(counts)

    (counts, parts), spans = _recorded(plan)
    np.testing.assert_array_equal(counts, off)
    assert [p.tolist() for p in parts] == [p.tolist() for p in off_parts]
    assert len(parts) > 2
    assert spans["build.count"].attrs == {"reads": len(idx),
                                          "scanned": dirty}
    assert 0 < dirty < len(idx)
    assert spans["build.partition"].attrs == {"parts": len(parts)}
