"""The port's Engine on a mesh of 8 CPU shards (parallel/sharded.py) against
the port's single-device Engine and commet_tpu's single-device Engine, on
numpy-seeded fasta sets: identical result .bv bytes and .log counter lines,
and equal indexed / searched / shared counters. The cases follow
commet_tpu's own mesh tests (tests/test_engine_stream.py:210-318,
tests/test_sharded.py:49-90): DP with the sorted index forced, DP on the
planes, DP with dirty batches, DP at k = 33, plane mode on a
multi-partition k = 15 pair; and the driver with a mesh engine takes the
classic rounds. commet_tpu's engine runs its dense-plane route (its stream
in interpret mode is too slow here; its tags are the same either way); at
k = 33, where it peaks at 4.6 GB on the CPU on either route, the tags are
held to the reference oracle (tests/oracle.py) instead, as
test_torch_engine.py holds the single-device k = 33 engine."""

import contextlib
import io

import numpy as np
import pytest

import commet_tpu.engine.engine as jengine
from commet_tpu_torch.cli import commet as tcommet
from commet_tpu_torch.engine import engine as tengine
from commet_tpu_torch.parallel import sharded
from commet_tpu_torch.io.bv import BitVector
from oracle import index_reads, search_read
from torch_helpers import LUT, read_set, run_engine, write_fasta

T = 2
MESH = sharded.Mesh(["cpu"] * 8)


def _sets(tmp_path, seed, k, n_idx=120, n_qry=160, length=90,
          poison=False):
    """test_engine_stream.py's sets: random reads; every other query read
    holds a 2k fragment of an index read; with ``poison`` every fifth
    query read from the second holds an N (dirty batches)."""
    rng = np.random.default_rng(seed)

    def reads(n):
        return [bytes(LUT[rng.integers(0, 4, length)]) for _ in range(n)]

    idx, qry = reads(n_idx), reads(n_qry)
    for i in range(0, n_qry, 2):
        d = idx[int(rng.integers(n_idx))]
        start = int(rng.integers(0, length - 2 * k + 1))
        pos = int(rng.integers(0, length - 2 * k + 1))
        qry[i] = qry[i][:pos] + d[start:start + 2 * k] + qry[i][pos + 2 * k:]
    if poison:
        qry = [s[:40] + b"N" + s[41:] if i % 5 == 1 else s
               for i, s in enumerate(qry)]
    write_fasta(tmp_path / "idx.fa", idx)
    write_fasta(tmp_path / "qry.fa", qry)
    return str(tmp_path / "idx.fa"), [str(tmp_path / "qry.fa")]


def _seqs(path):
    with open(path) as f:
        return [ln.strip() for ln in f if not ln.startswith(">")]


def _counters(c):
    return {n: {f: v[f] for f in ("indexed", "searched", "shared")}
            for n, v in c.items()}


def _held_to_both(tmp_path, monkeypatch, k, idx_fa, qry_fas, mesh_engine,
                  max_kmer=None):
    """Runs the mesh engine, the port's single-device engine (same
    environment) and commet_tpu's (its plane route), or at k > 32 the
    reference oracle; all must agree. Returns the mesh run's counters."""
    got_c, got = run_engine(mesh_engine, idx_fa, qry_fas,
                            str(tmp_path / "mesh"))
    one_c, one = run_engine(
        tengine.Engine(k=k, t=T, device="cpu", batch=2048,
                       max_kmer=max_kmer), idx_fa, qry_fas,
        str(tmp_path / "one"))
    assert got == one
    assert _counters(got_c) == _counters(one_c)
    assert got_c["Q0"]["shared"] > 0
    if k > 32:  # the oracle: commet_tpu's engine peaks at 4.6 GB here
        idx_seqs, qry_seqs = (_seqs(p) for p in (idx_fa, qry_fas[0]))
        bloom = index_reads(idx_seqs, k)
        expected = np.array([search_read(bloom, q, k, T) for q in qry_seqs])
        bv = BitVector.read(str(tmp_path / "mesh" / "qry.fa_in_I.bv"))
        np.testing.assert_array_equal(bv.as_bool_array(), expected)
        assert got_c["Q0"]["shared"] == int(expected.sum())
        return got_c
    monkeypatch.setenv("COMMET_TPU_STREAM", "0")
    want_c, want = run_engine(
        jengine.Engine(k=k, t=T, batch=2048, max_kmer=max_kmer), idx_fa,
        qry_fas, str(tmp_path / "jax"))
    assert got == want
    assert _counters(got_c) == _counters(want_c)
    return got_c


@pytest.mark.parametrize("k,stream_env,poison,route", [
    (15, "force", False, "join"),
    (15, "0", False, "planes"),
    (15, "force", True, "join"),
    (33, "1", True, "join"),
])
def test_dp_engine_matches(tmp_path, monkeypatch, k, stream_env, poison,
                           route):
    """DP mode: every partition's sorted index (or plane set) replicated,
    every search batch split over the 8 shards (and the AMBIG residue
    through the DP exact probe); the route's wrapper runs on the shares."""
    monkeypatch.setenv("COMMET_TPU_STREAM", stream_env)
    idx_fa, qry_fas = _sets(tmp_path, 19 + k, k, poison=poison,
                            length=120 if k > 32 else 90)
    eng = tengine.Engine(k=k, t=T, device="cpu", batch=2048, mesh=MESH)
    assert eng.mesh_mode == "dp"
    calls = []
    for name in ("stream_search_step", "dp_probe_planes"):
        real = getattr(sharded, name)
        monkeypatch.setattr(sharded, name, lambda *a, real=real, name=name:
                            calls.append(name) or real(*a))
    _held_to_both(tmp_path, monkeypatch, k, idx_fa, qry_fas, eng)
    assert set(calls) == {"stream_search_step" if route == "join"
                          else "dp_probe_planes"}


def test_plane_mode_engine_matches(tmp_path, monkeypatch):
    """Plane mode on a multi-partition k = 15 pair (600 index reads of 110
    bp: about 15 max_kmer partitions): every partition's planes as 8 word
    shards built by the ranged build, probed by the ranged probe; no sorted
    index even with the stream forced."""
    monkeypatch.setenv("COMMET_TPU_STREAM", "force")
    k = 15
    idx_fa, qry_fas = _sets(tmp_path, 49, k, n_idx=600, n_qry=400,
                            length=110)
    eng = tengine.Engine(k=k, t=T, device="cpu", batch=2048, mesh=MESH,
                         mesh_mode="plane")
    rs = read_set("I", idx_fa)
    elig = rs.eligible()
    assert len(eng.partitions(eng.count_kmers(tengine.EncodedSet(rs),
                                              elig))) > 5
    assert not eng.serves_sorted(1)
    probes = []
    real = sharded.probe_planes_sharded
    monkeypatch.setattr(sharded, "probe_planes_sharded",
                        lambda ps, *a: probes.append(len(ps.shards))
                        or real(ps, *a))
    _held_to_both(tmp_path, monkeypatch, k, idx_fa, qry_fas, eng)
    assert probes and set(probes) == {8}


def test_mesh_engine_driver_takes_classic_rounds(tmp_path):
    """With a mesh the engine declines resident indexes and plane sets, so
    the driver's amortized schedule prints the classic-rounds line and
    returns False, as commet_tpu's does."""
    idx_fa, qry_fas = _sets(tmp_path, 3, 15)
    eng = tengine.Engine(k=15, t=T, device="cpu", mesh=MESH)
    assert eng.build_resident(read_set("I", idx_fa)) is None
    assert eng.build_resident_planes(read_set("I", idx_fa)) is None
    said = io.StringIO()
    with contextlib.redirect_stdout(said):
        done = tcommet.run_amortized_rounds(
            [[idx_fa], qry_fas], [[None], [None]], ["I", "Q"],
            str(tmp_path) + "/", 1, eng)
    assert done is False
    assert said.getvalue().startswith(
        "schedule: classic rounds (a mesh of 8 devices, dp mode")
