"""The port's engine on its dense-plane route against commet_tpu's engine on
its planes (COMMET_TPU_STREAM=0 for both; the port's kernels run their plain
PyTorch versions): index_and_search, the resident plane sets and
search_multi_set_planes (also against the pairwise path and on JAX plane
sets carried across), the fill gate that routes each partition, and the
refusals of build_resident(_planes). .bv bytes, [indexed, searched, shared]
lines and counters must be identical."""

import glob
import os

import numpy as np
import pytest

import commet_tpu.engine.engine as jengine
from commet_tpu_torch import state
from commet_tpu_torch.core import planes
from commet_tpu_torch.engine import engine as tengine
from commet_tpu_torch.io.bv import BitVector
from commet_tpu_torch.io.reads import ReadSet
from torch_helpers import (file_bytes, last_line, long_seq, make_fastas,
                           multi_sets, read_set, run_engine, write_fasta)

T = 2
COUNTERS = ("indexed", "searched", "shared")


def _routes(monkeypatch, eng):
    """Record the route each partition build of ``eng`` takes."""
    seen = []
    for name, route in (("_build_index", "sorted"),
                        ("_build_planes", "planes")):
        real = getattr(eng, name)

        def spy(*args, _real=real, _route=route):
            seen.append(_route)
            return _real(*args)

        monkeypatch.setattr(eng, name, spy)
    return seen


@pytest.mark.parametrize(
    "k,n_frac,max_kmer,n_queries,stream_batch", [
        (15, 0.0, 1500, 2, 65536),  # several partitions, dropped reads
        (21, 0.02, None, 1, 40),    # dirty reads, several batches
        (11, 0.0, None, 1, 65536),  # dense: most plane bits set
    ])
def test_engine_planes_match_jax(tmp_path, monkeypatch, k, n_frac, max_kmer,
                                 n_queries, stream_batch):
    monkeypatch.setenv("COMMET_TPU_STREAM", "0")
    idx_fa, qry_fas, _ = make_fastas(tmp_path, 700 + k, k, n_frac,
                                     n_queries=n_queries)
    want_c, want = run_engine(jengine.Engine(k=k, t=T, batch=2048,
                                             max_kmer=max_kmer),
                              idx_fa, qry_fas, str(tmp_path / "jax"))
    monkeypatch.setattr(tengine, "STREAM_BATCH", stream_batch)
    eng = tengine.Engine(k=k, t=T, device="cpu", max_kmer=max_kmer)
    routes = _routes(monkeypatch, eng)
    got_c, got = run_engine(eng, idx_fa, qry_fas, str(tmp_path / "torch"))
    assert got == want
    assert routes and set(routes) == {"planes"}
    for name, c in want_c.items():
        for field in COUNTERS:
            assert got_c[name][field] == c[field]
        assert c["shared"] > 0
    if max_kmer is not None:
        assert len(routes) > 2


def test_gate_routes_each_partition(tmp_path, monkeypatch):
    """Partitions above the fill gate take the planes and those at or below
    it the sorted index, decided per partition before it is built (here the
    gate sits between the full partitions' fill and the last one's);
    COMMET_TPU_STREAM=force and =0 send every partition one way. The bytes
    and counter lines are the same on every route, and equal JAX's."""
    k, max_kmer = 15, 1200
    idx_fa, qry_fas, _ = make_fastas(tmp_path, 31, k, 0.01)
    rs = read_set("I", idx_fa)
    eng = tengine.Engine(k=k, t=T, device="cpu", max_kmer=max_kmer)
    elig = rs.eligible()
    kc = eng.count_kmers(tengine.EncodedSet(rs), elig)
    fills = [kc[p].sum() / 2.0 ** k for p in eng.partitions(kc)]
    assert len(fills) > 2 and fills[-1] < min(fills[:-1])
    gate = (fills[-1] + min(fills[:-1])) / 2
    monkeypatch.setenv("COMMET_TPU_STREAM_MAX_FILL", str(gate))
    outs = {}
    for mode, want_routes in (
            ("1", ["planes"] * (len(fills) - 1) + ["sorted"]),
            ("force", ["sorted"] * len(fills)),
            ("0", ["planes"] * len(fills))):
        monkeypatch.setenv("COMMET_TPU_STREAM", mode)
        eng = tengine.Engine(k=k, t=T, device="cpu", max_kmer=max_kmer)
        routes = _routes(monkeypatch, eng)
        _c, outs[mode] = run_engine(eng, idx_fa, qry_fas,
                                    str(tmp_path / f"m{mode}"))
        assert routes == want_routes, mode
    monkeypatch.setenv("COMMET_TPU_STREAM", "0")
    _c, want = run_engine(jengine.Engine(k=k, t=T, batch=2048,
                                         max_kmer=max_kmer),
                          idx_fa, qry_fas, str(tmp_path / "jax"))
    assert outs["1"] == outs["force"] == outs["0"] == want
    # the default gate: fill 0.02 itself still takes the sorted index
    monkeypatch.delenv("COMMET_TPU_STREAM_MAX_FILL")
    monkeypatch.setenv("COMMET_TPU_STREAM", "1")
    eng = tengine.Engine(k=k, t=T, device="cpu")
    assert eng.stream_max_fill == tengine.STREAM_MAX_FILL == 0.02
    edge = int(0.02 * 2 ** k)
    assert eng.serves_sorted(edge) and not eng.serves_sorted(edge + 1)


def _resident_outputs(out, names, qpath):
    return {n: (file_bytes([os.path.join(
        out, os.path.basename(qpath) + "_in_" + n + ".bv")]),
        last_line(os.path.join(out, f"Q_in_{n}.log"))) for n in names}


@pytest.mark.parametrize("max_kmer", [None, 900])
def test_search_multi_set_planes_matches_jax(tmp_path, monkeypatch,
                                             max_kmer):
    """Port resident planes = JAX resident planes = JAX plane sets carried
    across (resident_planes_from_jax) = the port's pairwise plane path:
    counters, .bv bytes and log counter lines, with several partitions per
    resident."""
    monkeypatch.setenv("COMMET_TPU_STREAM", "0")
    k = 15
    idx_paths, qpath = multi_sets(tmp_path, 93, k)
    names = [f"I{s}" for s in range(len(idx_paths))]
    jeng = jengine.Engine(k=k, t=T, batch=64, max_kmer=max_kmer)
    jres = [jeng.build_resident_planes(read_set(n, p, engine=jeng))
            for n, p in zip(names, idx_paths)]
    teng = tengine.Engine(k=k, t=T, device="cpu", max_kmer=max_kmer)
    tres = [teng.build_resident_planes(read_set(n, p))
            for n, p in zip(names, idx_paths)]
    if max_kmer is not None:
        assert all(len(r.partitions) > 1 for r in tres)
    for r, jr in zip(tres, jres):
        assert (r.nb_indexed, r.total_kmers, r.fills) == (
            jr.nb_indexed, jr.total_kmers, jr.fills)
        assert r.device_bytes() == jr.device_bytes()
    carried = [state.resident_planes_from_jax(r) for r in jres]
    results = {}
    for name, eng, residents in (("jax", jeng, jres), ("torch", teng, tres),
                                 ("carried", teng, carried)):
        out = str(tmp_path / name)
        os.makedirs(out)
        c = eng.search_multi_set_planes(read_set("Q", qpath, engine=eng),
                                        residents, out_dir=out, log_dir=out)
        results[name] = ({n: [c[n][f] for f in COUNTERS] for n in names},
                         _resident_outputs(out, names, qpath))
    pout = str(tmp_path / "pair")
    os.makedirs(pout)
    pair = {}
    for n, p in zip(names, idx_paths):
        c = teng.index_and_search(read_set(n, p), [read_set("Q", qpath)],
                                  out_dir=pout, log_dir=pout)["Q"]
        pair[n] = [c[f] for f in COUNTERS]
    assert results["torch"] == results["jax"] == results["carried"]
    assert results["torch"] == (pair, _resident_outputs(pout, names, qpath))
    assert pair["I0"][2] > 0 and pair["I2"][2] > 0


def test_search_multi_set_planes_edge_residents(tmp_path, monkeypatch):
    """A resident without eligible reads (no partitions), one whose last
    partition holds only reads shorter than k (empty planes), and a plain
    one, probed in one-slot groups and in one group: the pairwise bytes and
    counters."""
    monkeypatch.setenv("COMMET_TPU_STREAM", "0")
    k = 15
    idx_paths, qpath = multi_sets(tmp_path, 8, k, n_sets=2)
    rng = np.random.default_rng(12)
    write_fasta(tmp_path / "tail.fa", [long_seq(rng, 60) for _ in range(12)]
                + [long_seq(rng, 10) for _ in range(4)])
    none = tmp_path / "none.bv"
    with open(qpath, "rb") as f:
        BitVector(f.read().count(b">")).write(str(none))

    def sets():
        empty = ReadSet("NONE")
        empty.add_file(qpath, str(none))
        return [read_set("I0", idx_paths[0]),
                read_set("TAIL", str(tmp_path / "tail.fa")), empty]

    eng = tengine.Engine(k=k, t=T, device="cpu", max_kmer=500)
    residents = [eng.build_resident_planes(rs) for rs in sets()]
    assert int(residents[1].partitions[-1].count_nonzero()) == 0
    assert residents[2].partitions == []
    names = ["I0", "TAIL", "NONE"]
    got = {}
    for slots in (1, 32):
        out = str(tmp_path / f"s{slots}")
        os.makedirs(out)
        c = eng.search_multi_set_planes(read_set("Q", qpath), residents,
                                        out_dir=out, log_dir=out,
                                        max_slots=slots)
        got[slots] = ({n: [c[n][f] for f in COUNTERS] for n in names},
                      file_bytes(glob.glob(out + "/*.bv")))
    pout = str(tmp_path / "pair")
    os.makedirs(pout)
    pair = {}
    for rs in sets():
        c = eng.index_and_search(rs, [read_set("Q", qpath)], out_dir=pout,
                                 log_dir=pout)["Q"]
        pair[rs.name] = [c[f] for f in COUNTERS]
    assert got[1][0] == got[32][0] == pair
    assert _resident_outputs(str(tmp_path / "s1"), names, qpath) == \
        _resident_outputs(pout, names, qpath)
    assert got[1][1] == got[32][1]
    assert pair["NONE"] == [0, 0, 0]


def test_resident_refusals(tmp_path, monkeypatch):
    """build_resident refuses a set above the fill gate (not under force);
    build_resident_planes refuses one over its budget before it allocates;
    a resident plane set holds plane_bytes(k) per partition."""
    k = 15
    idx_paths, _q = multi_sets(tmp_path, 3, k, n_sets=1)
    rs = read_set("I0", idx_paths[0])
    eng = tengine.Engine(k=k, t=T, device="cpu")
    assert eng.build_resident(rs) is None  # about 9% fill
    monkeypatch.setenv("COMMET_TPU_STREAM", "force")
    assert tengine.Engine(k=k, t=T, device="cpu").build_resident(rs) \
        is not None
    monkeypatch.setattr(eng, "_build_planes", None)  # must not be reached
    assert eng.build_resident_planes(rs, budget=10.0) is None
    monkeypatch.undo()
    eng = tengine.Engine(k=k, t=T, device="cpu", max_kmer=700)
    r = eng.build_resident_planes(rs)
    assert r is not None and r.nb_indexed < 50 and len(r.partitions) > 2
    assert r.device_bytes() == len(r.partitions) * planes.plane_bytes(k)
    assert r.fills == [f for f in r.fills if 0 < f <= 800 / 2 ** k]
