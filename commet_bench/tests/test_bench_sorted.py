"""The sorted-cohort cell at a size the CPU holds (k = 21, sixteen residents
of 400 reads below the fill gate): correct through the harness's own run
and check; its control (keya alone deciding membership) not correct, nor
a run with the exact fallback skipped (AMBIG read as tagged), with one
slot's verdicts dropped or with one resident's index missing a pair; a
traced run reads the program's search.exact spans and AMBIG counts; the
join's least bytes add up by resident."""

import numpy as np
import pytest

from commet_bench import harness, roofline
from commet_bench.reference import commet_ref, sorted_index
from commet_bench.tests.tiny import SEED
from commet_bench.traffic.sorted_search import (join_sectors, make_inputs,
                                                reference_index, window_keya)

CELL = "sorted-cohort"
TINY = {"config": {"k": 21, "set_reads": 400},
        "params": {"query_reads": 320}}


def run(trace=False, control=False):
    return harness.run_cell(CELL, SEED, 0.3, trace, device="cpu",
                            overrides=TINY, control=control)


def test_cell_correct_on_cpu():
    r = run()
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["checks"]) == {"tags_wrong", "counters_wrong",
                                "index_pairs_wrong"}
    assert set(r["metrics"]) == {"search_reads_per_s", "setup_s"}


def test_control_fails():
    r = run(control=True)
    assert not r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == r["attempted"]
    assert r["checks"]["tags_wrong"]["value"] > 0


def skip_fallback(monkeypatch):
    from commet_tpu_torch.engine.engine import Engine
    monkeypatch.setattr(
        Engine, "_search_stream_fallback",
        lambda self, sidx, enc, rows, geom: np.ones(len(rows), dtype=bool))
    return "tags_wrong"


def drop_first_slot(monkeypatch):
    from commet_tpu_torch.core import stream
    for name in ("probe_multi_stream_clean", "probe_multi_stream_packed"):
        real = getattr(stream, name)

        def broken(*args, real=real, **kwargs):
            out = real(*args, **kwargs).clone()
            out[0] = stream.VERDICT_UNTAGGED
            return out

        monkeypatch.setattr(stream, name, broken)
    return "tags_wrong"


def drop_a_pair(monkeypatch):
    from commet_tpu_torch.core import stream
    real, calls = stream.finalize_index, []

    def broken(ka, kb):
        sidx = real(ka, kb)
        calls.append(1)
        if len(calls) > 1:
            return sidx
        return stream.index_from_sorted_pairs(sidx.ika[1:], sidx.ikb[1:])

    monkeypatch.setattr(stream, "finalize_index", broken)
    return "index_pairs_wrong"


@pytest.mark.parametrize("fault", [skip_fallback, drop_first_slot,
                                   drop_a_pair])
def test_fault_is_caught(fault, monkeypatch):
    check = fault(monkeypatch)
    r = run()
    assert not r["correct"], r["checks"]
    assert r["checks"][check]["value"] > 0


def test_traced_run_reads_the_exact_fallback():
    r = run(trace=True)
    assert r["correct"], r["checks"]
    for name in ("exact_share.sorted", "ambig_share.sorted"):
        assert 0.0 < r["metrics"][name]["value"] <= 100.0
    # no kernel runs on the CPU, so the roofline finds nothing to read
    assert "join_probe_roofline.sorted" not in r["metrics"]


def test_join_bytes_add_up_by_resident():
    """The join's least bytes against one resident are the reads, its keya
    and keyb sectors and a tag bit a read; a second resident adds its
    sectors and a tag bit a read."""
    cfg = dict(harness.load_json(harness.HERE, "configs",
                                 "commet-k33-sorted.json"), **TINY["config"])
    k = cfg["k"]
    index, (query,) = make_inputs(cfg, {"residents": 2, "queries": 1,
                                        "query_reads": 320}, SEED)
    qa = window_keya(query, k, "cpu")
    sectors = []
    for codes in index:
        ((ika, _ikb),) = sorted_index.partition_pairs(
            codes, np.ones(len(codes), dtype=bool), k,
            commet_ref.max_kmer_for(k), "cpu")
        sectors.append(join_sectors(ika, qa))
    assert all(n > 0 for n in sectors)
    (one,) = reference_index(cfg, index[:1], [query], "cpu")[1]
    assert one == (roofline.read_bytes(query)
                   + roofline.SECTOR_BYTES * sectors[0]
                   + -(-len(query) // 8))
    (two,) = reference_index(cfg, index, [query], "cpu")[1]
    assert two == (one - -(-len(query) // 8) + -(-2 * len(query) // 8)
                   + roofline.SECTOR_BYTES * sectors[1])
