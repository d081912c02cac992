"""The partition-cohort cell at a size the CPU holds (k = 21, three
residents of one partition each): correct through the harness's own run and
check; its control (keya alone deciding membership) and faults under the
grouped probe and the build not correct; a traced run reads the program's
finish.resident spans."""

import pytest

from commet_bench import harness, roofline
from commet_bench.reference import commet_ref
from commet_bench.tests.test_bench_faults import (flip_first, half_left_out,
                                                  unchanged)
from commet_bench.tests.tiny import SEED
from commet_bench.traffic.cohort_search import cohort_probe_bytes
from commet_bench.traffic.step0_search import make_inputs

CELL = "partition-cohort"
TINY = {"config": {"k": 21, "set_reads": 2000},
        "params": {"query_reads": 600}}


def run(trace=False, control=False):
    return harness.run_cell(CELL, SEED, 0.3, trace, device="cpu",
                            overrides=TINY, control=control)


def test_cell_correct_on_cpu():
    r = run()
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["checks"]) == {"tags_wrong", "counters_wrong",
                                "plane_bits_wrong"}
    assert set(r["metrics"]) == {"search_reads_per_s", "setup_s"}


def test_control_fails():
    r = run(control=True)
    assert not r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == r["attempted"]
    assert any(c["value"] > c["limit"] for c in r["checks"].values())


@pytest.mark.parametrize("where,fault", [
    ("probe_planes_multi", flip_first),
    ("probe_planes_multi", half_left_out),
    ("build_planes", unchanged),
])
def test_fault_is_caught(where, fault, monkeypatch):
    from commet_tpu_torch.core import planes
    monkeypatch.setattr(planes, where, fault(getattr(planes, where)))
    r = run()
    assert not r["correct"], r["checks"]
    assert any(c["value"] > c["limit"] for c in r["checks"].values())


def test_traced_run_reads_the_finish_spans():
    r = run(trace=True)
    assert r["correct"], r["checks"]
    value = r["metrics"]["resident_finish_share.cohort"]["value"]
    assert 0.0 < value <= 100.0
    # no kernel runs on the CPU, so the roofline finds nothing to read
    assert "cohort_probe_roofline.cohort" not in r["metrics"]



def test_probe_bytes_add_up_by_resident():
    """The grouped probe's least bytes against one resident are
    roofline.probe_bytes against its planes; a second resident adds its
    sectors and a tag bit a read."""
    cfg = dict(harness.load_json(harness.HERE, "configs",
                                 "commet-k33-cohort.json"), **TINY["config"])
    index, (query,) = make_inputs(cfg, {"residents": 2, "queries": 1,
                                        "query_reads": 600}, SEED)
    planes = []
    for codes in index:
        planes.append(commet_ref.BytePlanes(cfg["k"], "cpu"))
        planes[-1].add(codes)
    (one,) = cohort_probe_bytes(cfg, index[:1], [query], "cpu")
    assert one == roofline.probe_bytes(planes[0], query, cfg["t"])
    (two,) = cohort_probe_bytes(cfg, index, [query], "cpu")
    tag_bytes = [-(-s * len(query) // 8) for s in (1, 2)]
    assert two == (one - tag_bytes[0] + tag_bytes[1] + roofline.SECTOR_BYTES
                   * roofline.probe_sectors(planes[1], query, cfg["t"]))
