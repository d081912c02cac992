"""A traced run of each cell reads the program's spans: every per-layer
metric that reads them gives a share in [0, 100] (the pin shares nothing on
the CPU, where nothing is pinned), and an untraced run's result line keeps
its keys and its metrics."""

import pytest

from commet_bench import harness
from commet_bench.tests.tiny import CELLS, SEED, TINY

SPAN_METRICS = {
    "partition-search": ["pack_share.search", "pin_share.search",
                         "outside_loop_share.search"],
    "partition-build": ["plan_share.build", "host_block_share.build",
                        "pin_share.build"],
}


@pytest.mark.parametrize("cell", CELLS)
def test_span_metrics_read_the_program(cell):
    r = harness.run_cell(cell, SEED, 0.2, True, device="cpu",
                         overrides=TINY[cell])
    assert r["correct"], r["checks"]
    for name in SPAN_METRICS[cell]:
        if name.startswith("pin_share."):
            assert name not in r["metrics"]
            continue
        value = r["metrics"][name]["value"]
        assert 0.0 < value <= 100.0, (name, value)
    plain = harness.run_cell(cell, SEED, 0.2, False, device="cpu",
                             overrides=TINY[cell])
    assert list(plain) == ["correct", "attempted", "failed", "metrics",
                           "device", "checks"]
    bench = harness.load_json(harness.ROOT, "BENCHMARK.json")
    assert set(plain["metrics"]) == {
        m["name"] for m in harness.cell_metrics(bench, cell, "end_to_end")}
