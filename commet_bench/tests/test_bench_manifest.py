"""Every configuration, cell, traffic kind and metric named in
BENCHMARK.json is a file of its own under commet_bench/ and loads by its
name; the result line has the contract's keys."""

import json
import os

import pytest

from commet_bench import harness
from commet_bench.tests.tiny import SEED, TINY


def bench():
    return harness.load_json(harness.ROOT, "BENCHMARK.json")


def test_configs_and_cells_load_by_name():
    b = bench()
    configs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        cfg = harness.load_json(harness.ROOT, c["file"])
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
    for w in b["workloads"]:
        spec = harness.load_json(harness.HERE, "workloads",
                                 w["name"] + ".json")
        assert spec["config"] == w["config"] and w["config"] in configs
        mod = harness.load_module("traffic", spec["traffic"])
        for name in ("Traffic", "make_inputs"):
            assert hasattr(mod, name)


def test_metrics_load_by_name():
    b = bench()
    for section, kind in (("end_to_end", "end_to_end"),
                          ("per_layer", "metrics")):
        for m in b[section]:
            assert callable(harness.load_module(kind, m["name"]).read)


def test_every_cell_reports_its_metrics():
    b = bench()
    for w in b["workloads"]:
        e2e = {m["name"] for m in harness.cell_metrics(b, w["name"],
                                                       "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.cell_metrics(b, w["name"], "per_layer")


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys(trace):
    r = harness.run_cell("partition-search", SEED, 0.2, trace,
                         device="cpu", overrides=TINY["partition-search"])
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device",
                       "checks"]
    assert set(r["device"]) == {"platform", "kind", "count",
                                "memory_peak_bytes"}
    json.dumps(r)
    assert all(set(c) == {"value", "limit"} for c in r["checks"].values())
    for m in r["metrics"].values():
        assert set(m) == {"value", "unit"}


def test_run_py_exits_without_a_card(monkeypatch, capsys):
    monkeypatch.syspath_prepend(harness.HERE)
    import run
    for key in run.CACHES:
        monkeypatch.setenv(key, "unset")
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    rc = run.main(["--workload", "partition-search", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc == 2 and capsys.readouterr().out == ""
    assert os.environ["TRITON_CACHE_DIR"].startswith(harness.ROOT)
