"""The upload shares (metrics/upload_share.search.py, upload_share.build.py)
read the program's ``pack.upload`` spans inside a run's units: None where
the run has none (the host route, or a program without the span) or is
not traced, and the spans' seconds over the units' seconds where it has
them."""

import time
from types import SimpleNamespace

import pytest
import torch

from commet_bench import harness
from commet_tpu_torch import trace


def _run(names):
    """A traced run of one unit in which the program ran a span of each
    of ``names`` (20 ms each), and the seconds of its pack.upload spans."""
    trace.clear()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            t0 = time.perf_counter()
            for name in names:
                with trace.clocked(name, bytes=1):
                    time.sleep(0.02)
            t1 = time.perf_counter()
        spans = trace.recorded()
        run = SimpleNamespace(units=[{"t0": t0, "t1": t1}],
                              trace=SimpleNamespace(
                                  ranges={"unit": [(0.0, t1 - t0)]}))
        read = {name: harness.load_module("metrics", name).read(run)
                for name in ("upload_share.search", "upload_share.build")}
    finally:
        trace.clear()
    upload = sum((s.end_ns - s.start_ns) * 1e-9 for s in spans
                 if s.name == "pack.upload")
    return read, upload, t1 - t0, run


@pytest.mark.parametrize("names", [("host.pack",),
                                   ("pack.upload", "host.pack",
                                    "pack.upload")])
def test_upload_shares_read_the_span(names):
    read, upload, unit_s, run = _run(names)
    for value in read.values():
        if "pack.upload" not in names:
            assert value is None
        else:
            assert value == pytest.approx(100.0 * upload / unit_s)
            assert 0.0 < value < 100.0
    run.trace = None
    assert harness.load_module("metrics",
                               "upload_share.search").read(run) is None
