"""upload_pinned_share.search (metrics/upload_pinned_share.search.py)
reads the ``pinned`` bytes of the program's ``pack.upload`` spans inside a
run's units over their ``bytes``: None where any of them lacks the
attribute (a program before it), where the run has no such span (the host
route) or is not traced."""

import time
from types import SimpleNamespace

import pytest
import torch

from commet_bench import harness
from commet_tpu_torch import trace

NAME = "upload_pinned_share.search"


def _read(spans):
    """What the metric reads of a traced run of one unit in which the
    program ran ``spans``, (name, attributes) pairs, 5 ms each; and the
    run."""
    trace.clear()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            t0 = time.perf_counter()
            for name, attrs in spans:
                with trace.clocked(name, **attrs):
                    time.sleep(0.005)
            t1 = time.perf_counter()
        run = SimpleNamespace(units=[{"t0": t0, "t1": t1}],
                              trace=SimpleNamespace(
                                  ranges={"unit": [(0.0, t1 - t0)]}))
        return harness.load_module("metrics", NAME).read(run), run
    finally:
        trace.clear()


@pytest.mark.parametrize("uploads,want", [
    (({"bytes": 300, "pinned": 300}, {"bytes": 100, "pinned": 100}), 100.0),
    (({"bytes": 300, "pinned": 0}, {"bytes": 100, "pinned": 0}), 0.0),
    (({"bytes": 300, "pinned": 300}, {"bytes": 100, "pinned": 0}), 75.0),
    (({"bytes": 300}, {"bytes": 100}), None),
    (({"bytes": 300, "pinned": 300}, {"bytes": 100}), None),
    ((), None),
])
def test_upload_pinned_share_reads_the_attribute(uploads, want):
    """100 x the pack.upload spans' pinned bytes over their bytes, a
    host.pack span between them read by no one; None where any lacks
    ``pinned`` or there is none; None for a run that is not traced."""
    spans = [("pack.upload", a) for a in uploads[:1]]
    spans += [("host.pack", {"bytes": 5, "pinned": 0})]
    spans += [("pack.upload", a) for a in uploads[1:]]
    got, run = _read(spans)
    assert got == (None if want is None else pytest.approx(want))
    run.trace = None
    assert harness.load_module("metrics", NAME).read(run) is None
