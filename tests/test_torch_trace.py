"""The port's spans (commet_tpu_torch/trace.py) in its engine, with the
prefetch thread and inline (COMMET_TPU_PREFETCH=0): nothing recorded and
the shared no-op span while no profiler runs, the same .bv bytes and .log
counter lines under torch.profiler; each host.pack span under the call
that asked for the batch, its reads adding up to the reads packed;
host.wait adding up to last_io_stats' host_block_s. The spans of a thread
the profiler does not follow share its clock: on the CPU beside a
record_function (1 ms), and on the card around a kernel (50 us). The file imports no JAX, so on a machine without it the card's
test runs on its own:

    python -m pytest --noconftest -p no:cacheprovider -m gpu -s \\
        tests/test_torch_trace.py
"""

import json
import threading

import pytest
import torch

from commet_tpu_torch import trace
from commet_tpu_torch.engine import engine as tengine
from torch_helpers import make_fastas, read_set, run_amortized, run_engine

K = 21
T = 2
CALLS = ("call.build_resident_planes", "call.search_multi_set_planes")


@pytest.fixture(params=[True, False], ids=["prefetch", "inline"])
def prefetch(request, monkeypatch):
    """Plane routes, batches of 40 reads, the prefetch thread on or off."""
    monkeypatch.setenv("COMMET_TPU_STREAM", "0")
    monkeypatch.setenv("COMMET_TPU_PREFETCH", "1" if request.param else "0")
    monkeypatch.setattr(tengine, "STREAM_BATCH", 40)
    return request.param


def _recorded(fn, activities=(torch.profiler.ProfilerActivity.CPU,)):
    """``fn()``'s result, the spans recorded while it ran under
    torch.profiler, and the profiler."""
    trace.clear()
    try:
        with torch.profiler.profile(activities=list(activities)) as prof:
            out = fn()
    finally:
        spans = trace.recorded()
        trace.clear()
    return out, spans, prof


def test_off_records_nothing_and_on_changes_no_output(tmp_path, monkeypatch,
                                                      prefetch):
    """Recording off: one shared no-op span, and no span is made through a
    pairwise and an amortized run; on: the same .bv bytes and counter
    lines, and every span the engine has."""
    idx_fa, qry_fas, _ = make_fastas(tmp_path, 94, K, 0.02)
    eng = tengine.Engine(k=K, t=T, device="cpu")

    def both(out):
        _c, pair = run_engine(eng, idx_fa, qry_fas, str(tmp_path / out))
        return pair, run_amortized(eng, idx_fa, qry_fas,
                                   str(tmp_path / (out + "_multi")))

    assert trace.span("a") is trace.span("b") is trace.OFF

    def no_span():
        raise AssertionError("a span was opened for a recording")

    with monkeypatch.context() as m:
        m.setattr(trace, "_thread", no_span)
        off = both("off")
    on, spans, _prof = _recorded(lambda: both("on"))
    assert on == off and off[0] == off[1]
    assert {s.name for s in spans} == {
        "call.index_and_search", *CALLS, "io.write",
        "build.count", "build.partition", "host.pack", "host.gather",
        "host.wait", "search.select", "search.fetch", "search.finish"}
    assert trace.span("c") is trace.OFF


def test_pack_spans_name_their_call(tmp_path, prefetch):
    """Each host.pack runs under the public call that asked for its batch
    (on the prefetch thread, or inline on the caller's), its reads add up
    to the reads built or searched, and each call's host.wait and
    host.pack spans add up to its last_io_stats."""
    idx_fa, (qry_fa,), _ = make_fastas(tmp_path, 95, K, 0.02)
    eng = tengine.Engine(k=K, t=T, device="cpu")
    index_set, query = read_set("I", idx_fa), read_set("Q0", qry_fa)
    stats = {}

    def calls():
        resident = eng.build_resident_planes(index_set)
        stats[CALLS[0]] = dict(eng.last_io_stats)
        eng.search_multi_set_planes(query, [resident])
        stats[CALLS[1]] = dict(eng.last_io_stats)

    _out, spans, _prof = _recorded(calls)
    call_ids = {s.name: s.id for s in spans if s.name in CALLS}
    assert set(call_ids) == set(CALLS)
    packs = [s for s in spans if s.name == "host.pack"]
    assert {s.parent for s in packs} == set(call_ids.values())
    me = threading.get_native_id()
    assert all((s.thread != me) == prefetch for s in packs)
    want_reads = {CALLS[0]: len(index_set.eligible()),
                  CALLS[1]: len(query.untagged_eligible())}
    for name, cid in call_ids.items():
        mine = [s for s in packs if s.parent == cid]
        assert len(mine) > 2
        assert sum(s.attrs["reads"] for s in mine) == want_reads[name]
        for span, key in (("host.wait", "host_block_s"),
                          ("host.pack", "host_pack_s")):
            got = sum((s.end_ns - s.start_ns) * 1e-9 for s in spans
                      if s.name == span and s.parent == cid)
            assert got == pytest.approx(stats[name][key], rel=1e-9,
                                        abs=1e-12)
    assert stats[CALLS[0]]["fetch_s"] == 0.0


def _exported(tmp_path, prof, spans):
    """The Chrome trace ``prof`` exported, with ``spans`` added."""
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    trace.to_chrome(path, spans)
    with open(path) as f:
        return json.load(f)


def _on_a_thread(fn):
    """``fn()`` run on a thread of its own, which the profiler does not
    follow, as the prefetch thread."""
    out = []
    worker = threading.Thread(target=lambda: out.append(fn()))
    worker.start()
    worker.join()
    return out[0]


def test_spans_share_the_profiler_clock(tmp_path):
    """A span on the profiler's thread is its record_function range, once,
    and its Unix stamp lands within 1 ms of that range on the exported
    trace's clock; a span on a thread the profiler does not follow is added
    on that thread's row, between the ranges opened before and after it,
    within 1 ms."""

    def elsewhere():
        with trace.span("clock.program"):
            pass
        return threading.get_native_id()

    def in_turn():
        with torch.profiler.record_function("clock.warm"):
            pass
        with torch.profiler.record_function("clock.before"):
            pass
        with trace.span("clock.here"):
            pass
        tid = _on_a_thread(elsewhere)
        with torch.profiler.record_function("clock.after"):
            pass
        return tid

    tid, spans, prof = _recorded(in_turn)
    doc = _exported(tmp_path, prof, spans)
    events = {}
    for e in doc["traceEvents"]:
        if e.get("ph") == "X" and e["name"].startswith("clock."):
            assert e["name"] not in events
            events[e["name"]] = e
    here, program = events["clock.here"], events["clock.program"]
    before, after = events["clock.before"], events["clock.after"]
    assert here["cat"] == "user_annotation"
    (stamped,) = [s for s in spans if s.name == "clock.here"]
    lag = (stamped.start_ns - doc["baseTimeNanoseconds"]) / 1e3 - here["ts"]
    assert 0 <= lag < 1000.0
    assert program["cat"] == "program" and program["tid"] == tid
    assert after["tid"] == threading.get_native_id() != tid
    assert program["ts"] > before["ts"] + before["dur"] - 1000.0
    assert program["ts"] + program["dur"] < after["ts"] + 1000.0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the test times the card's kernels")
    return torch.device("cuda")


@pytest.mark.gpu
def test_kernel_lies_inside_its_span_on_the_card(tmp_path, cuda_device):
    """A kernel launched and synchronised inside a span, on a thread the
    profiler does not follow, lies inside the span on the trace's clock,
    within 50 us at either end (the profiler's first launch made before the
    span); prints the two margins."""
    x = torch.ones(1 << 26, device=cuda_device)
    (x * 2).sum().item()

    def launch():
        with trace.span("clock.kernel"):
            y = x * 2
            torch.cuda.synchronize(cuda_device)
        return y

    def profiled():
        x.add_(0)
        torch.cuda.synchronize(cuda_device)
        return _on_a_thread(launch)

    acts = (torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA)
    _y, spans, prof = _recorded(profiled, acts)
    events = _exported(tmp_path, prof, spans)["traceEvents"]
    (sp,) = [e for e in events if e.get("name") == "clock.kernel"]
    assert sp["cat"] == "program"
    kernels = [e for e in events if e.get("cat") == "kernel"
               and e["ts"] + e["dur"] > sp["ts"] - 50.0]
    assert kernels
    lead = min(k["ts"] for k in kernels) - sp["ts"]
    trail = sp["ts"] + sp["dur"] - max(k["ts"] + k["dur"] for k in kernels)
    print(f"kernel inside its span: {lead:.3f} us after its start, "
          f"{trail:.3f} us before its end ({len(kernels)} kernels, span "
          f"{sp['dur']:.3f} us, {torch.cuda.get_device_name(cuda_device)})")
    assert lead > -50.0 and trail > -50.0
