"""commet_tpu's engine switches in the port (engine/engine.py), each against
commet_tpu's engine under the same environment on the same numpy-seeded
fasta sets (less COMMET_TPU_PROFILE: the port's trace is what is tested):
identical .bv bytes and .log counter lines. COMMET_TPU_PROFILE writes one
Chrome trace per public Engine call; COMMET_TPU_PREFETCH=0 makes no
thread; COMMET_TPU_STREAM_BATCH, COMMET_TPU_PROBE_BATCH and
COMMET_TPU_BUILD_BATCH set the reads per batch of their path; a value that
is not an integer raises ValueError. Also the smoke's count of the plane
probe's loads (chip_smoke._probe_loads) against a count made read by read."""

import glob
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import commet_tpu.engine.engine as jengine
from commet_tpu_torch.core import keys, planes
from commet_tpu_torch.engine import engine as tengine
from torch_helpers import make_fastas, run_amortized, run_engine

T = 2
K = 21
BATCH_SWITCHES = ("COMMET_TPU_STREAM_BATCH", "COMMET_TPU_PROBE_BATCH",
                  "COMMET_TPU_BUILD_BATCH")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax(monkeypatch, tmp_path, idx_fa, qry_fas):
    """commet_tpu's engine on the sets under the test's environment, less
    COMMET_TPU_PROFILE; the self-check cache emptied for a forced stream."""
    with monkeypatch.context() as m:
        m.delenv("COMMET_TPU_PROFILE", raising=False)
        m.setattr(jengine, "_STREAM_SELFCHECK", {})
        return run_engine(jengine.Engine(k=K, t=T, batch=2048), idx_fa,
                          qry_fas, str(tmp_path / "jax"))


def _batches(monkeypatch, eng):
    """Record the reads of every host batch ``eng`` makes."""
    seen = []
    real = eng._host_batch

    def spy(enc, idx, lpad):
        seen.append(len(idx))
        return real(enc, idx, lpad)

    monkeypatch.setattr(eng, "_host_batch", spy)
    return seen


PROFILED = {"index_and_search": ["index_and_search"],
            "amortized": ["build_resident", "build_resident_planes",
                          "search_multi_set", "search_multi_set_planes"]}


def _profiled_calls(monkeypatch, calls, idx_fa, qry_fas, out):
    """The outputs of ``calls`` and the engine that made them:
    index_and_search, or the resident planes and then the sorted resident
    (build_resident*, search_multi_set*) under COMMET_TPU_STREAM=0 and
    =force."""
    if calls == "index_and_search":
        eng = tengine.Engine(k=K, t=T, device="cpu")
        _c, got = run_engine(eng, idx_fa, qry_fas, out)
        return [got], eng
    got = []
    for stream_mode, planes_route in (("0", True), ("force", False)):
        monkeypatch.setenv("COMMET_TPU_STREAM", stream_mode)
        eng = tengine.Engine(k=K, t=T, device="cpu")
        got.append(run_amortized(eng, idx_fa, qry_fas,
                                 f"{out}_{stream_mode}", planes_route))
    return got, eng


@pytest.mark.parametrize("calls", ["index_and_search", "amortized"])
def test_profile_writes_one_trace_per_call(tmp_path, monkeypatch, calls):
    """COMMET_TPU_PROFILE=<dir>: each public Engine call writes a Chrome
    trace of its own into <dir> (a second call adds a file) that holds the
    engine's spans, the call's on its own thread and the host packs, each
    naming that call, on the prefetch thread's row, the bytes and counter
    lines staying commet_tpu's; the amortized calls are
    build_resident(_planes) and search_multi_set(_planes)."""
    monkeypatch.setenv("COMMET_TPU_STREAM", "0")
    idx_fa, qry_fas, _ = make_fastas(tmp_path, 91, K, 0.02)
    _c, want = _jax(monkeypatch, tmp_path, idx_fa, qry_fas)
    trace_dir = tmp_path / "traces"
    monkeypatch.setenv("COMMET_TPU_PROFILE", str(trace_dir))
    got, eng = _profiled_calls(monkeypatch, calls, idx_fa, qry_fas,
                               str(tmp_path / "torch"))
    assert got == [want] * len(got)
    traces = glob.glob(str(trace_dir / "*.json"))
    assert eng.last_trace in traces
    called = []
    for path in traces:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        assert any(e.get("ph") == "X" and "aten::" in e.get("name", "")
                   for e in events)
        (call,) = [e for e in events if e.get("cat") == "user_annotation"
                   and e["name"].startswith("call.")]
        called.append(call["name"][len("call."):])
        assert os.path.basename(path).startswith(called[-1] + "_")
        packs = [e for e in events if e.get("cat") == "program"
                 and e["name"] == "host.pack"]
        assert packs and all(e["tid"] != call["tid"] for e in packs)
        assert all(e["args"]["parent"] == call["name"] for e in packs)
    assert sorted(called) == PROFILED[calls]
    if calls == "index_and_search":
        _c, again = run_engine(eng, idx_fa, qry_fas, str(tmp_path / "two"))
        assert again == want
        assert len(glob.glob(str(trace_dir / "*.json"))) == 2
        assert eng.last_trace not in traces


def test_prefetch_off_makes_no_thread(tmp_path, monkeypatch):
    """COMMET_TPU_PREFETCH=0: every host batch is made inline (a thread pool
    would raise), over several batches of the build and the probe, with
    commet_tpu's bytes and the same last_io_stats keys as with prefetch
    (none of the reads packed on a device, on the CPU)."""
    monkeypatch.setenv("COMMET_TPU_STREAM", "0")
    monkeypatch.setenv("COMMET_TPU_PREFETCH", "0")
    idx_fa, qry_fas, _ = make_fastas(tmp_path, 92, K, 0.02)
    _c, want = _jax(monkeypatch, tmp_path, idx_fa, qry_fas)

    def no_thread(*args, **kwargs):
        raise AssertionError("a prefetch thread was made")

    monkeypatch.setattr(tengine, "ThreadPoolExecutor", no_thread)
    monkeypatch.setattr(tengine, "STREAM_BATCH", 40)
    eng = tengine.Engine(k=K, t=T, device="cpu")
    assert not eng.prefetch
    seen = _batches(monkeypatch, eng)
    _c, got = run_engine(eng, idx_fa, qry_fas, str(tmp_path / "torch"))
    assert got == want
    assert len(seen) > 4 and max(seen) == 40
    assert set(eng.last_io_stats) == {"wall_s", "host_pack_s",
                                      "host_block_s", "upload_s",
                                      "device_packed", "fetch_s"}
    assert eng.last_io_stats["host_block_s"] >= 0.0
    assert eng.last_io_stats["device_packed"] == 0


@pytest.mark.parametrize("switch,stream_mode", [
    ("COMMET_TPU_STREAM_BATCH", "force"),
    ("COMMET_TPU_PROBE_BATCH", "0"),
    ("COMMET_TPU_BUILD_BATCH", "0"),
])
def test_batch_switch_sets_its_paths_batches(tmp_path, monkeypatch, switch,
                                             stream_mode):
    """Each batch switch at 40 reads cuts its own path's batches (the
    stream probe, the plane probe, the plane build; with the switch unset
    the 120 index and 150 query reads take one batch each) and leaves the
    other path's alone, with commet_tpu's bytes and counter lines under the
    same environment. The build switch also cuts the sorted index's
    build."""
    monkeypatch.setenv("COMMET_TPU_STREAM", stream_mode)
    monkeypatch.setenv(switch, "40")
    idx_fa, qry_fas, _ = make_fastas(tmp_path, 93, K, 0.02)
    _c, want = _jax(monkeypatch, tmp_path, idx_fa, qry_fas)
    eng = tengine.Engine(k=K, t=T, device="cpu")
    seen = _batches(monkeypatch, eng)
    _c, got = run_engine(eng, idx_fa, qry_fas, str(tmp_path / "torch"))
    assert got == want
    built, searched = (seen[:3], seen[3:]) if switch.endswith(
        "BUILD_BATCH") else (seen[:1], seen[1:])
    assert built == ([40, 40, 40] if switch.endswith("BUILD_BATCH")
                     else [120])
    assert searched == ([150] if switch.endswith("BUILD_BATCH")
                        else [40, 40, 40, 30])
    if switch.endswith("BUILD_BATCH"):
        monkeypatch.setenv("COMMET_TPU_STREAM", "force")
        eng = tengine.Engine(k=K, t=T, device="cpu")
        seen = _batches(monkeypatch, eng)
        _c, got = run_engine(eng, idx_fa, qry_fas, str(tmp_path / "sorted"))
        assert got == want
        assert seen[:3] == [40, 40, 40] and seen[3:] == [150]


def _smoke():
    """chip_smoke.py as a module (its top level imports numpy alone)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _brute_loads(pl, wk, k, t, v):
    """(A loads, B/C/D loads, skippable B/C/D loads, A hits), read by read
    and window by window in Python from the plane words ``pl``."""
    words = [int(x) & 0xFFFFFFFF for x in pl.tolist()]
    pw = planes.plane_words(k)
    ok = wk["ok"].tolist()
    n_a = n_bcd = skip = a_hits = 0

    def bit(p, key):
        return (words[p * pw + (key >> 5)] >> (key & 31)) & 1

    for r in range(len(ok)):
        count = 0
        for s in ("f", "r"):
            a, b = wk[s + "a"][r].tolist(), wk[s + "b"][r].tolist()
            win = [w for w in range(len(ok[r])) if ok[r][w]]
            hits = [w for w in win if bit(0, a[w])]
            a_hits += len(hits)
            if count >= t:  # the forward strand tagged the read
                continue
            inner = set(hits[v:len(hits) - v])
            count, allow = 0, 0
            for w in win:
                if count >= t or w < allow:
                    continue
                n_a += 1
                if not bit(0, a[w]):
                    continue
                n_bcd += 3
                skip += 3 if w in inner else 0
                if (bit(1, b[w]) and bit(2, a[w] ^ b[w])
                        and bit(3, a[w] | b[w])):
                    count += 1
                    allow = w + k
    return n_a, n_bcd, skip, a_hits


def test_smoke_probe_load_count_matches_brute_force():
    """chip_smoke._probe_loads' A, B/C/D and skippable B/C/D loads (those a
    cascade verifying the V leftmost and rightmost A hits of a strand could
    skip) and A hits at k = 15, V = 8, on planes dense enough that strands
    have more than 2V A hits, equal a count made read by read, strand by
    strand, and window by window."""
    smoke = _smoke()
    k, length, n, n_idx = 15, 128, 300, 200
    rng = np.random.default_rng(15)
    idx = rng.integers(0, 4, (n_idx, length)).astype(np.uint8)
    qry = rng.integers(0, 4, (n, length)).astype(np.uint8)
    qry[::3, 10:10 + 2 * k] = idx[:n // 3, 40:40 + 2 * k]
    pl = planes.alloc_planes(k, "cpu")
    lens = torch.full((n_idx,), 100, dtype=torch.int32)
    planes.build_planes(pl, torch.from_numpy(smoke._pack_codes(idx).view(
        np.int32)), lens, True, length, k)
    qc2 = torch.from_numpy(smoke._pack_codes(qry).view(np.int32))
    qlens = torch.full((n,), 100, dtype=torch.int32)
    wmax = 100 - k + 1
    got = smoke._probe_loads(pl, qc2, qlens, length, k, T, wmax, v=8)
    wk = keys.window_keys(keys.unpack_codes_clean(qc2, qlens, length), k,
                          "both", wmax)
    want = _brute_loads(pl, wk, k, T, 8)
    assert (got["a"], got["bcd"], got["skippable"], got["a_hits"]) == want
    assert got["addrs"].numel() == got["a"] + got["bcd"]
    assert want[2] > 0 and want[3] > 2 * 8 * 2 * n  # > 2V A hits a strand


@pytest.mark.parametrize("switch", BATCH_SWITCHES)
def test_batch_switch_not_an_integer_raises(monkeypatch, switch):
    """A batch switch that int() cannot read raises ValueError when the
    engine is made, as commet_tpu's int(...) does; so does one below 1."""
    for value in ("64k", "2.5", "0"):
        monkeypatch.setenv(switch, value)
        with pytest.raises(ValueError):
            tengine.Engine(k=K, t=T, device="cpu")
    monkeypatch.setenv(switch, " 4096 ")
    eng = tengine.Engine(k=K, t=T, device="cpu")
    assert {"COMMET_TPU_STREAM_BATCH": eng.stream_batch,
            "COMMET_TPU_PROBE_BATCH": eng.probe_batch,
            "COMMET_TPU_BUILD_BATCH": eng.build_batch}[switch] == 4096
