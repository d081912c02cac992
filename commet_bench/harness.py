"""One run of one cell: set-up, a warm-up unit, the measured window of
units back to back, the comparison with the plain reference, and the
result line.

Everything that belongs to one cell, configuration, traffic kind or metric
is a file of its own, found by its name: ``workloads/<cell>.json``,
``configs/<configuration>.json``, ``traffic/<kind>.py``,
``end_to_end/<metric>.py`` and ``metrics/<metric>.py``. Which metrics a cell
reports is read from ``BENCHMARK.json``.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time
import traceback
from types import SimpleNamespace

import torch

from commet_bench.tracing import Spans, Trace, wrap_program

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level modules that may not be loaded in a run: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "commet_tpu")


class NoCard(RuntimeError):
    """The cell asks for more CUDA cards than the machine has."""


class Forbidden(RuntimeError):
    """JAX or the JAX package was loaded in the run's process."""


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` under the benchmark's folder, as a module."""
    path = os.path.join(HERE, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"commet_bench.{kind}.{name.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def merge(base: dict, extra: dict) -> dict:
    out = dict(base)
    out.update(extra or {})
    return out


def cell_metrics(bench: dict, cell: str, section: str):
    """The metrics of ``section`` that ``cell`` reports: those naming it
    under ``workloads``, and those without the key whose end-to-end metric
    the cell reports."""
    reported = {m["name"] for m in bench["end_to_end"]
                if cell in m.get("workloads", [cell])}
    out = []
    for m in bench[section]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif section == "end_to_end" or m.get("moves") in reported:
            out.append(m)
    return out


def forbidden_modules():
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def run_cell(cell: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", overrides=None, t_start=None,
             control: bool = False) -> dict:
    """Run ``cell`` once and return its result line as a dict.
    ``overrides`` ({"config": {...}, "params": {...}}) replace sizes, for
    the tests' runs at a size the CPU holds. ``control`` puts the cell's
    control, the reference with one guarantee broken, in the program's
    place; its run has to come out not correct."""
    t_start = time.time() if t_start is None else t_start
    bench = load_json(ROOT, "BENCHMARK.json")
    (chips,) = [w["chips"] for w in bench["workloads"] if w["name"] == cell]
    spec = load_json(HERE, "workloads", cell + ".json")
    overrides = overrides or {}
    config = merge(load_json(HERE, "configs", spec["config"] + ".json"),
                   overrides.get("config"))
    params = merge(spec["params"], overrides.get("params"))
    dev = torch.device(device)
    if dev.type == "cuda":
        count = (torch.cuda.device_count() if torch.cuda.is_available()
                 else 0)
        if count < chips:
            raise NoCard(f"{cell} needs {chips} CUDA card(s); "
                         f"this machine has {count}")
        torch.cuda.reset_peak_memory_stats()
    workdir = tempfile.mkdtemp(prefix="commet_bench_")
    threads = torch.get_num_threads()
    if "torch_threads" in params:
        # the threads of PyTorch's CPU pool that the cell's process runs
        # with (idle workers spin on cores that the host's code needs)
        torch.set_num_threads(params["torch_threads"])
    try:
        return _run(bench, cell, spec, config, params, seed, seconds, trace,
                    dev, workdir, t_start, control)
    finally:
        torch.set_num_threads(threads)
        shutil.rmtree(workdir, ignore_errors=True)


def _run(bench, cell, spec, config, params, seed, seconds, trace, dev,
         workdir, t_start, control):
    traffic = load_module("traffic", spec["traffic"]).Traffic(
        SimpleNamespace(config=config, params=params, seed=seed, device=dev,
                        workdir=workdir, control=control))
    t0 = time.perf_counter()
    traffic.setup()
    t1 = time.perf_counter()
    traffic.warm_up()
    _sync(dev)
    print(f"set-up: {t1 - t0:.3f} s ({traffic.phases}), warm-up unit "
          f"{time.perf_counter() - t1:.3f} s", file=sys.stderr)
    spans = Spans() if trace else None
    if spans is not None:
        wrap_program(spans)
    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    span = spans.span if spans else (lambda name: contextlib.nullcontext())
    units = []
    setup_s = time.time() - t_start
    w0 = time.perf_counter()
    with span("window"):
        while time.perf_counter() - w0 < seconds:
            u = {"i": len(units), "t0": time.perf_counter(), "error": None}
            try:
                with span("unit"):
                    u.update(traffic.unit(u["i"]))
                    _sync(dev)
            except Exception:  # a unit that raises counts as failed
                u["error"] = traceback.format_exc()
                print(u["error"], file=sys.stderr)
            u["t1"] = time.perf_counter()
            units.append(u)
        _sync(dev)
    window_s = time.perf_counter() - w0
    durations = sorted(u["t1"] - u["t0"] for u in units)
    print(f"window: {len(units)} units in {window_s:.3f} s; unit seconds "
          f"min {durations[0]:.4f}, median "
          f"{durations[len(durations) // 2]:.4f}, max {durations[-1]:.4f}",
          file=sys.stderr)
    trace_obj = None
    if prof is not None:
        prof.__exit__(None, None, None)
        path = os.path.join(workdir, "window.pt.trace.json")
        prof.export_chrome_trace(path)
        del prof
        trace_obj = Trace(path)
        os.remove(path)
    if spans is not None:
        spans.unwrap()
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    found = forbidden_modules()
    if found:
        raise Forbidden(f"loaded in this process: {', '.join(found)}")
    traffic.release()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checked = traffic.check(units, want_bytes=trace)
    run = SimpleNamespace(units=units, window_s=window_s, setup_s=setup_s,
                          trace=trace_obj, least=checked.get("least", {}))
    section = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cell_metrics(bench, cell, section):
        value = load_module(section if section == "end_to_end"
                            else "metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    failed = sum(1 for u in units
                 if u["error"] is not None or u["i"] in checked["failed"])
    checks = checked["checks"]
    correct = (bool(units) and failed == 0
               and all(v["value"] <= v["limit"] for v in checks.values()))
    result = {"correct": correct, "attempted": len(units), "failed": failed,
              "metrics": metrics, "device": _device(dev, peak)}
    if trace_obj is not None and dev.type == "cuda":
        lo, hi = trace_obj.window()
        result["device"]["busy_s"] = trace_obj.busy_s()
        result["device"]["window_s"] = hi - lo
        result["breakdown"] = trace_obj.breakdown()
    result["checks"] = checks
    return result


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _device(dev, peak: int) -> dict:
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": 1, "memory_peak_bytes": peak}
