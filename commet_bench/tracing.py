"""Spans the benchmark records around public calls of the program, and the
reduction of a ``torch.profiler`` Chrome trace to device intervals.

A span is a ``torch.profiler.record_function`` range, so it shows in the
trace beside the device's kernels and copies on the trace's own clock.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import time
from typing import Dict

import torch

# Chrome trace categories of work on the device
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the Engine's public calls: the boundary between the driver and the engine
ENGINE_CALLS = ("build_resident", "search_multi_set", "build_resident_planes",
                "search_multi_set_planes", "index_and_search")


class Spans:
    """Host spans and the wrappers that record them."""

    def __init__(self):
        self._undo = []

    def span(self, name: str):
        return torch.profiler.record_function(name)

    def wrap(self, owner, attr: str, name: str) -> None:
        """Record a span ``name`` around every call of ``owner.attr``."""
        fn = getattr(owner, attr)
        spans = self

        def wrapper(*args, **kwargs):
            with spans.span(name):
                return fn(*args, **kwargs)

        setattr(owner, attr, wrapper)
        self._undo.append((owner, attr, fn))

    def unwrap(self) -> None:
        for owner, attr, fn in reversed(self._undo):
            setattr(owner, attr, fn)
        self._undo.clear()


@contextlib.contextmanager
def timed(into: dict, name: str):
    """Seconds of the block, into ``into[name]`` (the set-up's phases)."""
    t0 = time.perf_counter()
    yield
    into[name] = round(time.perf_counter() - t0, 3)


def wrap_program(spans: Spans) -> None:
    """Spans ``engine.<call>`` around the Engine's public calls and
    ``parse.add_file`` around each set parse."""
    from commet_tpu_torch.engine.engine import Engine
    from commet_tpu_torch.io.reads import ReadSet
    for name in ENGINE_CALLS:
        spans.wrap(Engine, name, "engine." + name)
    spans.wrap(ReadSet, "add_file", "parse.add_file")


def union_s(intervals, lo: float = float("-inf"),
            hi: float = float("inf")) -> float:
    """Length of the union of (start, end) intervals clipped to [lo, hi]."""
    total, end = 0.0, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


class Trace:
    """The events of one Chrome trace, in seconds on the trace's clock:
    ``device`` [(start, end, name)] of kernels, copies and sets;
    ``kernels`` the same of kernels alone; ``ranges`` {name: [(start,
    end)]} of the recorded spans."""

    def __init__(self, path: str):
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        self.device, self.kernels = [], []
        self.ranges: Dict[str, list] = {}
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            s = float(e["ts"]) * 1e-6
            iv = (s, s + float(e["dur"]) * 1e-6)
            cat = e.get("cat")
            if cat in DEVICE_CATS:
                self.device.append((*iv, e.get("name", "")))
                if cat == "kernel":
                    self.kernels.append((*iv, e.get("name", "")))
            elif cat == "user_annotation":
                self.ranges.setdefault(e.get("name", ""), []).append(iv)
        self.device.sort()
        self.kernels.sort()

    def window(self):
        """(start, end) of the traced window's range."""
        (iv,) = self.ranges["window"]
        return iv

    def busy_s(self) -> float:
        lo, hi = self.window()
        return union_s([(s, e) for s, e, _n in self.device], lo, hi)

    def kernel_s_in(self, name: str) -> float:
        """Device seconds of every kernel that starts inside a range
        ``name``."""
        starts = [s for s, _e, _n in self.kernels]
        total = 0.0
        for lo, hi in self.ranges.get(name, []):
            first = bisect.bisect_left(starts, lo)
            last = bisect.bisect_left(starts, hi)
            total += sum(e - s for s, e, _n in self.kernels[first:last])
        return total

    def breakdown(self, top: int = 10) -> dict:
        """The device operations with the most seconds in the window, and
        the longest idle gaps summed by the innermost recorded range that
        holds each gap's middle."""
        lo, hi = self.window()
        by_name: Dict[str, float] = {}
        busy = []
        for s, e, name in self.device:
            if e <= lo or s >= hi:
                continue
            by_name[name[:120]] = by_name.get(name[:120], 0.0) + (e - s)
            busy.append((max(s, lo), min(e, hi)))
        gaps, end = [], lo
        for s, e in busy:
            if s > end:
                gaps.append((end, s))
            end = max(end, e)
        if hi > end:
            gaps.append((end, hi))
        ranges = [(s, e, n) for n, ivs in self.ranges.items()
                  if n != "window" for s, e in ivs]
        by_host: Dict[str, float] = {}
        for s, e in gaps:
            mid = (s + e) / 2
            holding = [(re - rs, n) for rs, re, n in ranges
                       if rs <= mid < re]
            name = min(holding)[1] if holding else "outside any span"
            by_host[name] = by_host.get(name, 0.0) + (e - s)

        def ordered(d):
            return [[n, v] for n, v in sorted(d.items(),
                                              key=lambda kv: -kv[1])[:top]]

        return {"device_ops": ordered(by_name), "idle_gaps": ordered(by_host)}
