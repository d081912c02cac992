"""The port's spans: named intervals of host work, recorded on any thread
while ``torch.profiler`` runs, and stamped with the Unix clock
(``time.time_ns``), the clock ``torch.profiler``'s Chrome traces count
from (their ``baseTimeNanoseconds``), so spans and the card's kernels and
copies share one timeline.

Whoever starts a profiler records the spans: ``COMMET_TPU_PROFILE`` around
each public Engine call, or a benchmark around its traced window. The
profiler's flag is global, so the prefetch thread records too. A recorded
span is also a ``record_function`` range, so it shows in the profiler's own
trace on the thread the profiler follows; ``to_chrome`` adds those of the
threads it does not follow, such as the prefetch thread.

``span(name, **attrs)`` marks a block. While no profiler runs it returns
one shared no-op object after a single flag check: no clock reading, no
allocation.
A span's ``note(**attrs)`` adds attributes known only inside its block
(a no-op on the shared one).
``clocked(name, **attrs)`` times its block always (``seconds``), for the
sums the engine keeps whether or not it records, and is a span, with
``attrs``, while a profiler runs. A span's parent is the innermost span
open on its thread when it starts; ``carry(fn)`` hands the span open now
to work run on another thread. ``recorded()`` returns the spans kept since
``clear()``, in the order they ended.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from typing import List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _profiler


class Span(NamedTuple):
    """One recorded span: ``thread`` is the OS thread id (a Chrome trace's
    ``tid``), ``parent`` the id of the span it ran under, or None."""
    id: int
    name: str
    start_ns: int
    end_ns: int
    thread: int
    parent: Optional[int]
    attrs: Optional[dict]


class _Off:
    """The shared span of a block while nothing records."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def note(self, **attrs):
        pass


OFF = _Off()
# the spans recorded while a profiler ran, as (id, name, start_ns, end_ns,
# thread, parent, attrs), in the order they ended, until clear()
_spans: list = []
_ids = itertools.count(1)
_local = threading.local()


def _thread():
    """This thread's stack of open span ids and its OS thread id."""
    state = getattr(_local, "state", None)
    if state is None:
        state = _local.state = ([], threading.get_native_id())
    return state


class _Open:
    __slots__ = ("name", "attrs", "range", "id", "parent", "start", "end")

    def __init__(self, name, attrs, recording):
        self.name, self.attrs = name, attrs
        self.range = (torch.profiler.record_function(name) if recording
                      else None)

    def __enter__(self):
        if self.range is not None:
            stack, _tid = _thread()
            self.id = next(_ids)
            self.parent = stack[-1] if stack else None
            stack.append(self.id)
            self.range.__enter__()
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end = time.time_ns()
        if self.range is not None:
            self.range.__exit__(None, None, None)
            stack, tid = _thread()
            stack.pop()
            _spans.append((self.id, self.name, self.start, self.end, tid,
                           self.parent, self.attrs))
        return False

    def note(self, **attrs):
        """Add ``attrs`` to the span's attributes before it ends."""
        self.attrs = dict(self.attrs or {}, **attrs)

    @property
    def seconds(self) -> float:
        return (self.end - self.start) * 1e-9


def span(name: str, **attrs):
    """A span around the ``with`` block, with ``attrs``, recorded while a
    profiler runs."""
    if not _profiler._is_profiler_enabled:
        return OFF
    return _Open(name, attrs or None, True)


def clocked(name: str, **attrs) -> _Open:
    """The block timed always (``seconds`` once it ends), and a span with
    ``attrs`` while a profiler runs."""
    return _Open(name, attrs or None, _profiler._is_profiler_enabled)


def carry(fn):
    """``fn`` as it runs on another thread under the span open on this
    thread now (``fn`` itself while nothing records)."""
    if not _profiler._is_profiler_enabled:
        return fn
    stack, _tid = _thread()
    parent = stack[-1] if stack else None

    def under(*args, **kwargs):
        stack, _tid = _thread()
        stack.append(parent)
        try:
            return fn(*args, **kwargs)
        finally:
            stack.pop()

    return under


def recorded() -> List[Span]:
    """The spans recorded since ``clear()``, in the order they ended."""
    return [Span._make(s) for s in list(_spans)]


def clear() -> None:
    """Forget the spans recorded so far."""
    _spans.clear()


def to_chrome(path: str, spans: List[Span]) -> None:
    """Add to the Chrome trace ``path`` that torch.profiler exported the
    ``spans`` of the threads on which it recorded no range (the prefetch
    thread's), as complete events (category ``program``) on their own
    threads, on the trace's clock, each with its parent span's name."""
    with open(path) as f:
        doc = json.load(f)
    base = doc["baseTimeNanoseconds"]
    followed = {e.get("tid") for e in doc["traceEvents"]
                if e.get("cat") == "user_annotation"}
    names = {s.id: s.name for s in spans}
    pid = os.getpid()
    for s in spans:
        if s.thread in followed:
            continue
        args = dict(s.attrs or {}, parent=names.get(s.parent))
        doc["traceEvents"].append({
            "ph": "X", "cat": "program", "name": s.name, "pid": pid,
            "tid": s.thread, "ts": (s.start_ns - base) / 1e3,
            "dur": (s.end_ns - s.start_ns) / 1e3, "args": args})
    with open(path, "w") as f:
        json.dump(doc, f)
