"""The program's own spans (``commet_tpu_torch/trace.py``) for the
per-layer readers. The program records them while ``torch.profiler`` runs,
so in a traced run they are those of the window; a reader keeps those that
lie inside the run's units, on the host's clock. A run that is not traced,
or a program that keeps no spans (a commit before them), gives None."""

from __future__ import annotations

import importlib
import importlib.util
import time

# seconds of slack at either end of the units: the spans are stamped on the
# Unix clock, the units on time.perf_counter
SLACK_S = 0.01


def recorded(run):
    """The program's spans inside ``run``'s units, or None."""
    if (run.trace is None or not run.units
            or importlib.util.find_spec("commet_tpu_torch.trace") is None):
        return None
    spans = importlib.import_module("commet_tpu_torch.trace").recorded()
    shift_ns = (time.time() - time.perf_counter()) * 1e9
    lo = (min(u["t0"] for u in run.units) - SLACK_S) * 1e9 + shift_ns
    hi = (max(u["t1"] for u in run.units) + SLACK_S) * 1e9 + shift_ns
    return [s for s in spans if lo <= s.start_ns and s.end_ns <= hi]


def seconds(run, *names):
    """Seconds of the program's spans named ``names``, summed; None where
    the run has none of them."""
    spans = recorded(run)
    if spans is None:
        return None
    got = [(s.end_ns - s.start_ns) * 1e-9 for s in spans if s.name in names]
    return sum(got) if got else None


def share(part, whole):
    """100 x ``part`` / ``whole``; None where either is missing."""
    if part is None or not whole:
        return None
    return 100.0 * part / whole


def unit_share(run, *names):
    """Percent of the units' seconds (their ``unit`` ranges in the trace)
    in the program's spans ``names``."""
    if run.trace is None:
        return None
    units = sum(e - s for s, e in run.trace.ranges.get("unit", []))
    return share(seconds(run, *names), units)


def pin_share(run):
    """Percent of the host pack's seconds spent copying the batches into
    page-locked memory (``host.pin`` in ``host.pack``)."""
    return share(seconds(run, "host.pin"), seconds(run, "host.pack"))
