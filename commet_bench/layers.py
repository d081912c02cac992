"""The arithmetic the per-layer metric readers share. Each reader gets the
run: its units (host-clock ``t0``/``t1``, ``work``, ``io``), its trace
(traced runs only) and ``least``, the least bytes of each unit's
device work that the check worked out from the inputs. A reader that finds
nothing to read returns None."""

from __future__ import annotations

from commet_bench import roofline


def done(run):
    return [u for u in run.units if u["error"] is None]


def host_block_share(run):
    """Percent of the search calls' wall the dispatch loop waited for a
    host batch (Engine.last_io_stats)."""
    io = [u["io"] for u in done(run) if u.get("io")]
    wall = sum(x["wall_s"] for x in io)
    if not wall:
        return None
    return 100.0 * sum(x["host_block_s"] for x in io) / wall


def roofline_share(run, key: str):
    """Percent of the least time of the units' device work (``least[key]``
    bytes at the card's peak rate) in the device time of every kernel
    launched inside the units."""
    least = run.least.get(key)
    if run.trace is None or not least:
        return None
    kernel_s = run.trace.kernel_s_in("unit")
    if kernel_s <= 0:
        return None
    return 100.0 * roofline.bound_s(sum(least)) / kernel_s


def device_idle_share(run):
    """Percent of the traced window in which no kernel, copy or set ran on
    the device."""
    if run.trace is None:
        return None
    lo, hi = run.trace.window()
    return 100.0 * (1.0 - run.trace.busy_s() / (hi - lo))
