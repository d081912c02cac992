"""Percent of the read-slot pairs of the search units that the join left
AMBIG and sent to the exact fallback: Engine.last_io_stats' ``ambig`` over
the unit's candidate reads times its ``slots``; nothing where the program
does not count them."""

from commet_bench import layers


def read(run):
    units = [u for u in layers.done(run)
             if "ambig" in u.get("io", {}) and "slots" in u["io"]]
    whole = sum(u["candidates"] * u["io"]["slots"] for u in units)
    if not whole:
        return None
    return 100.0 * sum(u["io"]["ambig"] for u in units) / whole
