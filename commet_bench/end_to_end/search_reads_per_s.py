"""Query reads classified in the window's completed search units (a read
searched against S residents counts S), over the window's seconds."""


def read(run):
    reads = sum(u["work"]["reads"] for u in run.units
                if u["error"] is None and "reads" in u.get("work", {}))
    return reads / run.window_s if reads else None
