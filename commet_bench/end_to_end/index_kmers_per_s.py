"""K-mers of the window's completed resident-plane builds, over the
window's seconds."""


def read(run):
    kmers = sum(u["work"]["kmers"] for u in run.units
                if u["error"] is None and "kmers" in u.get("work", {}))
    return kmers / run.window_s if kmers else None
