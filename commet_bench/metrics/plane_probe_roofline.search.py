"""Percent of the least time of the plane probe's work (reads read once,
each plane sector their windows need read once, tags written once, at
3.35 TB/s) in the device time of every kernel inside the search units."""

from commet_bench import layers


def read(run):
    return layers.roofline_share(run, "probe_bytes")
