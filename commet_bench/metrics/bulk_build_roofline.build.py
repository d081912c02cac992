"""Percent of the least time of a plane build (reads read once, the four
planes written once, at 3.35 TB/s) in the device time of every kernel
inside the build units."""

from commet_bench import layers


def read(run):
    return layers.roofline_share(run, "build_bytes")
