"""Percent of the least time of the grouped plane probe's work (reads read
once, each distinct plane sector of each resident that their windows need
read once, a tag bit a read for each resident, at 3.35 TB/s) in the device
time of every kernel inside the cohort's search units."""

from commet_bench import layers


def read(run):
    return layers.roofline_share(run, "cohort_probe_bytes")
