"""Percent of the least time of the sorted route's work (the query reads
read once, each resident's keya sectors at the lower-bound positions of the
reads' windows on both strands and its keyb sectors where the keya is
present, a tag bit a read for each resident, at 3.35 TB/s) in the device
time of every kernel inside the search units: the query sort, the grouped
join, the verdicts and the exact fallback alike."""

from commet_bench import layers


def read(run):
    return layers.roofline_share(run, "join_probe_bytes")
