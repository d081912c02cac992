"""Percent of the search units' seconds that the prefetch thread spent
packing host batches (the program's ``host.pack`` spans): how busy the one
pack thread is."""

from commet_bench import program_spans


def read(run):
    return program_spans.unit_share(run, "host.pack")
