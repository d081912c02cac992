"""Percent of the cohort's search units' seconds in each resident's
counters, .log and .bv writes (the program's ``finish.resident`` spans):
the host work of a search that grows with the residents."""

from commet_bench import program_spans


def read(run):
    return program_spans.unit_share(run, "finish.resident")
