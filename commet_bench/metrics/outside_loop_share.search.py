"""Percent of the search units' seconds in host work before and after the
batch loop (the program's ``search.select`` and ``search.finish`` spans),
which Engine.last_io_stats leaves out."""

from commet_bench import program_spans


def read(run):
    return program_spans.unit_share(run, "search.select", "search.finish")
