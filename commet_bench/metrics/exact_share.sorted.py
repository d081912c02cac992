"""Percent of the search units' seconds in the exact fallback that decides
the join's AMBIG reads (the program's ``search.exact`` spans); nothing
where the program has no such span."""

from commet_bench import program_spans


def read(run):
    return program_spans.unit_share(run, "search.exact")
