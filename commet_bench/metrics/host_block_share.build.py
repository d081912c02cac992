"""Percent of the build units' seconds (the whole call, not the batch loop
that host_block_share.search divides by) that the dispatch loop waited for
a host batch (the program's ``host.wait`` spans, the blocks
Engine.last_io_stats sums as host_block_s)."""

from commet_bench import program_spans


def read(run):
    return program_spans.unit_share(run, "host.wait")
