"""Percent of the search units' wall (Engine.last_io_stats wall_s) that
the dispatch loop waited for a host batch (host_block_s)."""

from commet_bench import layers


def read(run):
    return layers.host_block_share(run)
