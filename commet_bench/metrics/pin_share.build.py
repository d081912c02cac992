"""Percent of the build's host pack (``host.pack`` spans) spent copying
the batches into page-locked memory (``host.pin``); nothing on the CPU,
where nothing is pinned."""

from commet_bench import program_spans


def read(run):
    return program_spans.pin_share(run)
