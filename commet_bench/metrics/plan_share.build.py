"""Percent of the build units' seconds before a build's first batch:
counting each read's k-mers and the partition cursor (the program's
``build.count`` and ``build.partition`` spans)."""

from commet_bench import program_spans


def read(run):
    return program_spans.unit_share(run, "build.count", "build.partition")
