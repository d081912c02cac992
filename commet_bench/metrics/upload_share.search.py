"""Percent of the search units' seconds spent uploading query sets' codes
and read ids for the batches packed on the card (the program's
``pack.upload`` spans); nothing where the program packs on the host."""

from commet_bench import program_spans


def read(run):
    return program_spans.unit_share(run, "pack.upload")
