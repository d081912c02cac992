"""Percent of the bytes that the search units' uploads copied from
page-locked memory: the ``pinned`` attribute of the program's
``pack.upload`` spans over their ``bytes``; nothing where the spans lack
the attribute (a program before it), where the program packs on the host
(no such span), or where the run is not traced."""

from commet_bench import program_spans


def read(run):
    spans = program_spans.recorded(run)
    if spans is None:
        return None
    uploads = [s.attrs or {} for s in spans if s.name == "pack.upload"]
    if not uploads or any("pinned" not in a for a in uploads):
        return None
    return program_spans.share(sum(a["pinned"] for a in uploads),
                               sum(a["bytes"] for a in uploads))
