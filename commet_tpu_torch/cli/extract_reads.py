"""extract_reads CLI - materialize a .bv selection back into reads
(reference src/extract_reads.cpp:47-190).

Usage: extract_reads <read_file> <bv_file> [-o output]
Gzipped inputs are re-compressed on output (extract_reads.cpp:149-166).
"""

from __future__ import annotations

import gzip
import sys

from commet_tpu_torch.io.reads import load_read_file


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    input_file = ""
    bv_file = ""
    out = ""
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "-o":
            i += 1
            out = argv[i]
        elif a == "-h":
            print(__doc__)
            return 0
        elif not input_file:
            input_file = a
        elif not bv_file:
            bv_file = a
        i += 1
    if not input_file or not bv_file:
        print("A read file and a bv file must be provided", file=sys.stderr)
        return 1

    rf = load_read_file(input_file, bv_file)
    keep = rf.filter_bv.as_bool_array()
    records = (rec for rec, k_ in zip(rf.records, keep) if k_)

    if rf.was_gzipped:
        if not out:
            print("Error, try to compress results but no output file name is given",
                  file=sys.stderr)
            return 1
        with gzip.open(out, "wb", compresslevel=6) as f:
            for rec in records:
                f.write(rec)
    elif out:
        with open(out, "wb") as f:
            for rec in records:
                f.write(rec)
    else:
        for rec in records:
            sys.stdout.buffer.write(rec)
    return 0


def entry() -> None:
    """console_scripts entry point (pyproject.toml)."""
    from commet_tpu_torch.cli.util import guarded
    sys.exit(guarded(main))


if __name__ == "__main__":
    entry()
