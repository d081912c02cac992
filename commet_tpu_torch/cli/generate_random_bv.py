"""generate_random_bv CLI - random test-fixture bit vector keeping ~X% of a
read set's reads (reference src/generate_random_bv.cpp:45-78)."""

from __future__ import annotations

import random
import sys

from commet_tpu_torch.io.bv import BitVector
from commet_tpu_torch.io.reads import load_read_file


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 3:
        print("Usage: generate_random_bv <read_file> <percentage> <output_bv>",
              file=sys.stderr)
        return 1
    read_set, pct_s, out = argv[0], argv[1], argv[2]
    pct = float(pct_s)
    if pct < 0 or pct > 100:
        print("the percentage of reads to be kept must be in [0,100]",
              file=sys.stderr)
        return 1
    rf = load_read_file(read_set)
    bv = BitVector(rf.nb_reads)
    # rand() % 100000 < 1000 * pct (reference boolean_vector.h:167-174)
    for i in range(rf.nb_reads):
        if random.randrange(100000) < 1000 * pct:
            bv.set(i)
    bv.comment = "%g %% random reads kept" % pct
    bv.write(out)
    return 0


def entry() -> None:
    """console_scripts entry point (pyproject.toml)."""
    from commet_tpu_torch.cli.util import guarded
    sys.exit(guarded(main))


if __name__ == "__main__":
    entry()
