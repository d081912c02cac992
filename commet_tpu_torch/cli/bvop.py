"""bvop CLI - bit-vector algebra, reference-compatible (src/bvop.cpp:54-175).

Ops: -n NOT, -a AND, -o OR, -d ANDNOT; -p <file> writes the result;
-i prints the comment and the "  N / M reads selected" info line that the
driver parses (Commet.py:256-257).
"""

from __future__ import annotations

import sys

from commet_tpu_torch.io.bv import BitVector


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print("A boolean vector file must be provided, see usage", file=sys.stderr)
        return 1
    file1 = ""
    file2 = ""
    out = ""
    do_print = False
    print_info = False
    op = "u"
    i = 0
    while i < len(argv):
        a = argv[i]
        if a.startswith("-") and len(a) > 1:
            f = a[1]
            if f in "aod":
                i += 1
                file2 = argv[i]
                op = f
            elif f == "n":
                op = "n"
            elif f == "p":
                i += 1
                out = argv[i]
                do_print = True
            elif f == "i":
                print_info = True
            else:
                print(__doc__)
                return 0
        else:
            if not file1:
                file1 = a
            else:
                print("One input file is mandatory", file=sys.stderr)
                return 0
        i += 1

    bv1 = BitVector.read(file1)
    do_nothing = False
    comment = ""
    if op == "a":
        bv1.full_and(BitVector.read(file2))
        comment = file1 + " AND " + file2 + "\n"
    elif op == "o":
        bv1.full_or(BitVector.read(file2))
        comment = file1 + " OR " + file2 + "\n"
    elif op == "d":
        bv1.full_and_not(BitVector.read(file2))
        comment = file1 + " AND (NOT " + file2 + ")\n"
    elif op == "n":
        bv1.full_not()
        comment = "NOT " + file1 + "\n"
    else:
        do_nothing = True

    if print_info:
        sys.stdout.write(bv1.comment)
        sys.stdout.write("\nReads:\n")
        sys.stdout.write("  %d / %d reads selected\n" % (bv1.nb_one(), bv1.size))

    if do_nothing:
        return 0

    bv1.comment = comment
    if do_print:
        bv1.write(out)
    else:
        sys.stdout.write(bv1.comment + "\n#" + str(bv1.size) + "\n")
        sys.stdout.buffer.write(bv1.data.tobytes())
    return 0


def entry() -> None:
    """console_scripts entry point (pyproject.toml)."""
    from commet_tpu_torch.cli.util import guarded
    sys.exit(guarded(main))


if __name__ == "__main__":
    entry()
