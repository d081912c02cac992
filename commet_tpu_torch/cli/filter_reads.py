"""filter_reads CLI - reference-compatible (src/filter_reads.cpp:50-222),
the port's copy of commet_tpu.cli.filter_reads (byte-identical .bv files).

Filters one read file by min length / max N count / min Shannon entropy /
max selected reads, writing the selection as a .bv bit vector whose header
comment is byte-identical to the reference's.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from commet_tpu_torch.core.filter import filter_reads_counts
from commet_tpu_torch.io.bv import BitVector
from commet_tpu_torch.io.reads import load_read_file

INT_MAX = 2**31 - 1


def _fmt_float(x: float) -> str:
    """iostream default float formatting (6 significant digits, %g)."""
    return "%g" % float(np.float32(x))


def build_comment(input_file_name: str, min_size: int, max_n: int,
                  min_shannon: float, c_opt: str | None) -> str:
    """Replicates the comment assembly of filter_reads.cpp:158-176."""
    parts = []
    if c_opt is not None:
        parts.append(c_opt + "\n")
    parts.append("----------------\n")
    parts.append("Reference file\n")
    pos = input_file_name.rfind("/")
    if 0 < pos < len(input_file_name):
        parts.append("  " + input_file_name[pos + 1 :] + "\n")
    else:
        parts.append("  " + input_file_name + "\n")
    parts.append("Filter Options\n")
    parts.append("  min read size     : %d\n" % min_size)
    if max_n == INT_MAX:
        parts.append("  max number of N   : infinite\n")
    else:
        parts.append("  max number of N   : %d\n" % max_n)
    parts.append("  min shannon index : %s\n" % _fmt_float(min_shannon))
    return "".join(parts)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(__doc__, file=sys.stderr)
        return 0
    begin = time.time()
    input_file_name = ""
    output_file_name = ""
    min_size = 0
    max_n = INT_MAX
    min_shannon = 0.0
    max_reads = -1
    c_opt = None

    i = 0
    if argv and argv[-1] in ('-o', '-l', '-n', '-m', '-e', '-c'):
        print(f"Error, flag {argv[-1]} needs an argument",
              file=sys.stderr)
        sys.exit(1)
    while i < len(argv):
        flag = argv[i]
        if not flag.startswith("-"):
            if not input_file_name:
                input_file_name = flag
            elif not output_file_name:
                output_file_name = flag
            else:
                print(f"The mandatory files are already set, unknown file {flag} -> ignore")
        elif flag == "-o":
            i += 1
            output_file_name = argv[i]
        elif flag == "-l":
            i += 1
            min_size = int(argv[i])
        elif flag == "-n":
            i += 1
            max_n = int(argv[i])
        elif flag == "-m":
            i += 1
            max_reads = int(argv[i])
        elif flag == "-e":
            i += 1
            min_shannon = float(argv[i])
        elif flag == "-c":
            i += 1
            c_opt = argv[i]
        elif flag == "-h":
            print(__doc__)
            return 0
        else:
            print(f"Unknown option {flag}", file=sys.stderr)
            return 1
        i += 1

    if not input_file_name:
        print("Error: An input file name is needed -> exit", file=sys.stderr)
        return 0
    output_message = ""
    if not output_file_name:
        output_message = ("No output file name given, results will be written in "
                          + input_file_name + ".bv\n")
        output_file_name = input_file_name + ".bv"

    rf = load_read_file(input_file_name)

    if max_reads == -1:
        max_reads_eff = rf.nb_reads
    else:
        max_reads_eff = max_reads

    if max_reads_eff < 0:
        # negative cap other than -1: the reference loop never runs and
        # untag_last_reads clears everything (filter_reads.cpp:188,203-205)
        keep = np.zeros(rf.nb_reads, dtype=bool)
        stats = {"nb_rm_length": 0, "nb_rm_N": 0, "nb_rm_shannon": 0,
                 "nb_selected": 0}
    else:
        counts, lengths = rf.class_counts()
        keep, stats = filter_reads_counts(counts, lengths, min_size=min_size,
                                          max_n=max_n,
                                          min_shannon=min_shannon,
                                          max_reads=max_reads_eff)

    bv = BitVector.from_bool_array(keep)
    bv.comment = build_comment(input_file_name, min_size, max_n,
                               min_shannon, c_opt)
    bv.write(output_file_name)

    print("Length filter [%d]: %d reads removed" % (min_size, stats["nb_rm_length"]))
    if max_n == INT_MAX:
        print("Number of N filter [infinite]: %d reads removed" % stats["nb_rm_N"])
    else:
        print("Number of N filter [%d]: %d reads removed" % (max_n, stats["nb_rm_N"]))
    print("Shannon filter [%s]: %d reads removed"
          % (_fmt_float(min_shannon), stats["nb_rm_shannon"]))
    print("Number of selected reads = %d" % stats["nb_selected"])
    if output_message:
        print(output_message, end="")
    print("Total  time : %g s" % (time.time() - begin))
    return 0


def entry() -> None:
    """Command-line entry point: errors exit 1 with a one-line message."""
    from commet_tpu_torch.cli.util import guarded
    sys.exit(guarded(main))


if __name__ == "__main__":
    entry()
