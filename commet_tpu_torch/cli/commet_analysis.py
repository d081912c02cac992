"""commet_analysis CLI - recompute the CSV matrices from existing .bv
results (reference Commet_analysis.py): the deferred-aggregation step used
after cluster runs, and generally the way to re-derive matrices without
re-running comparisons (the .bv files are the checkpoint format).
"""

from __future__ import annotations

import argparse
import os
import sys

from commet_tpu_torch.cli.commet import output_matrices
from commet_tpu_torch.io.fof import (driver_read_bvs, driver_read_files,
                                     driver_set_names)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Computes the matrices from .bv results")
    parser.add_argument("input_file", type=str)
    parser.add_argument("-o", "--output_directory", dest="directory",
                        default="output_commet/")
    parser.add_argument("--no-plots", dest="plots", action="store_false")
    args = parser.parse_args(argv)

    out_dir = args.directory
    if not out_dir.endswith("/"):
        out_dir += "/"

    read_matrix = driver_read_files(args.input_file)
    bv_matrix = driver_read_bvs(args.input_file)
    if bv_matrix is None:
        bv_matrix = [[out_dir + os.path.basename(f) + ".bv" for f in line]
                     for line in read_matrix]
    names = driver_set_names(args.input_file)
    output_matrices(read_matrix, bv_matrix, names, out_dir, plots=args.plots)
    return 0


def entry() -> None:
    """console_scripts entry point (pyproject.toml)."""
    from commet_tpu_torch.cli.util import guarded
    sys.exit(guarded(main))


if __name__ == "__main__":
    entry()
