"""commet driver CLI, the all-vs-all pipeline (reference Commet.py:438-601),
PyTorch port of commet_tpu.cli.commet's classic schedule.

Given a file-of-files manifest (one line per read set,
"name: file[,bv]; file[,bv]; ..."), it:
  1. filters every read file into a .bv unless the manifest supplies bvs
     (Commet.py:103-121,557-562);
  2. runs the ordered 3-step refinement over every pair of sets
     (Commet.py:186-240): all-in-Si, then per later set X:
     Si in (X in Si), then X in (Si in (X in Si));
  3. writes matrix_plain/percentage/normalized.csv, byte-identical to the
     reference's (Commet.py:245-317), plus heatmap/dendrogram PNGs.

State flows through .bv files between steps like the reference's
subprocess pipeline. ``--one_vs_all``, ``--jobs``/``--sge`` and multi-host
runs are not ported yet (ROADMAP).
"""

from __future__ import annotations

import argparse
import os
import sys

from commet_tpu.cli import filter_reads as filter_cli
from commet_tpu.io.bv import BitVector
from commet_tpu.io.fof import (driver_read_bvs, driver_read_files,
                               driver_set_names)
from commet_tpu.io.reads import ReadSet
from commet_tpu_torch.device import resolve_device
from commet_tpu_torch.engine.engine import DEFAULT_BATCH, Engine


def filter_all_reads(read_matrix, out_dir, l, n, e, m):
    """Per-file filter_reads invocations (Commet.py:103-121)."""
    for tab_line in read_matrix:
        argv_m = []
        if m >= 0:
            argv_m = ["-m", str(m // len(tab_line))]
        for path in tab_line:
            argv = [path, "-l", str(l), "-e", str(e)]
            if n >= 0:
                argv += ["-n", str(n)]
            argv += argv_m + ["-o", out_dir + os.path.basename(path) + ".bv"]
            print("Filtering: filter_reads " + " ".join(argv))
            filter_cli.main(argv)


def _load_set(name, files, bvs) -> ReadSet:
    rs = ReadSet(name)
    for f, b in zip(files, bvs):
        rs.add_file(f, b or None)
    return rs


def refine_pair(read_matrix, bv_matrix, names, out_dir, ref_id, j, eng):
    """Steps a/b of the 3-pass refinement for pair (ref_id, j)
    (Commet.py:211-238); needs the pair's step-0 result bvs on disk."""
    # STEP a: Si in (X in Si) - index X narrowed by its _in_Si bvs
    x_bvs = [out_dir + os.path.basename(f) + "_in_" +
             os.path.basename(names[ref_id]) + ".bv"
             for f in read_matrix[j]]
    x_narrow = _load_set(names[j], read_matrix[j], x_bvs)
    si = _load_set(names[ref_id], read_matrix[ref_id], bv_matrix[ref_id])
    print(f" {names[ref_id]} in ({names[j]} in {names[ref_id]})")
    eng.index_and_search(x_narrow, [si], out_dir=out_dir, log_dir=out_dir)

    # STEP b: X in (Si in (X in Si)) - index Si narrowed by its _in_X bvs
    si_bvs = [out_dir + os.path.basename(f) + "_in_" +
              os.path.basename(names[j]) + ".bv"
              for f in read_matrix[ref_id]]
    si_narrow = _load_set(names[ref_id], read_matrix[ref_id], si_bvs)
    x_full = _load_set(names[j], read_matrix[j], bv_matrix[j])
    print(f" {names[j]} in ({names[ref_id]} in ({names[j]} in {names[ref_id]}))")
    eng.index_and_search(si_narrow, [x_full], out_dir=out_dir, log_dir=out_dir)


def compare_all_against(read_matrix, bv_matrix, names, out_dir, ref_id, eng):
    """One reference round (Commet.py:186-240): index Si and search every
    later set, then refine each pair; results chain through .bv files."""
    index_set = _load_set(names[ref_id], read_matrix[ref_id], bv_matrix[ref_id])
    queries = [_load_set(names[j], read_matrix[j], bv_matrix[j])
               for j in range(ref_id + 1, len(names))]
    print(f"All in {names[ref_id]}")
    eng.index_and_search(index_set, queries, out_dir=out_dir, log_dir=out_dir)
    for j in range(ref_id + 1, len(names)):
        refine_pair(read_matrix, bv_matrix, names, out_dir, ref_id, j, eng)


def bv_count(path: str) -> int:
    return BitVector.read(path).nb_one()


def py2_str_float(v: float) -> str:
    """CPython 2.7 ``str(float)``: 12 significant digits, ``.0`` appended
    to integral results unless an exponent is present. The reference driver
    is python 2 (Commet.py:299,314,408-420), so byte parity of the float
    CSVs needs this formatter rather than py3's shortest repr."""
    s = "%.12g" % v
    if "." not in s and "e" not in s and "n" not in s:  # n: inf/nan
        s += ".0"
    return s


def output_matrices(read_matrix, bv_matrix, names, out_dir, plots=True):
    """CSV matrices, byte-identical to Commet.py:245-317."""
    number_reads_all_sets = [sum(bv_count(b) for b in bv_matrix[i])
                             for i in range(len(names))]
    matrix = []
    for i in range(len(names)):
        row = []
        for j in range(len(names)):
            if i == j:
                row.append(number_reads_all_sets[i])
                continue
            row.append(sum(
                bv_count(out_dir + os.path.basename(f) + "_in_" + names[j]
                         + ".bv")
                for f in read_matrix[i]))
        matrix.append(row)

    def write_matrix(fname, value_fn):
        with open(out_dir + fname, "w") as f:
            for name in names:
                f.write(";" + name)
            f.write("\n")
            for i in range(len(names)):
                f.write(names[i])
                for j in range(len(names)):
                    f.write(";" + str(value_fn(i, j)))
                f.write("\n")

    write_matrix("matrix_plain.csv", lambda i, j: matrix[i][j])
    write_matrix("matrix_percentage.csv", lambda i, j: py2_str_float(
        100 * matrix[i][j] / float(number_reads_all_sets[i])))
    write_matrix("matrix_normalized.csv", lambda i, j: py2_str_float(
        100 * (matrix[i][j] + matrix[j][i])
        / float(number_reads_all_sets[i] + number_reads_all_sets[j])))

    if plots:
        try:
            from commet_tpu.viz.plots import dendrogram_png, heatmap_png
            dendrogram_png(out_dir + "matrix_normalized.csv",
                           out_dir + "dendrogram_normalized.png")
            for kind in ("plain", "percentage", "normalized"):
                heatmap_png(out_dir + f"matrix_{kind}.csv",
                            out_dir + "matrix_normalized.csv",
                            out_dir + f"heatmap_{kind}.png", kind.capitalize())
        except Exception as exc:  # plotting must never fail the pipeline
            print(f"(plots skipped: {exc})")

    print("All Commet work is done")
    for kind in ("plain", "percentage", "normalized"):
        print(f"\t\t{out_dir}matrix_{kind}.csv")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Computes the filtering and the full N x N intersections "
                    "of read sets (PyTorch / CUDA)")
    parser.add_argument("input_file", type=str)
    parser.add_argument("--sge", action="store_true",
                        help="not yet ported (ROADMAP)")
    parser.add_argument("--one_vs_all", action="store_true",
                        help="not yet ported (ROADMAP)")
    parser.add_argument("--no-plots", dest="plots", action="store_false")
    parser.add_argument("-o", "--output_directory", dest="directory",
                        default="output_commet/")
    parser.add_argument("-k", type=int, default=33)
    parser.add_argument("-t", type=int, default=2)
    parser.add_argument("-l", type=int, default=0)
    parser.add_argument("-n", type=int, default=-1)
    parser.add_argument("-e", type=float, default=0)
    parser.add_argument("-m", type=int, default=-1)
    parser.add_argument("-b", "--binaries_directory", type=str,
                        dest="binary_directory", default=None,
                        help="accepted for reference drop-in compatibility; "
                             "unused (no external binaries)")
    parser.add_argument("--batch", type=int, default=DEFAULT_BATCH,
                        help="reads per batch of the exact fallback")
    parser.add_argument("--jobs", type=int, default=1,
                        help="not yet ported (ROADMAP); must be 1")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; fails without a card) or cpu")
    args = parser.parse_args(argv)
    for flag, asked in (("--one_vs_all", args.one_vs_all),
                        ("--sge", args.sge), ("--jobs", args.jobs != 1)):
        if asked:
            parser.error(f"{flag} is not yet ported (ROADMAP)")
    device = resolve_device(args.device)

    out_dir = args.directory
    if not out_dir.endswith("/"):
        out_dir += "/"
    os.makedirs(out_dir, exist_ok=True)

    k, t, l = args.k, args.t, args.l
    # l-default quirk (Commet.py:509-513): l=0 stays 0 (no length filter)
    if l < k * t and l != 0:
        print(f"l should be at least k*t. {l} is too small with k={k} and t={t}.")
        l = k * t
    print(f"k={k} t={t} l={l}")

    read_matrix = driver_read_files(args.input_file)
    names = driver_set_names(args.input_file)
    bv_matrix = driver_read_bvs(args.input_file)
    if bv_matrix is None:
        print("Reads were not filtered, we filter them.")
        filter_all_reads(read_matrix, out_dir, l, args.n, args.e, args.m)
        bv_matrix = [[out_dir + os.path.basename(f) + ".bv" for f in line]
                     for line in read_matrix]

    eng = Engine(k=k, t=t, device=device, batch=args.batch)
    for ref_id in range(len(read_matrix) - 1):
        compare_all_against(read_matrix, bv_matrix, names, out_dir, ref_id,
                            eng)
    output_matrices(read_matrix, bv_matrix, names, out_dir, plots=args.plots)
    return 0


def entry() -> None:
    """console_scripts entry point (pyproject.toml)."""
    from commet_tpu.cli.util import guarded
    sys.exit(guarded(main))


if __name__ == "__main__":
    entry()
