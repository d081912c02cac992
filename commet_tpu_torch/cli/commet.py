"""commet driver CLI, the all-vs-all pipeline (reference Commet.py:438-601),
PyTorch port of commet_tpu.cli.commet.

Given a file-of-files manifest (one line per read set,
"name: file[,bv]; file[,bv]; ..."), it:
  1. filters every read file into a .bv unless the manifest supplies bvs
     (Commet.py:103-121,557-562);
  2. runs the ordered 3-step refinement over every pair of sets
     (Commet.py:186-240): all-in-Si, then per later set X:
     Si in (X in Si), then X in (Si in (X in Si));
  3. writes matrix_plain/percentage/normalized.csv, byte-identical to the
     reference's (Commet.py:245-317), plus heatmap/dendrogram PNGs; with
     ``--one_vs_all`` only set 1 is compared with the others and
     vector_plain/percentage.csv are written instead (Commet.py:355-433).

Step 0 takes the amortized schedule by default (``run_amortized_rounds``):
the index sets stay resident on the device, as sorted indexes below the fill
gate (``build_sorted_residents``) and in plane cohorts above it
(``run_plane_cohorts``, ``build_plane_cohort``), and each query
set is searched once against all of them. ``COMMET_TPU_MULTI=0`` selects the
classic rounds, which also run, with a printed line, where neither amortized
form can serve the sets. ``--jobs N`` (and ``--sge``, which means
``--jobs 2``) runs the classic rounds as a job DAG on N host workers, set
loads beside the search that holds the card, and resumes from its
``.job_<name>.done`` markers (``run_scheduled``). The
outputs are the same either way. State flows through .bv files between
steps like the reference's subprocess pipeline.

``--devices N|all`` (COMMET_TPU_DEVICES) runs the engine on a mesh of N
distinct local cards (parallel/sharded.py; fewer cards than asked exit
non-zero), or with ``--device cpu`` N CPU shards; the amortized schedule
then declines and the classic rounds run. With COMMET_TPU_COORDINATOR /
_NUM_PROCESSES / _PROCESS_ID (parallel/distributed.py) several processes
share the work: rank 0 filters, all meet at a barrier, rank r runs rounds
r, r + P, ..., and each rank ends after its rounds with a line asking for
commet_analysis, which writes the matrices (the reference's --sge flow).
"""

from __future__ import annotations

import argparse
import os
import sys

from commet_tpu_torch import trace
from commet_tpu_torch.cli import filter_reads as filter_cli
from commet_tpu_torch.core import planes
from commet_tpu_torch.device import resolve_device
from commet_tpu_torch.engine.engine import DEFAULT_BATCH, Engine
from commet_tpu_torch.engine.scheduler import JobGraph
from commet_tpu_torch.io.bv import BitVector
from commet_tpu_torch.io.fof import (driver_read_bvs, driver_read_files,
                                     driver_set_names)
from commet_tpu_torch.io.reads import ReadSet
from commet_tpu_torch.parallel import distributed
from commet_tpu_torch.parallel.sharded import auto_mesh


# index sets of one plane cohort, at most (COMMET_TPU_PLANE_COHORT_MAX
# replaces it)
PLANE_COHORT_MAX = 8


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


def result_bvs(read_matrix, names, out_dir, i, j):
    """The paths of set i's <file>_in_<set j>.bv result vectors."""
    return [out_dir + os.path.basename(f) + "_in_"
            + os.path.basename(names[j]) + ".bv" for f in read_matrix[i]]


def step0_sets(read_matrix, bv_matrix, names, ref_id):
    """Step 0 of round ref_id (Commet.py:193-205): set ref_id to index and
    every later set to search in it."""
    index_set = _load_set(names[ref_id], read_matrix[ref_id],
                          bv_matrix[ref_id])
    queries = [_load_set(names[j], read_matrix[j], bv_matrix[j])
               for j in range(ref_id + 1, len(names))]
    return index_set, queries


def refine_sets(read_matrix, bv_matrix, names, out_dir, i, j):
    """Set i narrowed by its _in_<set j> results to index, set j to search
    in it: step a of pair (ref, X) is refine_sets(X, ref), step b
    refine_sets(ref, X) (Commet.py:211-238)."""
    narrow = _load_set(names[i], read_matrix[i],
                       result_bvs(read_matrix, names, out_dir, i, j))
    full = _load_set(names[j], read_matrix[j], bv_matrix[j])
    return narrow, [full]


def refine_pair(read_matrix, bv_matrix, names, out_dir, ref_id, j, eng):
    """Steps a/b of the 3-pass refinement for pair (ref_id, j)
    (Commet.py:211-238); needs the pair's step-0 result bvs on disk."""
    # STEP a: Si in (X in Si) - index X narrowed by its _in_Si bvs
    print(f" {names[ref_id]} in ({names[j]} in {names[ref_id]})")
    eng.index_and_search(*refine_sets(read_matrix, bv_matrix, names,
                                      out_dir, j, ref_id),
                         out_dir=out_dir, log_dir=out_dir)
    # STEP b: X in (Si in (X in Si)) - index Si narrowed by its _in_X bvs
    print(f" {names[j]} in ({names[ref_id]} in ({names[j]} in {names[ref_id]}))")
    eng.index_and_search(*refine_sets(read_matrix, bv_matrix, names,
                                      out_dir, ref_id, j),
                         out_dir=out_dir, log_dir=out_dir)


def compare_all_against(read_matrix, bv_matrix, names, out_dir, ref_id, eng):
    """One reference round (Commet.py:186-240): index Si and search every
    later set, then refine each pair; results chain through .bv files."""
    print(f"All in {names[ref_id]}")
    eng.index_and_search(*step0_sets(read_matrix, bv_matrix, names, ref_id),
                         out_dir=out_dir, log_dir=out_dir)
    for j in range(ref_id + 1, len(names)):
        refine_pair(read_matrix, bv_matrix, names, out_dir, ref_id, j, eng)


def run_scheduled(read_matrix, bv_matrix, names, out_dir, end, eng, jobs):
    """The classic rounds as a dependency DAG of jobs on ``jobs`` host
    workers (the reference's SGE hold_jid chains, Commet.py:186-240, run
    in-process): all_in_<i>, then per later set j <i>_in_<j> (step a), then
    <j>_in_<i> (step b). A job loads its sets on its worker and holds the
    device lock only for its search, so up to ``jobs`` - 1 jobs load while
    one searches.

    Resume: each completed job writes a ``.job_<name>.done`` marker next to
    its outputs after they are on disk; on a re-run, a job whose marker and
    outputs all exist is skipped. Delete a pair's outputs (or markers) to
    recompute just that pair. Job names, outputs and markers are
    commet_tpu's (_run_scheduled), so either package resumes the other's
    output directory."""
    g = JobGraph(workers=jobs)

    def add(name, load, outputs, deps=()):
        marker = os.path.join(out_dir, f".job_{name}.done")

        def run():
            sets = load()
            with g.device_lock:
                eng.index_and_search(*sets, out_dir=out_dir, log_dir=out_dir)
            with open(marker, "w") as f:
                f.write("done\n")

        def done():
            return (os.path.exists(marker)
                    and all(os.path.exists(p) for p in outputs))
        return g.add(name, run, deps=deps, done_check=done)

    def log(i, j):
        return out_dir + f"{names[i]}_in_{names[j]}.log"

    args = (read_matrix, bv_matrix, names)
    for i in range(end):
        later = range(i + 1, len(names))
        root = add(f"all_in_{i}", lambda i=i: step0_sets(*args, i),
                   [p for j in later
                    for p in result_bvs(read_matrix, names, out_dir, j, i)]
                   + [log(j, i) for j in later])
        for j in later:
            # pairs fan out independently after step 0, like the
            # reference's per-pair hold_jid chains (Commet.py:224,236)
            a = add(f"{i}_in_{j}",
                    lambda i=i, j=j: refine_sets(*args, out_dir, j, i),
                    result_bvs(read_matrix, names, out_dir, i, j)
                    + [log(i, j)], deps=[root])
            add(f"{j}_in_{i}",
                lambda i=i, j=j: refine_sets(*args, out_dir, i, j),
                result_bvs(read_matrix, names, out_dir, j, i) + [log(j, i)],
                deps=[a])
    g.run()


def run_amortized_rounds(read_matrix, bv_matrix, names, out_dir, end, eng):
    """The transposed all-vs-all schedule: every step-0 index set S_0 ..
    S_{end-1} is built once as a resident index, then each query set S_j
    streams once against all earlier residents (Engine.search_multi_set),
    and the a/b refinement steps run pairwise. Each pair's step-0 outcome
    depends only on its own two sets, so the outputs equal the classic
    rounds'. Where a set cannot stay resident as a sorted index (above the
    fill gate, over k or the device-memory budget) the plane cohorts take
    the step (run_plane_cohorts), as commet_tpu's driver does. Returns
    False, after printing why, when COMMET_TPU_MULTI=0, the cohorts decline
    or a query set's reads are too long for the batch geometry; the caller
    then runs the classic rounds. Counterpart of commet_tpu's
    run_amortized_rounds."""
    if os.environ.get("COMMET_TPU_MULTI", "1") == "0":
        print("schedule: classic rounds (COMMET_TPU_MULTI=0)")
        return False
    if eng.mesh is not None:
        print(f"schedule: classic rounds (a mesh of {len(eng.mesh)} "
              f"devices, {eng.mesh_mode} mode: the amortized schedule runs "
              "on one device)")
        return False
    env = os.environ.get("COMMET_TPU_RESIDENT_BUDGET")
    residents, total_bytes = build_sorted_residents(
        eng, lambda i: _load_set(names[i], read_matrix[i], bv_matrix[i]),
        end, float(env) if env else None)
    if len(residents) < end:
        declined = names[len(residents)]
        residents = None  # free the sorted residents before the planes
        return run_plane_cohorts(
            read_matrix, bv_matrix, names, out_dir, end, eng,
            f"{declined} cannot stay resident as a sorted index at "
            f"k={eng.k}: above the fill gate or the device-memory budget")
    print(f"schedule: amortized ({end} resident indexes, {total_bytes} "
          "device bytes)")
    for j in range(1, len(names)):
        targets = residents[:min(j, end)]
        rs_q = _load_set(names[j], read_matrix[j], bv_matrix[j])
        print(f"{names[j]} in {{{', '.join(r.name for r in targets)}}}")
        if eng.search_multi_set(rs_q, targets, out_dir=out_dir,
                                log_dir=out_dir) is None:
            print(f"schedule: classic rounds ({names[j]} has reads too long "
                  "for the stream batch geometry)")
            return False
    residents = targets = None  # free the device memory before refinement
    for i in range(end):
        for j in range(i + 1, len(names)):
            refine_pair(read_matrix, bv_matrix, names, out_dir, i, j, eng)
    return True


def build_sorted_residents(eng, load, end, budget):
    """The sorted residents of step 0: index sets 0 .. ``end`` - 1
    (``load(i) -> ReadSet``) built in turn as resident sorted indexes
    (Engine.build_resident), each within ``budget`` (None: the engine's own
    limits alone) less the residents built before it. Returns (the
    residents, their device bytes); the builds stop at the first set that
    cannot stay resident (a partition above the fill gate, k above
    RESIDENT_MAX_K, a mesh, or over the budget), so fewer than ``end``
    residents means that set ``len(residents)`` declined."""
    residents, total = [], 0
    for i in range(end):
        r = eng.build_resident(
            load(i), budget=None if budget is None else budget - total)
        if r is None:
            break
        residents.append(r)
        total += r.device_bytes()
    return residents, total


def build_plane_cohort(eng, load, start, end, budget, max_s):
    """One plane cohort of step 0: index sets ``start``, ``start + 1``, ...
    (``load(i) -> ReadSet``) built as resident plane sets
    (Engine.build_resident_planes) while they fit ``budget`` less the
    residents built before them, up to set ``end`` (excluded) and ``max_s``
    sets; every set after the first is built beside the residents with
    Engine.bulk_chunk(beside_residents=True). Each build runs under a
    ``cohort.build`` span (attributes ``resident``, the set's index,
    ``beside``, the residents already built, and ``chunk``). Returns (the
    residents, their device bytes); no resident where two plane sets exceed
    ``budget`` or set ``start`` does not fit it."""
    cohort, total = [], 0
    if 2 * planes.plane_bytes(eng.k) > budget:
        return cohort, total
    for i in range(start, min(end, start + max_s)):
        chunk = eng.bulk_chunk(beside_residents=bool(cohort))
        with trace.span("cohort.build", resident=i, beside=len(cohort),
                        chunk=chunk):
            r = eng.build_resident_planes(load(i), budget=budget - total,
                                          bulk_chunk=chunk)
        if r is None:
            break
        cohort.append(r)
        total += r.device_bytes()
    return cohort, total


def run_plane_cohorts(read_matrix, bv_matrix, names, out_dir, end, eng,
                      why):
    """Step 0 of the all-vs-all schedule where the index sets cannot stay
    resident as sorted indexes (``why``): the index sets S_0 .. S_{end-1}
    are built as resident plane sets in contiguous cohorts of at most
    COMMET_TPU_PLANE_COHORT_MAX (PLANE_COHORT_MAX) sets within the
    device-memory budget (the free memory less the build and probe
    workspace, and COMMET_TPU_PLANES_BUDGET when set:
    Engine._planes_budget) by build_plane_cohort, each query set is probed
    against its cohort predecessors with one upload per batch
    (Engine.search_multi_set_planes), then the refinement runs pairwise. A
    set built beside resident plane sets takes the smaller bulk-build chunk
    (Engine.bulk_chunk(beside_residents=True): 2^26 window slots at k >= 32
    unless COMMET_TPU_BULK_CHUNK is set). Pair results equal the classic
    rounds'. Returns False, after printing why, when fewer than two index
    sets need the step or two plane sets do not fit the budget; the caller
    then runs the classic rounds. Counterpart of commet_tpu's
    run_plane_cohorts."""
    env_budget = os.environ.get("COMMET_TPU_PLANES_BUDGET")
    budget = eng._planes_budget(float(env_budget) if env_budget else None)
    max_s = int(os.environ.get("COMMET_TPU_PLANE_COHORT_MAX",
                               str(PLANE_COHORT_MAX)))
    declined = None
    if end < 2:
        declined = "one index set: nothing to amortize"
    elif 2 * planes.plane_bytes(eng.k) > budget:
        declined = (f"two plane sets of {planes.plane_bytes(eng.k)} B exceed "
                    f"the plane budget of {budget:.0f} B")
    i = 0
    while declined is None and i < end:
        cohort, total = build_plane_cohort(
            eng, lambda j: _load_set(names[j], read_matrix[j], bv_matrix[j]),
            i, end, budget, max_s)
        if not cohort:
            declined = (f"{names[i]}'s plane sets exceed the plane budget of "
                        f"{budget:.0f} B")
            break
        first = i
        i += len(cohort)
        print(f"schedule: plane cohorts ({', '.join(r.name for r in cohort)}"
              f" resident as planes, {total} device bytes"
              f"{'; ' + why if first == 0 else ''})")
        for j in range(first + 1, len(names)):
            targets = cohort[:min(j - first, len(cohort))]
            rs_q = _load_set(names[j], read_matrix[j], bv_matrix[j])
            print(f"{names[j]} in {{{', '.join(r.name for r in targets)}}}"
                  " [plane cohort]")
            eng.search_multi_set_planes(rs_q, targets, out_dir=out_dir,
                                        log_dir=out_dir)
        cohort = targets = None  # free the planes before the next cohort
    if declined is not None:
        print(f"schedule: classic rounds ({why}; the plane cohorts "
              f"decline: {declined})")
        return False
    for a in range(end):
        for j in range(a + 1, len(names)):
            refine_pair(read_matrix, bv_matrix, names, out_dir, a, j, eng)
    return True


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
            from commet_tpu_torch.viz.plots import (dendrogram_png,
                                                    heatmap_png)
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


def output_vectors(read_matrix, bv_matrix, names, out_dir):
    """--one_vs_all outputs vector_plain.csv / vector_percentage.csv,
    byte-identical to Commet.py:355-433, with its 'shared/reverse' cell
    format: cell j holds set 1's reads shared with set j, then set j's
    reads shared with set 1 (set sizes on the diagonal)."""
    number_reads_all_sets = [sum(bv_count(b) for b in bv_matrix[i])
                             for i in range(len(names))]

    def shared(i, j):
        if i == j:
            return number_reads_all_sets[i]
        return sum(bv_count(out_dir + os.path.basename(f) + "_in_"
                            + names[j] + ".bv") for f in read_matrix[i])

    cells = [(shared(0, j), shared(j, 0)) for j in range(len(names))]
    header = "".join(";" + name for name in names)
    with open(out_dir + "vector_plain.csv", "w") as f:
        f.write(header + "\n" + names[0])
        for fwd, rev in cells:
            f.write(";" + str(fwd) + "/" + str(rev))
        f.write("\n")
    with open(out_dir + "vector_percentage.csv", "w") as f:
        f.write(header + "\n" + names[0])
        for j, (fwd, rev) in enumerate(cells):
            v1 = 100 * fwd / float(number_reads_all_sets[0])
            v2 = 100 * rev / float(number_reads_all_sets[j])
            f.write(";" + py2_str_float(v1) + "/" + py2_str_float(v2))
        f.write("\n")

    print("All Commet work is done")
    print("\t\t" + out_dir + "vector_plain.csv")
    print("\t\t" + out_dir + "vector_percentage.csv")


def _devices_arg(value: str) -> str:
    if value != "all" and not (value.isdigit() and int(value) >= 1):
        raise argparse.ArgumentTypeError(
            f"{value!r}: a count of at least 1, or 'all'")
    return value


def main(argv=None) -> int:
    distributed.init_distributed()  # no-op without COMMET_TPU_COORDINATOR
    parser = argparse.ArgumentParser(
        description="Computes the filtering and the full N x N intersections "
                    "of read sets (PyTorch / CUDA)")
    parser.add_argument("input_file", type=str)
    parser.add_argument("--sge", action="store_true",
                        help="compatibility alias for --jobs 2 (the "
                             "reference's SGE cluster mode becomes an "
                             "in-process dependency-scheduled job DAG)")
    parser.add_argument("--one_vs_all", action="store_true",
                        help="compare set 1 with each other set only")
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
    parser.add_argument("--devices", type=_devices_arg, default=None,
                        help="number of local cards to use, or 'all' (sets "
                             "COMMET_TPU_DEVICES; fewer cards than asked "
                             "exit non-zero); with --device cpu, CPU "
                             "shards. The planes replicate and the read "
                             "batches split when they fit a card, else "
                             "the planes shard")
    parser.add_argument("--jobs", type=int, default=1,
                        help="run the pipeline as a dependency-scheduled job "
                             "DAG with N host workers (the reference's --sge "
                             "equivalent; jobs load their sets in parallel, "
                             "their searches serialize)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; fails without a card) or cpu")
    args = parser.parse_args(argv)
    if args.sge and args.jobs == 1:
        print("SGE mode requested: running as an in-process job DAG")
        args.jobs = 2
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

    # several processes (COMMET_TPU_COORDINATOR): each owns a stride of the
    # comparison rounds over the shared filesystem, as the reference's SGE
    # jobs do (Commet.py:204-236); the matrices are left to commet_analysis
    nprocs = distributed.process_count()
    rank = distributed.process_index()

    read_matrix = driver_read_files(args.input_file)
    names = driver_set_names(args.input_file)
    bv_matrix = driver_read_bvs(args.input_file)
    if bv_matrix is None:
        # only rank 0 filters (concurrent writers of one .bv would race);
        # the others wait for it at the barrier
        if distributed.is_primary():
            print("Reads were not filtered, we filter them.")
            filter_all_reads(read_matrix, out_dir, l, args.n, args.e, args.m)
        distributed.barrier()
        bv_matrix = [[out_dir + os.path.basename(f) + ".bv" for f in line]
                     for line in read_matrix]

    if args.devices:
        os.environ["COMMET_TPU_DEVICES"] = args.devices
    eng = Engine(k=k, t=t, device=device, batch=args.batch,
                 mesh=auto_mesh(device))
    end = 1 if args.one_vs_all else len(read_matrix) - 1
    if args.jobs > 1:
        run_scheduled(read_matrix, bv_matrix, names, out_dir, end, eng,
                      args.jobs)
    elif not (nprocs == 1 and run_amortized_rounds(
            read_matrix, bv_matrix, names, out_dir, end, eng)):
        for ref_id in range(rank, end, nprocs):
            compare_all_against(read_matrix, bv_matrix, names, out_dir,
                                ref_id, eng)
    if nprocs > 1:
        print("multi-host run: rank %d/%d finished its rounds; run "
              "commet_analysis after all ranks complete to aggregate "
              "matrices" % (rank, nprocs))
        return 0
    if args.one_vs_all:
        output_vectors(read_matrix, bv_matrix, names, out_dir)
    else:
        output_matrices(read_matrix, bv_matrix, names, out_dir,
                        plots=args.plots)
    return 0


def entry() -> None:
    """console_scripts entry point (pyproject.toml)."""
    from commet_tpu_torch.cli.util import guarded
    sys.exit(guarded(main))


if __name__ == "__main__":
    entry()
