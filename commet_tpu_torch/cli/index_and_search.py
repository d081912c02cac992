"""index_and_search CLI (reference src/index_and_search.cpp), PyTorch port.

Indexes one read set and classifies one or more query sets against it,
writing <file>_in_<IndexSet>.bv result vectors and per-pair .log files.
``-f`` runs the full 3-pass two-set comparison in one invocation
(index_and_search.cpp:304-391). Same flags, defaults, stdout and files as
commet_tpu.cli.index_and_search, plus ``--device`` (default cuda; cuda
without a card exits non-zero). COMMET_TPU_DEVICES=N|all runs the engine on
a mesh of N local devices (parallel/sharded.auto_mesh).
"""

from __future__ import annotations

import os
import sys

from commet_tpu_torch.device import resolve_device
from commet_tpu_torch.engine.engine import Engine
from commet_tpu_torch.io.fof import parse_sets
from commet_tpu_torch.io.reads import ReadSet
from commet_tpu_torch.parallel.distributed import init_distributed
from commet_tpu_torch.parallel.sharded import auto_mesh


def load_set(name: str, entries) -> ReadSet:
    rs = ReadSet(name)
    for fname, bvname in entries:
        print(f"open {fname},{bvname}" if bvname else f"open {fname}")
        rs.add_file(fname, bvname or None)
    return rs


def full_compare(eng: Engine, a: ReadSet, b: ReadSet, out_path: str,
                 log_path: str) -> None:
    """The 3-pass two-set comparison (index_and_search.cpp:304-391,
    compare_reads.cpp:240-333): pass 1 tags B in A unsaved; pass 2 indexes
    B narrowed to (B in A) and searches A -> <A>_in_<B>.bv; pass 3 indexes
    A narrowed to (A in (B in A)) and searches B -> <B>_in_<A>.bv."""
    eng.index_and_search(a, [b], out_dir=out_path, log_dir=log_path,
                         save=False)
    b.apply_result_as_filter()
    eng.index_and_search(b, [a], out_dir=out_path, log_dir=log_path,
                         save=True)
    a.apply_result_as_filter()
    eng.index_and_search(a, [b], out_dir=out_path, log_dir=log_path,
                         save=True)


VERSION = "2.1-torch"

USAGE = """
index_and_search, version %s
Usage : index_and_search -i <file> -s <file> [options]
Mandatory:
\t -i <file>: A file containing the list of files to index - MANDATORY
\t -s <file>: A file containing the list of files to search - MANDATORY
\t            Each line of the file corresponds to a set of files to search
Options:
\t -l </.../>: path to log folder
\t -o </.../>: path to output folder
\t -k <value>: Size of k-mers (value of k). [default=33]
\t -t <value>: Number of shared k-mers. [default=2]
\t -f: Full comparison of index set and the first searched set [default=false]
\t --device <name>: cuda or cpu [default=cuda]
\t -h: Prints this message
\t -v: Prints the version number
""" % VERSION

_VALUED = ('-i', '-s', '-l', '-o', '-k', '-t', '--device')


def main(argv=None) -> int:
    init_distributed()  # no-op without COMMET_TPU_COORDINATOR
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(USAGE, file=sys.stderr)
        return 0
    index_file_list = ""
    search_file_list = ""
    kmer_size = 33
    min_hits = 2
    log_path = "."
    out_path = "."
    full = False
    device = "cuda"

    if argv[-1] in _VALUED:
        print(f"Error, flag {argv[-1]} needs an argument", file=sys.stderr)
        sys.exit(1)
    i = 0
    while i < len(argv):
        flag = argv[i]
        if flag == "-i":
            i += 1
            index_file_list = argv[i]
        elif flag == "-s":
            i += 1
            search_file_list = argv[i]
        elif flag == "-l":
            i += 1
            log_path = argv[i]
        elif flag == "-o":
            i += 1
            out_path = argv[i]
        elif flag == "-k":
            i += 1
            kmer_size = int(argv[i])
            print(f"k-mer size (-k) = {kmer_size}")
        elif flag == "-t":
            i += 1
            min_hits = int(argv[i])
            print(f"min hits (-t) = {min_hits}")
        elif flag == "--device":
            i += 1
            device = argv[i]
        elif flag == "-f":
            full = True
        elif flag == "-h":
            print(USAGE, file=sys.stderr)
            return 0
        elif flag == "-v":
            print(f"\nindex_and_search version {VERSION}")
            return 0
        else:
            print(f"Unknown option {flag}", file=sys.stderr)
            print(USAGE, file=sys.stderr)
            return 0
        i += 1

    if not index_file_list or not search_file_list:
        print("Error: -i and -s are mandatory", file=sys.stderr)
        print(USAGE, file=sys.stderr)
        sys.exit(1)
    dev = resolve_device(device)
    eng = Engine(k=kmer_size, t=min_hits, device=dev, mesh=auto_mesh(dev))
    os.makedirs(log_path, exist_ok=True)
    os.makedirs(out_path, exist_ok=True)

    index_sets = parse_sets(index_file_list)
    if len(index_sets) != 1:
        print("Only one set of files is allowed for indexing", file=sys.stderr)
        sys.exit(1)
    (iname, ientries), = index_sets.items()
    index_set = load_set(iname, ientries)

    query_sets = []
    for qname, qentries in parse_sets(search_file_list).items():
        query_sets.append(load_set(qname, qentries))  # sorted, like std::map
        if full:
            break  # full mode only uses the first (map-ordered) set

    if full:
        full_compare(eng, index_set, query_sets[0], out_path, log_path)
    else:
        eng.index_and_search(index_set, query_sets, out_dir=out_path,
                             log_dir=log_path)
    return 0


def entry() -> None:
    """console_scripts entry point (pyproject.toml)."""
    from commet_tpu_torch.cli.util import guarded
    sys.exit(guarded(main))


if __name__ == "__main__":
    entry()
