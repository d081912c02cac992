"""compare_reads CLI - standalone symmetric two-set comparison via the
Compareads 3-pass false-positive refinement (reference src/compare_reads.cpp):
pass 1: B restricted to (B in A); pass 2: A in (B in A) -> <A>_in_<B>.bv;
pass 3: B in (A in (B in A)) -> <B>_in_<A>.bv.
--device <name>: cuda (default; fails without a card) or cpu.
"""

from __future__ import annotations

import os
import sys

from commet_tpu_torch.cli.index_and_search import full_compare
from commet_tpu_torch.device import resolve_device
from commet_tpu_torch.engine.engine import Engine
from commet_tpu_torch.io.fof import parse_sets
from commet_tpu_torch.io.reads import ReadSet
from commet_tpu_torch.parallel.distributed import init_distributed
from commet_tpu_torch.parallel.sharded import auto_mesh

_VALUED = ('-i', '-s', '-l', '-o', '-k', '-t', '--device')


def _load(name, entries):
    rs = ReadSet(name)
    for fname, bvname in entries:
        rs.add_file(fname, bvname or None)
    return rs


def main(argv=None) -> int:
    init_distributed()  # no-op without COMMET_TPU_COORDINATOR
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(__doc__, file=sys.stderr)
        return 0
    index_file_list = ""
    search_file_list = ""
    kmer_size = 33
    min_hits = 2
    log_path = "."
    out_path = "."
    device = "cuda"
    i = 0
    if argv[-1] in _VALUED:
        print(f"Error, flag {argv[-1]} needs an argument",
              file=sys.stderr)
        sys.exit(1)
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
        elif flag == "-t":
            i += 1
            min_hits = int(argv[i])
        elif flag == "--device":
            i += 1
            device = argv[i]
        elif flag == "-h":
            print(__doc__)
            return 0
        i += 1

    if not index_file_list or not search_file_list:
        print("Error: -i and -s are mandatory", file=sys.stderr)
        print(__doc__, file=sys.stderr)
        sys.exit(1)
    dev = resolve_device(device)
    os.makedirs(log_path, exist_ok=True)
    os.makedirs(out_path, exist_ok=True)

    (iname, ientries), = parse_sets(index_file_list).items()
    a = _load(iname, ientries)
    qname, qentries = next(iter(parse_sets(search_file_list).items()))
    b = _load(qname, qentries)

    full_compare(Engine(k=kmer_size, t=min_hits, device=dev,
                        mesh=auto_mesh(dev)), a, b, out_path, log_path)
    return 0


def entry() -> None:
    """console_scripts entry point (pyproject.toml)."""
    from commet_tpu_torch.cli.util import guarded
    sys.exit(guarded(main))


if __name__ == "__main__":
    entry()
