"""File-of-files manifest parsing, the port's copy of commet_tpu/io/fof.py.

Two dialects exist in the reference and both are reproduced:

  - the C++ tool parser (include/set_parser.h:46-102): used by
    index_and_search/compare_reads; returns a dict keyed by set name
    (duplicate names overwrite, like std::map), unnamed lines get "SET<n>";
  - the Python driver parser (Commet.py:42-95): keeps lines as an ordered
    list; a line is "name:file,bv;file,bv;...".
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple


def _remove_spaces(s: str) -> str:
    """Strip leading/trailing ' ' only (reference set_parser.h:32-40)."""
    return s.strip(" ")


def parse_sets(path: str) -> Dict[str, List[Tuple[str, str]]]:
    """The C++ read_sets() parser. Returns {set_name: [(file, bv), ...]}
    with '' for a missing bv. Iteration order is SORTED by set name to
    mirror std::map (reference index_and_search.cpp:218)."""
    file_names: Dict[str, List[Tuple[str, str]]] = {}
    nb_sets = 0
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            nb_sets += 1
            if ":" in line:
                tag = line[: line.find(":")]
                line = line[line.find(":") + 1 :]
            else:
                tag = f"SET{nb_sets}"
            entries = []
            for part in line.split(";"):
                part = _remove_spaces(part)
                if "," in part:
                    fname, bv = part.split(",", 1)
                    entries.append((_remove_spaces(fname), _remove_spaces(bv)))
                else:
                    entries.append((part, ""))
            file_names[tag] = entries
    return dict(sorted(file_names.items()))


def driver_read_files(path: str) -> List[List[str]]:
    """Commet.py getReadFiles (Commet.py:42-55): per line the list of read
    file paths (bv part dropped)."""
    matrix = []
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            body = line.split(":")[1]
            tab = body[:-1].split(";") if body.endswith("\n") else body.split(";")
            matrix.append([t.strip().split(",")[0] for t in tab])
    return matrix


def driver_read_bvs(path: str) -> Optional[List[List[str]]]:
    """Commet.py getReadBVFiles (Commet.py:68-85): None when the first line
    has no ',', else the per-line bv paths."""
    with open(path) as f:
        first = f.readline()
    if "," not in first:
        return None
    matrix = []
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            body = line.split(":")[1]
            tab = body[:-1].split(";") if body.endswith("\n") else body.split(";")
            matrix.append([t.strip().split(",")[1] for t in tab])
    return matrix


def driver_set_names(path: str) -> List[str]:
    """Commet.py getReadSetsNames (Commet.py:87-95)."""
    names = []
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            names.append(line.split(":")[0].strip())
    return names
