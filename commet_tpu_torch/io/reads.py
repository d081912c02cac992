"""Host-side read-file layer of the port: fasta/fastq (+gzip) read sets,
encoded one byte a base (codes 0-4) by the port's native library
(native/parser.py), and the full
record text that extract_reads needs, parsed in Python when first read. The
port's copy of commet_tpu/io/reads.py, less its pure-Python encoder: the
native library is the only parse of the codes, and a build that fails
raises.

Parsing semantics are byte-compatible with the reference readers:
  - format sniffing by the first decompressed byte, '>' = fasta, '@' = fastq
    (reference include/file_manager.h:117-157);
  - fasta: a read per '>' line, sequence = concatenation of the following
    non-empty lines, lines split on '\\n' only (CR kept, like C++ getline)
    (reference include/fasta_file.h:62-68,143-175);
  - fastq: read count = non-empty lines // 4; per record the sequence is the
    line immediately after the (empty-line-skipping) header line
    (reference include/fastq_file.h:60-67,131-206).

Encoding: bases map to 2-bit codes A=0 C=1 G=2 T=3 (case-insensitive); any
other byte (the reference's "N" class, include/alphabet.h:44-58) maps to
code 4 = invalid, which resets the rolling hash window exactly like
``hash.clear()`` in the reference.
"""

from __future__ import annotations

import gzip
import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from commet_tpu_torch import trace
from commet_tpu_torch.io.bv import BitVector
from commet_tpu_torch.native import parser as native

# byte -> 2-bit code LUT; 4 marks an invalid (non-ACGT) byte
CODE_LUT = np.full(256, 4, dtype=np.uint8)
for _c, _v in ((b"Aa", 0), (b"Cc", 1), (b"Gg", 2), (b"Tt", 3)):
    CODE_LUT[_c[0]] = _v
    CODE_LUT[_c[1]] = _v

def parse_fasta(raw: bytes) -> List[bytes]:
    """Each read's full record text: the header and the non-empty sequence
    lines, '\n'-joined and '\n'-terminated (CR bytes kept)."""
    recs: List[bytes] = []
    cur: Optional[list] = None
    for ln in raw.split(b"\n"):
        if ln[:1] == b">":
            if cur is not None:
                recs.append(b"\n".join(cur) + b"\n")
            cur = [ln]
        elif cur is not None and ln:
            cur.append(ln)
    if cur is not None:
        recs.append(b"\n".join(cur) + b"\n")
    return recs


def parse_fastq(raw: bytes) -> List[bytes]:
    """Each read's four-line record, by the reference's walk: read count =
    non-empty lines // 4 (fastq_file.h:60-67), the sequence the line right
    after each empty-line-skipped header (fastq_file.h:154-173)."""
    lines = raw.split(b"\n")
    nlines = len(lines)
    nb_reads = sum(1 for ln in lines if ln) // 4
    recs: List[bytes] = []
    i = 0

    def skip_empty(j):
        while j < nlines and not lines[j]:
            j += 1
        return j

    def line(j):
        return lines[j] if j < nlines else b""

    for _ in range(nb_reads):
        i = skip_empty(i)
        if i >= nlines:
            break
        header, seq = lines[i], line(i + 1)
        i = skip_empty(i + 2)
        plus = line(i)
        i = skip_empty(i + 1)
        qual = line(i)
        i += 1
        recs.append(b"\n".join((header, seq, plus, qual)) + b"\n")
    return recs


class ReadFile:
    """One read file: encoded reads + the per-read *filter* bit vector.

    Mirrors the reference ReadFile (include/read_file.h:35): ``filter_bv``
    selects which reads exist for downstream consumers; the result vector
    (owned by ReadSet) accumulates search tags. The native library parses
    and encodes the file; the record text is parsed in Python when
    ``records`` is first read. ``held`` is None until ``move_to`` moves
    the codes, offsets and lengths into host tensors; ``uploads`` counts
    the file's uploads to a card, for the engine's choice to move it.
    """

    def __init__(self, path: str, bv_path: Optional[str] = None):
        self.path = path
        if not os.path.exists(path):
            # reference readers exit(1) with this message
            # (include/fasta_file.h:55-57). exists (not isfile): the
            # reference's ifstream reads FIFOs/process substitution too
            raise FileNotFoundError(2, "Cannot open read file", path)
        d = native.parse_file(path)
        self.fmt = d["format"]
        self.was_gzipped = d["gzipped"]
        self._codes = d["codes"]
        self._offsets = d["offsets"]
        self._lengths = d["lengths"]
        self._class_counts = d["class_counts"]
        self._invalid_at = np.flatnonzero(self._class_counts[:, 4])
        self.nb_reads = d["n_reads"]
        self._records: Optional[List[bytes]] = None
        self.held: Optional[Tuple[torch.Tensor, ...]] = None
        self.uploads = 0

        if bv_path:
            bv = BitVector.read(bv_path)
            if bv.size != self.nb_reads:
                raise ValueError(
                    f"Number of reads in {path} and boolean vector size are "
                    f"not equal")
        else:
            bv = BitVector(self.nb_reads, fill=True)
        self.filter_bv = bv

    @property
    def records(self) -> List[bytes]:
        """Each read's full record text, in file order."""
        if self._records is None:
            with (gzip.open if self.was_gzipped else open)(self.path,
                                                           "rb") as f:
                raw = f.read()
            self._records = (parse_fasta(raw) if self.fmt == "fasta"
                             else parse_fastq(raw))
        return self._records

    def encoded(self):
        """(flat_codes uint8, offsets int64 [N+1], lengths int32 [N])."""
        return self._codes, self._offsets, self._lengths

    def move_to(self, alloc) -> None:
        """Move the codes, offsets and lengths into host tensors that
        ``alloc(shape, dtype=...)`` makes (the engine's page-locked memory,
        from which copies to a card run as DMA): ``held`` keeps the tensors
        (codes, offsets, lengths) and their memory as long as the file
        lives, ``encoded`` returns numpy views of them, and the parse's
        arrays go."""
        held = []
        for a in self.encoded():
            src = torch.from_numpy(a)
            held.append(alloc(src.shape, dtype=src.dtype).copy_(src))
        self.held = tuple(held)
        self._codes, self._offsets, self._lengths = (t.numpy() for t in held)

    def class_counts(self):
        """Per-read (A,C,G,T,other) counts + lengths, for the filter."""
        return self._class_counts, self._lengths.astype(np.int64)

    def invalid_reads(self) -> np.ndarray:
        """Per read, whether it holds a base other than A, C, G or T."""
        out = np.zeros(len(self._lengths), dtype=bool)
        out[self._invalid_at] = True
        return out

    def invalid_positions(self) -> np.ndarray:
        """The positions of the reads that hold a base other than A, C, G
        or T, ascending."""
        return self._invalid_at


def load_read_file(path: str, bv_path: Optional[str] = None) -> ReadFile:
    """Open a read file, count reads, attach its filter bit vector
    (all-true when ``bv_path`` is None, reference fasta_file.h:49-116)."""
    return ReadFile(path, bv_path)


def basename(path: str) -> str:
    """The reference's basename: everything after the last '/'
    (file_manager.h:247)."""
    return path[path.rfind("/") + 1:]


class ReadSet:
    """An ordered collection of read files forming one (virtual) read set,
    with per-file filter and result bit vectors.

    Mirrors the reference FileManager (include/file_manager.h:39): reads
    stream in file order; a read is *eligible* when its filter bit is set;
    search passes additionally skip reads already tagged in the result
    vector (file_manager.h:99-109).
    """

    def __init__(self, name: str = ""):
        self.name = name
        self.files: List[ReadFile] = []
        self.result_bvs: List[BitVector] = []

    def add_file(self, path: str, bv_path: Optional[str] = None) -> None:
        rf = load_read_file(path, bv_path)
        self.files.append(rf)
        self.result_bvs.append(BitVector(rf.nb_reads))

    @staticmethod
    def _rows(masks) -> np.ndarray:
        """(file_idx, read_pos) rows of the set bits of each file's packed
        mask (BitVector bytes and size), filled into one array."""
        pos = [np.flatnonzero(np.unpackbits(data, bitorder="little")[:size])
               for data, size in masks]
        out = np.empty((sum(len(p) for p in pos), 2), dtype=np.int64)
        at = 0
        for fi, p in enumerate(pos):
            out[at:at + len(p), 0] = fi
            out[at:at + len(p), 1] = p
            at += len(p)
        return out

    def eligible(self):
        """Global list of eligible reads as (file_idx, read_pos) pairs in
        streaming order (filter bit set)."""
        return self._rows((f.filter_bv.data, f.filter_bv.size)
                          for f in self.files)

    def untagged_eligible(self):
        """Eligible reads whose result bit is still 0 (search candidates,
        file_manager.h:99-109)."""
        return self._rows((f.filter_bv.data & ~r.data, r.size)
                          for f, r in zip(self.files, self.result_bvs))

    def tag(self, file_idx: np.ndarray, read_pos: np.ndarray) -> None:
        if len(self.result_bvs) == 1:
            # every row is in the one file
            self.result_bvs[0].set_many(read_pos)
            return
        for fi in np.unique(file_idx):
            self.result_bvs[fi].set_many(read_pos[file_idx == fi])

    def apply_result_as_filter(self) -> None:
        """The reference's apply_bv_on_files(): result vectors become the
        new filter vectors; results reset (file_manager.h:277-285)."""
        for f, r in zip(self.files, self.result_bvs):
            f.filter_bv = r.copy()
        for r in self.result_bvs:
            r.set_all_false()

    def save_result_bvs(self, directory: str, suffix: str) -> None:
        """Write per-file result vectors as <dir>/<basename>_in_<suffix>.bv
        with comment '<path> in <suffix>' (file_manager.h:245-252)."""
        with trace.span("io.write"):
            for f, r in zip(self.files, self.result_bvs):
                out = os.path.join(directory, basename(f.path) + "_in_"
                                   + suffix + ".bv")
                r.comment = f.path + " in " + suffix
                r.write(out)
