"""Read sets made from the seed: frozen copies of ``chip_smoke.py``'s set
makers (``make_pair``, ``_implant``, ``_write_fasta``), adapted to any
number of sets of any size.

Every set is drawn from ``numpy.random.default_rng(seed)`` only. Bases are
drawn four to a random byte (``rng.bytes``), a quarter of the draws that
``rng.integers`` would take, and the fasta text is made by table lookups
of two bases and four header digits at a time, so that set-up stays short;
the layouts (fragments, the bases beside them, the reads that carry an N)
and the fasta bytes are the makers'. Codes: 0..3 = A, C, G, T, 4 = N.

The layouts are assumed traffic, not measured from real samples: no
public figure of the reads two metagenomic samples share, or of the k-mers
repeated within one, stands behind them. Half of each query set's reads
hold one fragment of the index set and every other base is uniform, so no
k-mer repeats within a set; the share of tagged reads, where the probe can
stop, and the planes' fill all follow from that.
"""

from __future__ import annotations

import os

import numpy as np


def _quads() -> np.ndarray:
    """byte -> its four 2-bit codes, low bits first, as the four bytes of
    a little-endian uint32."""
    codes = (np.arange(256, dtype=np.uint32)[:, None]
             >> (2 * np.arange(4, dtype=np.uint32))) & 3
    return (codes << (8 * np.arange(4, dtype=np.uint32))).sum(
        axis=1).astype("<u4")


def _ascii_pairs() -> np.ndarray:
    """two codes (a uint16, first code in the low byte) -> their two
    letters of b"ACGTN" as a little-endian uint16."""
    letters = np.frombuffer(b"ACGTN", np.uint8).astype(np.uint16)
    out = np.zeros(1 << 16, dtype="<u2")
    for a in range(5):
        for b in range(5):
            out[a | b << 8] = letters[a] | letters[b] << 8
    return out


def _digit_quads() -> np.ndarray:
    """0..9999 -> its four ASCII digits as a little-endian uint32."""
    n = np.arange(10000)
    digits = (n[:, None] // 10 ** np.arange(3, -1, -1)) % 10 + ord("0")
    return (digits.astype(np.uint32) << (8 * np.arange(4, dtype=np.uint32))
            ).sum(axis=1).astype("<u4")


_QUADS = _quads()
_PAIRS = _ascii_pairs()
_DIGITS = _digit_quads()


def random_reads(rng, n_reads: int, read_len: int) -> np.ndarray:
    """[n_reads, read_len] uint8 codes 0..3, uniform."""
    n_bases = n_reads * read_len
    raw = np.frombuffer(rng.bytes(-(-n_bases // 4)), dtype=np.uint8)
    return _QUADS[raw].view(np.uint8)[:n_bases].reshape(n_reads, read_len)


def implant(rng, query: np.ndarray, donor: np.ndarray, rows: np.ndarray,
            donor_rows: np.ndarray, frag: int):
    """Copy a ``frag`` bp fragment of a random ``donor_rows`` read of
    ``donor`` into each ``rows`` read of ``query``; the bases beside each
    fragment are made to differ from the donor's, so a shared window never
    extends past it. Returns the donor row of each fragment and whether the
    fragment is N-free (chip_smoke._implant)."""
    read_len = query.shape[1]
    donors = donor_rows[rng.integers(0, len(donor_rows), len(rows))]
    src = rng.integers(0, read_len - frag + 1, len(rows))
    dst = rng.integers(0, read_len - frag + 1, len(rows))
    off = np.arange(frag)
    fragments = donor[donors[:, None], src[:, None] + off]
    query[rows[:, None], dst[:, None] + off] = fragments
    for side, ok in ((-1, (src > 0) & (dst > 0)),
                     (frag, (src + frag < read_len)
                      & (dst + frag < read_len))):
        r, qs, ds = rows[ok], dst[ok] + side, src[ok] + side
        query[r, qs] = (donor[donors[ok], ds] + 1) % 4
    return donors, (fragments < 4).all(axis=1)


def add_ns(rng, codes: np.ndarray, candidates: np.ndarray,
           share: float) -> None:
    """One N in each of ``share`` of the reads, drawn among
    ``candidates``."""
    n = int(len(codes) * share)
    rows = rng.choice(candidates, min(n, len(candidates)), replace=False)
    codes[rows, rng.integers(0, codes.shape[1], len(rows))] = 4


def make_cohort(seed: int, residents, queries, read_len: int, frag: int,
                n_share: float):
    """Index sets of ``residents`` reads each and query sets of ``queries``
    reads each, laid out as chip_smoke.make_pair lays out its pair: each
    query set's even reads hold a ``frag`` bp fragment of a random read of
    the first index set, and ``n_share`` of each set's reads carry one N,
    drawn among the reads that neither hold nor give a fragment. Returns
    (index codes, query codes), lists of [n, read_len] uint8 arrays."""
    rng = np.random.default_rng(seed)
    index = [random_reads(rng, n, read_len) for n in residents]
    query = [random_reads(rng, n, read_len) for n in queries]
    used_index = np.zeros(len(index[0]), dtype=bool)
    used_query = []
    for q in query:
        even = np.arange(0, len(q), 2)
        donors, _clean = implant(rng, q, index[0], even,
                                 np.arange(len(index[0])), frag)
        used_index[donors] = True
        used = np.zeros(len(q), dtype=bool)
        used[even] = True
        used_query.append(used)
    for i, s in enumerate(index):
        used = used_index if i == 0 else np.zeros(len(s), dtype=bool)
        add_ns(rng, s, np.nonzero(~used)[0], n_share)
    for q, used in zip(query, used_query):
        add_ns(rng, q, np.nonzero(~used)[0], n_share)
    return index, query


def write_fasta(path: str, codes: np.ndarray) -> None:
    """[n, L] codes (0..3, 4 = N) -> fasta with headers >r<8 digits>
    (chip_smoke._write_fasta), written in blocks of a million reads."""
    n_all, length = codes.shape
    if n_all > 10 ** 8:
        raise ValueError(f"{n_all} reads: headers hold 8 digits")
    with open(path, "wb") as f:
        for start in range(0, n_all, 1 << 20):
            block = np.ascontiguousarray(codes[start:start + (1 << 20)])
            n = len(block)
            ids = np.arange(start, start + n)
            rec = np.empty((n, 12 + length), dtype=np.uint8)
            rec[:, 0], rec[:, 1] = ord(">"), ord("r")
            rec[:, 2:10] = np.stack([_DIGITS[ids // 10000],
                                     _DIGITS[ids % 10000]],
                                    axis=1).view(np.uint8)
            rec[:, 10] = rec[:, 11 + length] = ord("\n")
            flat = block.reshape(-1)
            if len(flat) % 2:
                flat = np.concatenate([flat, [0]]).astype(np.uint8)
            body = _PAIRS[flat.view("<u2")].view(np.uint8)
            rec[:, 11:11 + length] = body[:n * length].reshape(n, length)
            f.write(rec)


def write_sets(directory: str, names, sets) -> list:
    """Each set as ``<directory>/<name>.fa``; returns the paths."""
    os.makedirs(directory, exist_ok=True)
    paths = []
    for name, codes in zip(names, sets):
        paths.append(os.path.join(directory, name + ".fa"))
        write_fasta(paths[-1], codes)
    return paths
