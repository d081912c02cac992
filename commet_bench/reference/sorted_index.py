"""The sorted index of a partition, plainly, in PyTorch and NumPy: the
distinct (keya, keyb) pairs of its reads' complete forward windows, in
(keya, keyb) order, and the distinct values of the reference's other three
sets, keyb, keya ^ keyb and keya | keyb (include/bloom_filter.h feeds each
of its four planes exactly these values, so the sorted sets hold what the
planes hold). ``summary`` reduces an index to its distinct pair count, an
order-free 64-bit digest of its pairs and of each value set, and whether
its columns are sorted, so that a program's index is compared with the
reference's without holding both at once.

Partitions follow ``commet_ref.index_and_search``. Imports nothing of the
program under test.
"""

from __future__ import annotations

import numpy as np
import torch

from commet_bench.reference import commet_ref

# splitmix64's multipliers, as signed int64
_M1 = 0xBF58476D1CE4E5B9 - (1 << 64)
_M2 = 0x94D049BB133111EB - (1 << 64)


def _shr(x: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of int64 ``x`` by ``n`` (0 < n < 64)."""
    return (x >> n) & ((1 << (64 - n)) - 1)


def mix(x: torch.Tensor) -> torch.Tensor:
    """splitmix64's finalizer on int64 values (the products wrap)."""
    x = x ^ _shr(x, 30)
    x = x * _M1
    x = x ^ _shr(x, 27)
    x = x * _M2
    return x ^ _shr(x, 31)


def digest(h: torch.Tensor) -> int:
    """The sum of int64 hashes ``h`` modulo 2^64, in halves of 32 bits so
    that no sum overflows (exact for fewer than 2^31 values)."""
    lo = int((h & 0xFFFFFFFF).sum())
    hi = int(_shr(h, 32).sum())
    return (lo + (hi << 32)) % (1 << 64)


def _first_of_runs(*cols: torch.Tensor) -> torch.Tensor:
    """[n] bool: rows of sorted columns ``cols`` that differ from the row
    before them in any column (the first row always)."""
    n = cols[0].shape[0]
    first = torch.ones(n, dtype=torch.bool, device=cols[0].device)
    if n > 1:
        first[1:] = cols[0][1:] != cols[0][:-1]
        for c in cols[1:]:
            first[1:] |= c[1:] != c[:-1]
    return first


def _ascending(x: torch.Tensor) -> bool:
    return bool((x[1:] >= x[:-1]).all()) if x.shape[0] > 1 else True


def _pairs_sorted(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.shape[0] < 2:
        return True
    up, same = a[1:] > a[:-1], a[1:] == a[:-1]
    return bool((up | same & (b[1:] >= b[:-1])).all())


def summary(ika, ikb, sb, sc, sd) -> dict:
    """An index's columns reduced: ``pairs``, its distinct (keya, keyb)
    pairs; ``digest``, the order-free digests of its distinct pairs and of
    the distinct values of sb, sc and sd; ``sorted``, whether ika/ikb are in
    (keya, keyb) order and sb, sc, sd ascending (the digests assume it)."""
    ok = (ika.shape == ikb.shape and _pairs_sorted(ika, ikb)
          and all(_ascending(v) for v in (sb, sc, sd)))
    first = _first_of_runs(ika, ikb)
    a, b = ika[first], ikb[first]
    digests = [digest(mix(mix(a) ^ b))]
    for v in (sb, sc, sd):
        digests.append(digest(mix(v[_first_of_runs(v)])))
    return {"pairs": int(a.shape[0]), "digest": digests, "sorted": ok}


def forward_pairs(codes: np.ndarray, k: int, device):
    """(keya, keyb) int64 of every complete forward window of reads
    ``codes``, in read order."""
    out_a, out_b = [], []
    for start in range(0, len(codes), commet_ref.BLOCK_READS):
        c = torch.from_numpy(codes[start:start + commet_ref.BLOCK_READS]).to(
            device).to(torch.int64)
        wk = commet_ref.window_keys(c, k, ("f",))
        out_a.append(wk["fa"][wk["ok"]])
        out_b.append(wk["fb"][wk["ok"]])
        del wk, c
    empty = torch.zeros(0, dtype=torch.int64, device=device)
    return (torch.cat(out_a) if out_a else empty,
            torch.cat(out_b) if out_b else empty)


def distinct_pairs(a: torch.Tensor, b: torch.Tensor):
    """The distinct pairs of (a, b), in (keya, keyb) order."""
    perm = torch.sort(b, stable=True).indices
    a, b = a[perm], b[perm]
    perm = torch.sort(a, stable=True).indices
    a, b = a[perm], b[perm]
    del perm
    first = _first_of_runs(a, b)
    return a[first], b[first]


def partition_pairs(codes: np.ndarray, eligible: np.ndarray, k: int,
                    max_kmer: int, device):
    """Each partition's distinct pairs (``distinct_pairs``), in turn, of an
    index set's reads ``codes`` of which ``eligible`` are indexed."""
    rows = np.nonzero(eligible)[0]
    counts = commet_ref.valid_windows(codes[rows], k, device)
    for part in commet_ref.partitions(counts, max_kmer):
        yield distinct_pairs(*forward_pairs(codes[rows[part]], k, device))


def pairs_summary(a: torch.Tensor, b: torch.Tensor) -> dict:
    """``summary`` of the index that distinct sorted pairs (a, b) make."""
    return summary(a, b, torch.sort(b).values, torch.sort(a ^ b).values,
                   torch.sort(a | b).values)
