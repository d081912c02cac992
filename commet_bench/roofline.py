"""The least bytes a kernel's work needs, from the cell's inputs, and the
card's peak rate: frozen copies of ``chip_smoke.py``'s ``bound_ms``,
``_build_addrs`` and ``_probe_loads`` arithmetic.

Every count is of what the inputs need, never of how the program launches
its kernels: each input byte read once, each output byte written once,
each distinct 32 B plane sector that the reads' windows need read once.
The plane and probe kernels do integer compares and bit tests, far below
any peak rate per byte, so bytes bound them.
"""

from __future__ import annotations

import numpy as np
import torch

from commet_bench.reference import commet_ref

# NVIDIA H100 SXM5 80 GB, HBM3 (NVIDIA's data sheet), at its 700 W limit
HBM_BYTES_PER_S = 3.35e12
SECTOR_BYTES = 32
SECTOR_BITS = 8 * SECTOR_BYTES
SECTOR_SHIFT = 8  # log2(SECTOR_BITS)


def bound_s(n_bytes: float) -> float:
    """Least seconds the card needs to move ``n_bytes``."""
    return n_bytes / HBM_BYTES_PER_S


def read_bytes(codes: np.ndarray) -> int:
    """Reads read once: two bits a base, 4 B a read for its length, and a
    bit a base for the N positions of each read that holds an N."""
    n, length = codes.shape
    dirty = int((codes >= 4).any(axis=1).sum())
    return n * (-(-length // 4) + 4) + dirty * (-(-length // 8))


def build_bytes(codes: np.ndarray, k: int) -> int:
    """A plane build's least bytes: the reads read once and the four
    2^k-bit planes written once."""
    return read_bytes(codes) + 4 * (1 << k) // 8


def probe_sectors(planes: commet_ref.BytePlanes, codes: np.ndarray,
                  t: int) -> int:
    """Distinct 32 B plane sectors the sequential probe of reads ``codes``
    needs (chip_smoke._probe_loads): per strand, plane A at every window
    it reaches (complete, at or past the greedy skip, before the count
    reaches t) and planes B, C, D at each of those whose A bit is set; the
    reverse strand only for reads whose forward count stays below t."""
    k = planes.k
    per_plane = (1 << k) // SECTOR_BITS
    found = []
    for start in range(0, len(codes), commet_ref.BLOCK_READS):
        c = torch.from_numpy(codes[start:start + commet_ref.BLOCK_READS]).to(
            planes.device).to(torch.int64)
        wk = commet_ref.window_keys(c, k)
        ok = wk["ok"]
        n = ok.shape[0]
        counting = torch.ones(n, dtype=torch.bool, device=ok.device)
        ids = []
        for s in ("f", "r"):
            a = torch.where(ok, wk[s + "a"], 0)
            b = torch.where(ok, wk[s + "b"], 0)
            hit_a = (planes.sets[0][a] == 1) & ok
            member = planes.member(a, b) & ok
            cnt = torch.zeros(n, dtype=torch.int64, device=ok.device)
            allow = torch.zeros_like(cnt)
            live = counting.clone()
            reached = torch.zeros_like(ok)
            for w in range(ok.shape[1]):
                reach = live & ok[:, w] & (allow <= w)
                reached[:, w] = reach
                got = reach & member[:, w]
                cnt += got
                allow = torch.where(got, w + k, allow)
                live &= cnt < t
            counting &= cnt < t
            loaded = reached & hit_a
            for p, key in enumerate((a, b, a ^ b, a | b)):
                sel = reached if p == 0 else loaded
                ids.append(torch.unique(p * per_plane
                                        + (key[sel] >> SECTOR_SHIFT)))
        found.append(torch.unique(torch.cat(ids)))
    if not found:
        return 0
    return int(torch.unique(torch.cat(found)).numel())


def probe_bytes(planes: commet_ref.BytePlanes, codes: np.ndarray,
                t: int) -> int:
    """A plane probe's least bytes: the reads read once, each plane sector
    they need read once, a tag a read written once (a bit)."""
    return (read_bytes(codes) + SECTOR_BYTES * probe_sectors(planes, codes, t)
            + -(-len(codes) // 8))
