"""A plain reference of COMMET's read-set comparison, in PyTorch and NumPy.

It follows the C++ reference (pierrepeterlongo/commet) and imports nothing
of the program under test. What it computes:

- window keys (include/hash_key.h:65-125): a base's keya bit is 1 for G or T,
  its keyb bit 1 for C or T; the forward keys hold a window's first base in
  their top bit, the reverse-complement keys the complement of its first
  base in bit 0; a window holding a non-ACGT byte is no window (the
  rolling hash is cleared);
- the index of a partition (include/bloom_filter.h): four sets of values
  fed by every complete forward window of its reads, A = keya, B = keyb,
  C = keya ^ keyb, D = keya | keyb, each held here as a byte a value
  (``BytePlanes``, 2^k bytes a set); a window is a member when all four of
  its values are in their sets;
- a read's tag (search_reads.h:34-87): on either strand, at least t member
  windows found greedily, the next counted window at least k past a
  counted one;
- partitions (index_reads.h:49-61, index_and_search.cpp:255-277): reads are
  indexed while the partition's k-mers are below max_kmer; the read
  fetched at or past the cap is dropped; a query read tagged in one
  partition is not searched in the next;
- the .bv and .log files (boolean_vector.h:302-346,
  index_and_search.cpp:288-300), read and written.

Departures from the C++ semantics, none of which the benchmark's inputs
reach: reads are given as code arrays, one file per set, not parsed from
text; the sets are held as bytes, so k is limited by the device's memory
(2^k bytes a set, four sets), not by the C++ 2^k-bit planes.

``membership="a_only"`` makes the control: the same computation with sets
B, C and D left unchecked (keya alone decides a window), the approximate
membership a faster probe would be tempted to take.
"""

from __future__ import annotations

import numpy as np
import torch

# reads a block of key computation holds at once
BLOCK_READS = 1 << 20


def max_kmer_for(k: int) -> int:
    """The partition cap, (unsigned long)(1e9 / 2^(33-k))
    (index_and_search.cpp:73,146)."""
    return int(1000000000.0 / (2.0 ** (33 - k)))


def window_keys(codes: torch.Tensor, k: int, strands=("f", "r")):
    """Keys of every window of [n, L] codes (int64, 4 = N) by a plain
    shift-or over the k bases: {"ok": [n, W] bool, "fa", "fb", "ra", "rb":
    [n, W] int64}, W = L - k + 1 (at least 0)."""
    n, length = codes.shape
    w = max(0, length - k + 1)
    valid = codes < 4
    abit = (codes >> 1) & 1
    bbit = codes & 1
    run = torch.zeros((n, length + 1), dtype=torch.int32,
                      device=codes.device)
    run[:, 1:] = torch.cumsum(valid, dim=1, dtype=torch.int32)
    out = {"ok": (run[:, k:k + w] - run[:, :w]) == k}
    zero = torch.zeros((n, w), dtype=torch.int64, device=codes.device)
    fa, fb, ra, rb = zero, zero.clone(), zero.clone(), zero.clone()
    for j in range(k):
        a, b = abit[:, j:j + w], bbit[:, j:j + w]
        if "f" in strands:
            fa = (fa << 1) | a
            fb = (fb << 1) | b
        if "r" in strands:
            ra = ra | ((1 - a) << j)
            rb = rb | ((1 - b) << j)
    if "f" in strands:
        out["fa"], out["fb"] = fa, fb
    if "r" in strands:
        out["ra"], out["rb"] = ra, rb
    return out


def valid_windows(codes: np.ndarray, k: int, device) -> np.ndarray:
    """Complete windows of each read, [n] int64."""
    out = np.zeros(len(codes), dtype=np.int64)
    for start in range(0, len(codes), BLOCK_READS):
        c = torch.from_numpy(codes[start:start + BLOCK_READS]).to(device)
        ok = window_keys(c.to(torch.int64), k, ())["ok"]
        out[start:start + len(c)] = ok.sum(dim=1).cpu().numpy()
    return out


def partitions(kmer_counts: np.ndarray, max_kmer: int):
    """Positions, into the eligible reads, of each partition's reads."""
    n = len(kmer_counts)
    parts, cursor = [], 0
    while cursor < n:
        # the read at position j is indexed while the k-mers of the reads
        # before it in this partition are below max_kmer
        before = np.concatenate([[0], np.cumsum(kmer_counts[cursor:])])[:-1]
        over = np.nonzero(before >= max_kmer)[0]
        end = cursor + (int(over[0]) if len(over) else n - cursor)
        parts.append(np.arange(cursor, end))
        cursor = end + 1  # the read at the cap is consumed, not indexed
    return parts


class BytePlanes:
    """The four value sets of one partition, a byte a value."""

    def __init__(self, k: int, device, membership: str = "exact"):
        if membership not in ("exact", "a_only"):
            raise ValueError(f"membership {membership!r}")
        if k < 5:
            raise ValueError(f"k={k}: the planes' layout needs k >= 5")
        self.k, self.device, self.membership = k, device, membership
        self.sets = torch.zeros((4, 1 << k), dtype=torch.uint8,
                                device=device)

    def clear(self) -> None:
        self.sets.zero_()

    def add(self, codes: np.ndarray, skip_dirty: bool = False) -> None:
        """Every complete forward window of reads ``codes`` (the control's
        build, ``skip_dirty``, leaves out the reads that hold an N)."""
        if skip_dirty:
            codes = codes[(codes < 4).all(axis=1)]
        for start in range(0, len(codes), BLOCK_READS):
            c = torch.from_numpy(codes[start:start + BLOCK_READS]).to(
                self.device).to(torch.int64)
            wk = window_keys(c, self.k, ("f",))
            a, b = wk["fa"][wk["ok"]], wk["fb"][wk["ok"]]
            for p, v in enumerate((a, b, a ^ b, a | b)):
                self.sets[p][v] = 1

    def member(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        hit = self.sets[0][a] == 1
        if self.membership == "a_only":
            return hit
        for p, v in ((1, b), (2, a ^ b), (3, a | b)):
            hit &= self.sets[p][v] == 1
        return hit

    def packed(self) -> torch.Tensor:
        """The sets as four 2^k-bit planes, [4 * 2^k / 8] uint8: value v of
        set p at bit v % 8 of byte p * 2^k / 8 + v // 8 (k >= 5)."""
        n = self.sets.shape[1] // 8
        out = torch.empty(4 * n, dtype=torch.uint8, device=self.device)
        step = 1 << 24
        for p in range(4):
            for s in range(0, n, step):
                e = min(n, s + step)
                bits = self.sets[p, 8 * s:8 * e].view(-1, 8)
                acc = bits[:, 0].clone()
                for i in range(1, 8):
                    acc |= bits[:, i] << i
                out[p * n + s:p * n + e] = acc
        return out


def greedy_tagged(member: torch.Tensor, k: int, t: int) -> torch.Tensor:
    """Whether each row of [n, W] member windows counts t greedily: a
    counted window at i lets the next count at i + k or later."""
    n, w = member.shape
    cnt = torch.zeros(n, dtype=torch.int64, device=member.device)
    allow = torch.zeros(n, dtype=torch.int64, device=member.device)
    for i in range(w):
        hit = member[:, i] & (allow <= i) & (cnt < t)
        cnt += hit
        allow = torch.where(hit, i + k, allow)
    return cnt >= t


def tag_reads(planes: BytePlanes, codes: np.ndarray, t: int) -> np.ndarray:
    """Tags [n] bool of reads ``codes`` against one partition."""
    out = np.zeros(len(codes), dtype=bool)
    k = planes.k
    for start in range(0, len(codes), BLOCK_READS):
        c = torch.from_numpy(codes[start:start + BLOCK_READS]).to(
            planes.device).to(torch.int64)
        wk = window_keys(c, k)
        tagged = None
        for s in ("f", "r"):
            member = planes.member(wk[s + "a"], wk[s + "b"]) & wk["ok"]
            tag = greedy_tagged(member, k, t)
            tagged = tag if tagged is None else tagged | tag
        out[start:start + len(c)] = tagged.cpu().numpy()
    return out


def index_and_search(planes: BytePlanes, index_codes: np.ndarray,
                     index_eligible: np.ndarray, queries, t: int,
                     max_kmer: int, skip_dirty: bool = False,
                     each_partition=None):
    """One index set against query sets, partition by partition, with the
    C++ tool's counters. ``queries``: [(codes, eligible bool [n])];
    ``each_partition(i, planes)`` is called once each partition's sets are
    built. Returns ([tags bool [n] per query], [(indexed, searched, shared)
    per query])."""
    rows = np.nonzero(index_eligible)[0]
    counts = valid_windows(index_codes[rows], planes.k, planes.device)
    parts = partitions(counts, max_kmer)
    tags = [np.zeros(len(c), dtype=bool) for c, _e in queries]
    searched = [0] * len(queries)
    for pi, part in enumerate(parts):
        planes.clear()
        planes.add(index_codes[rows[part]], skip_dirty)
        if each_partition is not None:
            each_partition(pi, planes)
        for qi, (codes, eligible) in enumerate(queries):
            cand = np.nonzero(eligible & ~tags[qi])[0]
            searched[qi] = len(cand)
            if len(cand):
                tags[qi][cand] = tag_reads(planes, codes[cand], t)
    indexed = int(sum(len(p) for p in parts))
    return tags, [(indexed, searched[qi], int(tags[qi].sum()))
                  for qi in range(len(queries))]


def read_bv(path: str, size: int) -> np.ndarray:
    """The bits of a .bv file of ``size`` bits (boolean_vector.h:302-346:
    a comment, ``#<size>``, then size // 8 + 1 bytes, low bit first)."""
    with open(path, "rb") as f:
        raw = f.read()
    n_bytes = size // 8 + 1
    head = b"\n#%d\n" % size
    if len(raw) < n_bytes + len(head) or \
            raw[-n_bytes - len(head):-n_bytes] != head:
        raise ValueError(f"{path} is no .bv of {size} bits")
    bits = np.unpackbits(np.frombuffer(raw[-n_bytes:], dtype=np.uint8),
                         bitorder="little")
    return bits[:size].astype(bool)


def read_counters(path: str):
    """(indexed, searched, shared) from a .log's last line
    (index_and_search.cpp:288-300)."""
    with open(path) as f:
        last = f.read().splitlines()[-1]
    if not (last.startswith("[indexed ") and last.endswith("]")):
        raise ValueError(f"{path}: no counter line")
    fields = last[1:-1].split(", ")
    return tuple(int(x.split(" ")[1]) for x in fields)


def write_bv(path: str, bits: np.ndarray) -> None:
    """``bits`` as a .bv file that ``read_bv`` reads back."""
    body = np.packbits(bits.astype(np.uint8), bitorder="little")
    body = np.concatenate([body, np.zeros(len(bits) // 8 + 1 - len(body),
                                          dtype=np.uint8)])
    with open(path, "wb") as f:
        f.write(b"# reference\n#%d\n" % len(bits) + body.tobytes())


def write_counters(path: str, counters) -> None:
    """(indexed, searched, shared) as a .log's counter line."""
    with open(path, "w") as f:
        f.write("[indexed %d, searched %d, shared %d]\n" % tuple(counters))
