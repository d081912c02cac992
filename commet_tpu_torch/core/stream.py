"""Sorted-set membership for the stream probe: the sorted (keya, keyb)
index, the join of sorted query keys against it, the TAGGED / UNTAGGED /
AMBIG verdict sandwich and the exact sorted-set fallback.

Counterpart of commet_tpu/core/stream.py. Keys are whole int64 values
(k <= 36), so the index needs no hi-bit side stream, no SENTINEL padding and
no flag sort key: invalid windows are dropped with a mask. The join runs the
hand-written CUDA kernel ``csrc/join.cu`` on a CUDA tensor and its plain
PyTorch version on a CPU tensor. The amortized schedule joins one sorted
query stream against S indexes (``JoinSlots``) in one grouped launch of the
same kernel (``join_membership_multi``). The kernel is a tile join: a block
brackets the index range of its tile of consecutive queries and, where that
range is shorter than the launch's staging capacity, searches it in shared
memory; ``join_launch_geometry`` chooses the tile and the capacity from the
launch's density, and ``join_tile_ranges`` is the bracket in PyTorch ops.

Per (window, strand) query the join returns:
  NONMEM (0) keya is absent from the index;
  CAND   (1) keya is present, the exact pair is not (a potential cross-k-mer
             false positive of the reference's four-plane test);
  CONF   (2) the exact pair is present: all four reference planes hit.
CONF proves membership and NONMEM proves non-membership; reads whose tag
hangs on CAND windows come out AMBIG and resolve through the four exact
sorted value sets, so final tags equal the reference's. (The TPU kernel's
fourth verdict, RESIDUAL for a query its window could not bracket, does not
occur: every query here is bracketed by a search of the whole index.)
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import List

import torch

from commet_tpu_torch.core import greedy, keys

NONMEM = 0
CAND = 1
CONF = 2

VERDICT_UNTAGGED = 0
VERDICT_AMBIG = 1
VERDICT_TAGGED = 2

# the tile join's limits, as csrc/join.cu has them (kTile, kCap): the most
# queries a block owns and the most index entries it stages; and the step
# of the tile size (a warp's queries)
JOIN_TILE = 1024
JOIN_CAPACITY = 8192
JOIN_TILE_STEP = 32
# the least tile worth staging, measured on an H100 (PERF.md)
JOIN_TILE_MIN = 768


# --------------------------------------------------------------------------
# The index
# --------------------------------------------------------------------------

@dataclass
class StreamIndex:
    """A partition's membership structure: the (keya, keyb) pairs of its
    valid forward windows sorted lexicographically (``ika``, ``ikb``; ``ika``
    doubles as the sorted keya set A), and the sorted value sets of the
    reference's planes B = keyb, C = keya ^ keyb and D = keya | keyb. The
    reference feeds each plane exactly these values through an injective
    key -> bit map, so sorted-set membership of all four keys is its
    four-plane test."""

    ika: torch.Tensor
    ikb: torch.Tensor
    sb: torch.Tensor
    sc: torch.Tensor
    sd: torch.Tensor

    @property
    def mi(self) -> int:
        return self.ika.shape[0]

    @property
    def sa(self) -> torch.Tensor:
        return self.ika


def lexsort_pairs(a: torch.Tensor, b: torch.Tensor):
    """(a, b) pairs sorted by a, then b: two stable sorts, no combined key
    (a k=32..36 pair needs more than 63 bits)."""
    perm = torch.sort(b, stable=True).indices
    a, b = a[perm], b[perm]
    perm = torch.sort(a, stable=True).indices
    return a[perm], b[perm]


def finalize_index(key_chunks: List[torch.Tensor],
                   keyb_chunks: List[torch.Tensor]) -> StreamIndex:
    """Sort the per-batch (keya, keyb) chunks (keys.index_keys output) into
    a StreamIndex. Counterpart of finalize_index_keys + finalize_index.
    Empties the chunk lists as it goes so their memory can be reused."""
    a = torch.cat(key_chunks)
    key_chunks.clear()
    b = torch.cat(keyb_chunks)
    keyb_chunks.clear()
    ika, ikb = lexsort_pairs(a, b)
    del a, b
    return index_from_sorted_pairs(ika, ikb)


def index_from_sorted_pairs(ika: torch.Tensor, ikb: torch.Tensor,
                            sets=None) -> StreamIndex:
    """StreamIndex from lexsorted pairs; ``sets`` = (sb, sc, sd) when the
    caller already has them, else they are sorted here."""
    if sets is None:
        sets = (torch.sort(ikb).values, torch.sort(ika ^ ikb).values,
                torch.sort(ika | ikb).values)
    return StreamIndex(ika, ikb, *sets)


# --------------------------------------------------------------------------
# The join
# --------------------------------------------------------------------------

def join_membership_plain(ika: torch.Tensor, ikb: torch.Tensor, mi: int,
                          qa: torch.Tensor, qb: torch.Tensor) -> torch.Tensor:
    """NONMEM / CAND / CONF for every query pair, in plain PyTorch:
    ``searchsorted`` on the keya column brackets each query's equal-keya
    run (CAND when it is not empty), then a bisection of keyb inside the run
    finds the exact pair (CONF). Queries need not be sorted."""
    out = torch.zeros(qa.shape, dtype=torch.int8, device=qa.device)
    if mi == 0 or qa.numel() == 0:
        return out
    a, b = ika[:mi], ikb[:mi]
    lo = torch.searchsorted(a, qa)
    hi = torch.searchsorted(a, qa, right=True)
    # lower bound of qb in b[lo:hi]
    left, right = lo.clone(), hi.clone()
    for _ in range(int((hi - lo).max()).bit_length()):
        mid = (left + right) // 2
        less = (left < right) & (b[mid.clamp(max=mi - 1)] < qb)
        left = torch.where(less, mid + 1, left)
        right = torch.where(less, right, torch.minimum(mid, right))
    conf = (left < hi) & (b[left.clamp(max=mi - 1)] == qb)
    out[hi > lo] = CAND
    out[conf] = CONF
    return out


def join_launch_geometry(mi: int, m: int):
    """(tile, capacity) of a join launch of m queries against mi index
    entries: the consecutive queries a block owns and the index entries it
    may stage in shared memory. Sorted queries spread over the index, so a
    tile of t queries spans about t * mi / m entries, give or take a part in
    sqrt(t): the tile is the largest multiple of ``JOIN_TILE_STEP`` up to
    ``JOIN_TILE`` whose span fits ``JOIN_CAPACITY`` with 6% to spare. Where
    less than ``JOIN_TILE_MIN`` queries fit (a dense index: staging would
    copy many times the entries the queries need, and measured no faster)
    the launch has capacity 0: it asks for no shared memory, brackets and
    stages nothing, and searches every query from the root of the index in
    device memory with the SM's whole L1 behind it. In a launch that
    stages, a tile that does not fit the capacity (unsorted queries, a long
    equal-keya run) is searched in device memory inside its bracket."""
    fit = int(0.94 * JOIN_CAPACITY * m) // max(mi, 1)
    tile = min(JOIN_TILE, fit // JOIN_TILE_STEP * JOIN_TILE_STEP)
    if tile >= JOIN_TILE_MIN:
        return tile, JOIN_CAPACITY
    return JOIN_TILE, 0


def join_tile_ranges(ika: torch.Tensor, mi: int, qa: torch.Tensor,
                     tile: int) -> torch.Tensor:
    """[n_tiles, 2] int64 (L, R): the index range the join kernel brackets
    for each tile of ``tile`` consecutive queries, in PyTorch ops. L is the
    lower bound in ika[:mi] of the tile's least keya and R the upper bound
    of its greatest, so every query's lower bound lies in [L, R] and the
    whole equal-keya run of every present query inside [L, R), whatever the
    queries' order. A tile whose R - L is below its launch's capacity is
    staged in shared memory; any other is searched in device memory."""
    m = qa.shape[0]
    n_tiles = -(-m // tile)
    if n_tiles == 0:
        return qa.new_zeros((0, 2))
    pad = n_tiles * tile - m
    big = torch.iinfo(torch.int64).max
    least = torch.cat([qa, qa.new_full((pad,), big)]).view(n_tiles, tile)
    most = torch.cat([qa, qa.new_full((pad,), -big - 1)]).view(n_tiles, tile)
    a = ika[:mi]
    return torch.stack(
        [torch.searchsorted(a, least.min(dim=1).values),
         torch.searchsorted(a, most.max(dim=1).values, right=True)], dim=1)


def join_tiles_staged(ika: torch.Tensor, mi: int, qa: torch.Tensor,
                      geometry=None) -> torch.Tensor:
    """[n_tiles] bool: which tiles of a join launch the kernel stages in
    shared memory (the others it searches in device memory), from
    ``join_tile_ranges`` and the launch's geometry, by default
    ``join_launch_geometry(mi, len(qa))``."""
    tile, cap = geometry or join_launch_geometry(mi, qa.shape[0])
    r = join_tile_ranges(ika, mi, qa, tile)
    return r[:, 1] - r[:, 0] < cap


def _check_column(fn: str, name: str, x: torch.Tensor,
                  device: torch.device) -> None:
    if x.device != device or x.dtype != torch.int64 or x.dim() != 1 \
            or not x.is_contiguous():
        raise ValueError(f"{fn}: {name} must be a contiguous 1-D int64 "
                         f"tensor on {device}, got {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")


def _check_mi(fn: str, ika: torch.Tensor, ikb: torch.Tensor, mi: int) -> None:
    if not 0 <= mi <= min(ika.shape[0], ikb.shape[0]):
        raise ValueError(f"{fn}: mi={mi} outside the index length "
                         f"{ika.shape[0]}")


def join_membership(ika: torch.Tensor, ikb: torch.Tensor, mi: int,
                    qa: torch.Tensor, qb: torch.Tensor) -> torch.Tensor:
    """Verdicts [M] int8 for query pairs (qa, qb) [M] int64 against the
    index pairs ika/ikb (int64, sorted by (keya, keyb), valid prefix
    [0, mi)). Counterpart of commet_tpu join_membership: a CUDA tensor runs
    the hand kernel csrc/join.cu (counted in ``join_membership.launches``),
    a CPU tensor runs join_membership_plain. The sorted query order the
    stream keeps lets a tile of queries share one short index range, which
    the kernel stages in shared memory; any order is right."""
    for name, x in (("ika", ika), ("ikb", ikb), ("qa", qa), ("qb", qb)):
        _check_column("join_membership", name, x, qa.device)
    _check_mi("join_membership", ika, ikb, mi)
    if qb.shape != qa.shape:
        raise ValueError("join_membership: qa and qb differ in shape")
    if qa.device.type == "cpu":
        return join_membership_plain(ika, ikb, mi, qa, qb)
    if qa.device.type != "cuda":
        raise ValueError(f"join_membership: unsupported device {qa.device}")
    m = qa.shape[0]
    out = torch.empty(m, dtype=torch.int8, device=qa.device)
    if m == 0:
        return out
    from commet_tpu_torch.core import _cuda
    lib = _cuda.load("join")
    with torch.cuda.device(qa.device):  # the launch goes to the current card
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.commet_join(
            ctypes.c_void_p(ika.data_ptr()), ctypes.c_void_p(ikb.data_ptr()),
            ctypes.c_int64(mi), ctypes.c_void_p(qa.data_ptr()),
            ctypes.c_void_p(qb.data_ptr()), ctypes.c_int64(m),
            *map(ctypes.c_int, join_launch_geometry(mi, m)),
            ctypes.c_void_p(out.data_ptr()), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"join kernel launch failed: cudaError {err}")
    join_membership.launches += 1
    return out


join_membership.launches = 0


class JoinSlots:
    """The S sorted indexes one grouped join launch serves: their columns
    (each int64, lexsorted, valid prefix [0, mi)), and on the card the
    device tables the kernel reads, [3, S] int64 rows of ika addresses, ikb
    addresses and mi values. Built once per group of slots; the object
    holds the columns, so the addresses stay valid as long as the tables.
    ``typical_mi`` (the upper median of the slots' mi) stands for the group
    where one launch geometry is chosen for all of its slots."""

    def __init__(self, ikas, ikbs, mis):
        ikas, ikbs, mis = list(ikas), list(ikbs), [int(m) for m in mis]
        if not ikas or not len(ikas) == len(ikbs) == len(mis):
            raise ValueError(f"JoinSlots: need S >= 1 equal-length ikas, "
                             f"ikbs and mis, got {len(ikas)}, {len(ikbs)}, "
                             f"{len(mis)}")
        self.device = ikas[0].device
        for s, (a, b, mi) in enumerate(zip(ikas, ikbs, mis)):
            _check_column("JoinSlots", f"ikas[{s}]", a, self.device)
            _check_column("JoinSlots", f"ikbs[{s}]", b, self.device)
            _check_mi("JoinSlots", a, b, mi)
        self.ikas, self.ikbs, self.mis = ikas, ikbs, mis
        self.typical_mi = sorted(mis)[len(mis) // 2]
        self.tables = None
        if self.device.type == "cuda":
            self.tables = torch.tensor(
                [[a.data_ptr() for a in ikas], [b.data_ptr() for b in ikbs],
                 mis], dtype=torch.int64).to(self.device)

    def __len__(self) -> int:
        return len(self.ikas)


def join_membership_multi_plain(ikas, ikbs, mis, qa: torch.Tensor,
                                qb: torch.Tensor) -> torch.Tensor:
    """[S, M] verdicts: join_membership_plain against each index in turn."""
    return torch.stack([join_membership_plain(a, b, mi, qa, qb)
                        for a, b, mi in zip(ikas, ikbs, mis)])


def join_membership_multi(slots: JoinSlots, qa: torch.Tensor,
                          qb: torch.Tensor) -> torch.Tensor:
    """Verdicts [S, M] int8 of the query pairs (qa, qb) [M] int64 against
    each of the S indexes of ``slots``, row s for slot s. Counterpart of the
    S join_membership calls of commet_tpu's _membership_stream_multi: a CUDA
    tensor runs one launch of the grouped kernel csrc/join.cu
    (commet_join_multi, counted in ``join_membership_multi.launches``), a
    CPU tensor runs join_membership_multi_plain."""
    for name, x in (("qa", qa), ("qb", qb)):
        _check_column("join_membership_multi", name, x, slots.device)
    if qb.shape != qa.shape:
        raise ValueError("join_membership_multi: qa and qb differ in shape")
    if qa.device.type == "cpu":
        return join_membership_multi_plain(slots.ikas, slots.ikbs,
                                           slots.mis, qa, qb)
    if qa.device.type != "cuda":
        raise ValueError(f"join_membership_multi: unsupported device "
                         f"{qa.device}")
    n_s, m = len(slots), qa.shape[0]
    if n_s > 65535:
        raise ValueError(f"join_membership_multi: {n_s} slots exceed the "
                         "grid's 65535")
    out = torch.empty((n_s, m), dtype=torch.int8, device=qa.device)
    if m == 0:
        return out
    from commet_tpu_torch.core import _cuda
    lib = _cuda.load("join")
    tab = slots.tables
    with torch.cuda.device(qa.device):  # the launch goes to the current card
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.commet_join_multi(
            ctypes.c_void_p(tab[0].data_ptr()),
            ctypes.c_void_p(tab[1].data_ptr()),
            ctypes.c_void_p(tab[2].data_ptr()), ctypes.c_int64(n_s),
            ctypes.c_void_p(qa.data_ptr()), ctypes.c_void_p(qb.data_ptr()),
            ctypes.c_int64(m),
            *map(ctypes.c_int, join_launch_geometry(slots.typical_mi, m)),
            ctypes.c_void_p(out.data_ptr()), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"multi join kernel launch failed: cudaError {err}")
    join_membership_multi.launches += 1
    return out


join_membership_multi.launches = 0


# --------------------------------------------------------------------------
# The streamed probe
# --------------------------------------------------------------------------

def _sorted_queries(wk):
    """The batch's (read, strand, window) query pairs sorted by keya, so
    that a tile of them needs one short piece of the index (csrc/join.cu):
    (sk, skb, perm), invalid windows as
    (0, 0). (The TPU path packs payload << 2 | verdict into uint32 for a
    second sort, which capped a batch at 2^30 keys; the unsort here scatters
    through ``perm`` and has no such limit.)"""
    ok2 = wk["ok"][:, None, :]
    q = torch.where(ok2, torch.stack([wk["fa"], wk["ra"]], dim=1), 0)
    q2 = torch.where(ok2, torch.stack([wk["fb"], wk["rb"]], dim=1), 0)
    sk, perm = torch.sort(q.reshape(-1))
    return sk, q2.reshape(-1)[perm], perm


def _membership_stream(sidx: StreamIndex, wk) -> torch.Tensor:
    """Join verdicts for every (read, strand, window) key pair, [B, 2, W]
    int8 in window order: sort, join, scatter back."""
    b, w = wk["ok"].shape
    sk, skb, perm = _sorted_queries(wk)
    mem_s = join_membership(sidx.ika, sidx.ikb, sidx.mi, sk, skb)
    mem = torch.empty_like(mem_s)
    mem[perm] = mem_s
    return mem.reshape(b, 2, w)


def _membership_stream_multi(slots: JoinSlots, wk) -> torch.Tensor:
    """Join verdicts of every (slot, read, strand, window), [S, B, 2, W]
    int8 in window order, from ONE sorted query stream: one sort, one
    grouped join, one scatter along dim 1. Counterpart of
    commet_tpu's _membership_stream_multi, whose 15-per-uint32 packing and
    second sort exist only for its sort-based unsort."""
    b, w = wk["ok"].shape
    sk, skb, perm = _sorted_queries(wk)
    mem_s = join_membership_multi(slots, sk, skb)
    del sk, skb
    mem = torch.empty_like(mem_s).index_copy_(1, perm, mem_s)
    return mem.reshape(len(slots), b, 2, w)


def _multi_verdicts(ok: torch.Tensor, mems: torch.Tensor, k: int, t: int):
    """TAGGED / UNTAGGED / AMBIG [S, B] from verdicts [S, B, 2, W]:
    greedy(CONF) >= t on either strand proves tagged; greedy(CONF | CAND)
    < t on both proves untagged; anything else is AMBIG for the exact
    fallback. The greedy scans run once over [S, B, W]."""
    tagged = untagged = None
    for s in range(2):
        mem = mems[:, :, s]
        conf = (mem == CONF) & ok
        maybe = (mem == CAND) & ok
        tag_s = greedy.greedy_ge(conf, k, t)
        untag_s = ~greedy.greedy_ge(conf | maybe, k, t)
        tagged = tag_s if tagged is None else tagged | tag_s
        untagged = untag_s if untagged is None else untagged & untag_s
    return torch.where(
        tagged, VERDICT_TAGGED,
        torch.where(untagged, VERDICT_UNTAGGED, VERDICT_AMBIG)).to(torch.int8)


def probe_stream_codes(sidx: StreamIndex, codes: torch.Tensor, k: int,
                       t: int, wmax=None) -> torch.Tensor:
    """[B] int8 verdicts for a batch of [B, L] codes. Counterpart of
    probe_multi_stream_codes with one index (S = 1)."""
    wk = keys.window_keys(codes, k, "both", wmax)
    return _multi_verdicts(wk["ok"], _membership_stream(sidx, wk)[None], k,
                           t)[0]


def probe_stream_clean(sidx: StreamIndex, codes2, lengths, length: int,
                       k: int, t: int, wmax=None) -> torch.Tensor:
    """probe_stream_codes for N-free batches (2-bit words + lengths);
    counterpart of probe_multi_stream_clean at S = 1."""
    codes = keys.unpack_codes_clean(codes2, lengths, length)
    return probe_stream_codes(sidx, codes, k, t, wmax)


def probe_stream_packed(sidx: StreamIndex, codes2, valid, length: int,
                        k: int, t: int, wmax=None) -> torch.Tensor:
    """probe_stream_codes for dirty batches (2-bit words + validity words);
    counterpart of probe_multi_stream_packed at S = 1."""
    codes = keys.unpack_codes(codes2, valid, length)
    return probe_stream_codes(sidx, codes, k, t, wmax)


def probe_multi_stream_codes(slots: JoinSlots, codes: torch.Tensor, k: int,
                             t: int, wmax=None) -> torch.Tensor:
    """[S, B] int8 verdicts of a batch of [B, L] codes against every slot,
    from one sorted query stream. Counterpart of probe_multi_stream_codes."""
    wk = keys.window_keys(codes, k, "both", wmax)
    return _multi_verdicts(wk["ok"], _membership_stream_multi(slots, wk), k,
                           t)


def probe_multi_stream_clean(slots: JoinSlots, codes2, lengths, length: int,
                             k: int, t: int, wmax=None) -> torch.Tensor:
    """probe_multi_stream_codes for N-free batches (2-bit words + lengths);
    counterpart of probe_multi_stream_clean."""
    codes = keys.unpack_codes_clean(codes2, lengths, length)
    return probe_multi_stream_codes(slots, codes, k, t, wmax)


def probe_multi_stream_packed(slots: JoinSlots, codes2, valid, length: int,
                              k: int, t: int, wmax=None) -> torch.Tensor:
    """probe_multi_stream_codes for dirty batches (2-bit words + validity
    words); counterpart of probe_multi_stream_packed."""
    codes = keys.unpack_codes(codes2, valid, length)
    return probe_multi_stream_codes(slots, codes, k, t, wmax)


# --------------------------------------------------------------------------
# The exact fallback
# --------------------------------------------------------------------------

def _in_sorted(arr: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Membership of q (any shape) in the ascending array ``arr``."""
    n = arr.shape[0]
    if n == 0:
        return torch.zeros(q.shape, dtype=torch.bool, device=q.device)
    pos = torch.searchsorted(arr, q.reshape(-1)).reshape(q.shape)
    return (pos < n) & (arr[pos.clamp(max=n - 1)] == q)


def probe_exact_sets(sidx: StreamIndex, codes2, valid, length: int, k: int,
                     t: int, wmax=None) -> torch.Tensor:
    """Exact tags [B] bool: a window is a member when keya, keyb, keya ^ keyb
    and keya | keyb are all in their sorted sets; a read is tagged when
    either strand has t greedy non-overlapping members
    (search_reads.h:34-87). Counterpart of probe_exact_sets."""
    codes = keys.unpack_codes(codes2, valid, length)
    wk = keys.window_keys(codes, k, "both", wmax)
    tagged = None
    for p in ("f", "r"):
        a, b = wk[p + "a"], wk[p + "b"]
        member = (_in_sorted(sidx.sa, a) & _in_sorted(sidx.sb, b)
                  & _in_sorted(sidx.sc, a ^ b) & _in_sorted(sidx.sd, a | b)
                  & wk["ok"])
        tag = greedy.greedy_ge(member, k, t)
        tagged = tag if tagged is None else tagged | tag
    return tagged
