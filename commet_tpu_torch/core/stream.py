"""Sorted-set membership for the stream probe: the sorted (keya, keyb)
index, the join of sorted query keys against it, the TAGGED / UNTAGGED /
AMBIG verdict sandwich and the exact sorted-set fallback.

Counterpart of commet_tpu/core/stream.py. Keys are whole int64 values
(k <= 36), so the index needs no hi-bit side stream, no SENTINEL padding and
no flag sort key: invalid windows are dropped with a mask. The join runs the
hand-written CUDA kernel ``csrc/join.cu`` on a CUDA tensor and its plain
PyTorch version on a CPU tensor.

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


def join_membership(ika: torch.Tensor, ikb: torch.Tensor, mi: int,
                    qa: torch.Tensor, qb: torch.Tensor) -> torch.Tensor:
    """Verdicts [M] int8 for query pairs (qa, qb) [M] int64 against the
    index pairs ika/ikb (int64, sorted by (keya, keyb), valid prefix
    [0, mi)). Counterpart of commet_tpu join_membership: a CUDA tensor runs
    the hand kernel csrc/join.cu (counted in ``join_membership.launches``),
    a CPU tensor runs join_membership_plain. The sorted query order the
    stream keeps is for the kernel's cache locality; any order is right."""
    for name, x in (("ika", ika), ("ikb", ikb), ("qa", qa), ("qb", qb)):
        if x.device != qa.device or x.dtype != torch.int64 \
                or x.dim() != 1 or not x.is_contiguous():
            raise ValueError(f"join_membership: {name} must be a contiguous "
                             f"1-D int64 tensor on {qa.device}, got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")
    if not 0 <= mi <= min(ika.shape[0], ikb.shape[0]):
        raise ValueError(f"join_membership: mi={mi} outside the index "
                         f"length {ika.shape[0]}")
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
            ctypes.c_void_p(out.data_ptr()), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"join kernel launch failed: cudaError {err}")
    join_membership.launches += 1
    return out


join_membership.launches = 0


# --------------------------------------------------------------------------
# The streamed probe
# --------------------------------------------------------------------------

def _membership_stream(sidx: StreamIndex, wk) -> torch.Tensor:
    """Join verdicts for every (read, strand, window) key pair, [B, 2, W]
    int8 in window order: sort the queries by keya (kernel locality), join,
    scatter the verdicts back through the sort permutation. (The TPU path
    packs payload << 2 | verdict into uint32 for a second sort, which capped
    a batch at 2^30 keys; the permutation has no such limit.)"""
    ok = wk["ok"]
    b, w = ok.shape
    q = torch.stack([wk["fa"], wk["ra"]], dim=1)
    q2 = torch.stack([wk["fb"], wk["rb"]], dim=1)
    ok2 = ok[:, None, :]
    q = torch.where(ok2, q, 0).reshape(-1)
    q2 = torch.where(ok2, q2, 0).reshape(-1)
    sk, perm = torch.sort(q)
    mem_s = join_membership(sidx.ika, sidx.ikb, sidx.mi, sk, q2[perm])
    mem = torch.empty_like(mem_s)
    mem[perm] = mem_s
    return mem.reshape(b, 2, w)


def _stream_verdict(ok: torch.Tensor, mem: torch.Tensor, k: int, t: int):
    """TAGGED / UNTAGGED / AMBIG per read: greedy(CONF) >= t on either
    strand proves tagged; greedy(CONF | CAND) < t on both proves untagged;
    anything else is AMBIG for the exact fallback."""
    tagged = untagged = None
    for s in range(2):
        conf = (mem[:, s] == CONF) & ok
        maybe = (mem[:, s] == CAND) & ok
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
    return _stream_verdict(wk["ok"], _membership_stream(sidx, wk), k, t)


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
