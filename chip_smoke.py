#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (commet_tpu_torch) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --plane-kernels
    python3 chip_smoke.py --join-kernels

With --plane-kernels it runs phases 1, 2 and 9's timed part only, with
--join-kernels phases 1, 2, 3 and 5's timed part only, and prints their
figures as one JSON line. To time two versions of the kernels in turns on
one card, run it in a checkout of each in one command (order: other, this,
this, other); --join-kernels needs of the package only join_membership,
join_membership_multi, JoinSlots, their plain versions and finalize_index,
so this script also runs on a checkout whose join has another design.
Phases, each printing one line with its seconds:
  1. card: the GPU's name and power limit (nvidia-smi) and torch's name;
  2. build: every hand-written kernel from commet_tpu_torch/core/csrc/
     (join.cu: commet_join, commet_join_multi; planes.cu:
     commet_build_planes, commet_probe_planes, commet_probe_planes_multi,
     commet_build_planes_range, commet_probe_planes_part; filter.cu:
     commet_class_counts), one nvcc per source, started together;
  3. kernel: the join kernel against its plain PyTorch version on the card
     at the main path's shapes (a 64M-pair k=32 index, 9M queries: one
     65,536-read batch of 100 bp x 2 strands x 69 windows), sorted and
     unsorted queries; verdicts must be identical; both times by CUDA
     events, beside the bound (the bytes it must move at the HBM rate), the
     share of query tiles whose index range the kernel stages in shared
     memory (stream.join_tile_ranges), and PyTorch calls on the same inputs
     (searchsorted of the keya column, a gather at the bound's positions, a
     copy of the keya column); then the kernel against a 128M-pair index
     (the density of the refinement's indexes);
  4. golden: the port's index_and_search CLI on tests/data (qa.fq.gz indexed,
     qb.fq searched, k=21, t=2: 3.4% fill, so the plane route) must
     reproduce tests/golden/unit/fq/, the C++ reference's payload and
     counters;
  5. multi kernel: the grouped join kernel on three 64M-pair indexes (phase
     3's index and two more that share part of its pairs and keys) against
     phase 3's 9M sorted queries; verdicts must equal its plain version's;
     the kernel, the plain version and three single-index launches timed by
     CUDA events; then one 65,536-read probe batch against the three
     indexes, its stages timed and its peak device bytes per window key;
     then the join edges: both join kernels against their plain versions
     with m around the tile size, index prefixes of 0, 1, 2 and an odd
     count, columns 8 bytes off a 16-byte boundary, equal-keya runs longer
     and shorter than the staging capacity across three tiles, queries all
     below, all above, all equal and unsorted, k = 36's greatest key,
     leading (0, 0) queries, S in {1, 3, 32, 33} with an empty slot; both
     branches of the kernel (staged, searched in device memory) must be
     taken;
  6. main path (sorted indexes): the port's commet driver (default,
     amortized schedule, k=32, t=2) on four 1M-read x 100 bp fasta sets
     made from a numpy seed: sets 2 and 3 carry 64 bp fragments of set 1 in
     half their reads, set 4 fragments of set 2's other reads, 1% of reads
     hold an N; about 1.6% fill, under the gate. The driver must say it took
     the amortized schedule, join S = 3 slots for set 4, launch both join
     kernels, and match the shared counts known from the construction
     against set 1 (slot 0) and, for set 4, against set 2 (slot 1);
  7. schedules: on four 200k-read sets, the amortized and the classic
     (COMMET_TPU_MULTI=0) driver write byte-identical .bv and matrix files,
     and --one_vs_all's vector_plain.csv cells equal
     matrix_plain[0][j]/matrix_plain[j][0];
  8. routes: the same sets with COMMET_TPU_STREAM=0 (every partition on the
     planes) and =force (every partition on the sorted index) write the
     default run's files byte for byte; the planes run must launch every
     plane kernel, the sorted run none;
  9. plane kernels at k=33 (4 GiB plane sets): the build kernel against its
     plain version on one 65,536-read batch (word-for-word equal planes),
     the planes then filled from 4M random reads; the probe of a 65,536-read
     batch (a third holding 66 bp fragments of indexed reads) against its
     plain version (equal tags); the grouped probe at S = 3 against its
     plain version and three single probes; all timed by CUDA events, each
     beside its bound (the bytes it must move at the HBM rate: the distinct
     plane sectors its atomics or needed loads touch on this run's data)
     and its share of the bound, and beside PyTorch's own index_add_ and
     gather at the same addresses and at as many random ones;
     then the edge shapes: build, probe and grouped probe against their
     plain versions at k in {15, 21, 31, 33}, t in {1, 2, 17}, S in
     {1, 3, 32}, dirty batches with internal Ns and clean ones, reads
     shorter than k, 100 and 300 bp reads;
 10. planes main path: commet -k 33 -t 2 (COMMET's defaults) on four sets of
     4M reads x 100 bp made as in phase 6 with 66 bp fragments, every
     fragment N-free (the 1% N reads are drawn among the reads that hold or
     give none); 272M k-mers per set, 3.2% fill, above the gate, so step 0
     runs the plane cohorts (three 4 GiB residents). The driver must say so,
     probe S = 3 slots for set 4, launch every plane kernel, and match the
     known shared counts;
 11. compare_reads at COMMET's defaults (-k 33 -t 2), in phase 10's
     directory after its driver: set 1 against set 2 of phase 10, each file
     with the driver's filter .bv and set name. Pass 1 (set 2 in set 1)
     must build and probe 4 GiB planes, passes 2 and 3 (the narrowed sets,
     1.6% fill) must join sorted indexes; build_planes, probe_planes and
     join must each launch; set1.fa_in_set2.bv and set2.fa_in_set1.bv must
     equal the driver's byte for byte (every index is one partition, so the
     third pass's narrowed query set tags what the full set would); each
     pass's wall, host pack and max_memory_allocated are printed;
 12. the job DAG and the host tools, in phase 7's directory right after
     phase 8: commet --jobs 2 writes the classic run's .bv and matrix files
     and 15 .job_*.done markers, launching the join, and so does --jobs 4
     (both walls beside a classic run made just before); a --sge re-run
     prints the SGE line and rewrites no .log; with the markers of pair
     (set 1, set 3) deleted a third run recomputes exactly that pair's two
     logs, the files staying equal; index_and_search -f on sets 1 and 2 equals
     compare_reads (.bv bytes and counter lines); commet_analysis rewrites
     the classic run's three CSVs byte for byte; bvop -a/-o/-d/-n with -i
     on two of its .bv's equals numpy's &, |, & ~ and ~ of the payloads
     and prints the popcount line; extract_reads of set4.fa with
     set4.fa_in_set2.bv writes exactly the fasta records of its set bits;
     generate_random_bv at 25% keeps 20-30% of set 1's reads.
 13. more than one device, in parts run where their data lives (a mesh of
     4 entries: distinct cards where the machine has them, else the one
     card repeated, whose shares then run one after another):
     13.1 (after phase 9's edges) the ranged plane build at k = 33 of phase
          9's first 65,536-read batch into 4 word ranges (1 GiB shards),
          each equal to its plain version's and to its words of
          commet_build_planes' planes, then all of phase 9's 4M reads; the
          ranged probe of phase 9's probe batch against each range, masks
          equal to the plain version's, sharded tags equal to
          probe_planes'; the class counts of a dirty 65,536-read batch
          equal to the plain version's and numpy's, then
          filter_batch_device equal to the host filter; each kernel timed
          by CUDA events beside its bound and its plain version;
     13.2 (in phase 6's directory) set 2 against set 1 (1M reads, k = 32,
          sorted index) through Engine on the mesh (DP stream and DP exact)
          and alone: equal .bv bytes and counter line;
     13.3 (in phase 10's directory, after phase 11) set 2 against set 1
          (4M reads, k = 33, planes) with mesh_mode dp (replicated planes,
          split batches) and plane (4 word shards of 1 GiB: the ranged
          build and probe kernels), each equal to the single-device call;
     13.4 (in phase 7's directory, after phase 12) the commet driver with a
          2-entry mesh engine takes the classic rounds and writes the
          classic run's files; with 2 or more cards, commet --devices 2 too;
     13.5 two commet processes on the card joined by
          COMMET_TPU_COORDINATOR (gloo, localhost), then commet_analysis:
          the classic run's files;
     13.6 (in phase 6's directory) set 1 as one sorted index cut into 4
          key-range slices; set 2's first 65,536 reads through the sharded
          stream and exact steps give the single join path's tags.
     Each part prints its walls, launches and max_memory_allocated.
Each main path (phases 6, 10, 11 and 12's --jobs run, 13.2 to 13.4's
runs, 13.1's filter) runs with every kernel's launch count set to 0 just
before it and read just after; the kernels line takes the ranged build and
probe launches from 13.3's plane-mode run and the class counts' from
13.1's filter_batch_device. At the end no module of JAX or of the JAX
package (commet_tpu) may be loaded.
Then one JSON line with the kernels' figures and, last, the device line.
Any failure raises; without a CUDA card, or without the repository beside
this script, it exits non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
import glob
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
K = 32
T = 2
INDEX_PAIRS = 64 << 20
QUERY_PAIRS = 65536 * 2 * (100 - K + 1)
SET_READS = 1_000_000
SCHED_READS = 200_000
READ_LEN = 100
FRAG = 2 * K
JOIN_SOURCE = "commet_tpu_torch/core/csrc/join.cu"
JOIN_REPLACES = "commet_tpu/core/stream.py:67"
JOIN_MULTI_REPLACES = "commet_tpu/core/stream.py:548"
PLANES_SOURCE = "commet_tpu_torch/core/csrc/planes.cu"
BUILD_REPLACES = "commet_tpu/core/kernels.py:716"
PROBE_REPLACES = "commet_tpu/core/kernels.py:405"
PROBE_MULTI_REPLACES = "commet_tpu/core/kernels.py:604"
BUILD_RANGE_REPLACES = "commet_tpu/parallel/sharded.py:114"
PROBE_PART_REPLACES = "commet_tpu/parallel/sharded.py:91"
FILTER_SOURCE = "commet_tpu_torch/core/csrc/filter.cu"
CLASS_COUNTS_REPLACES = "commet_tpu/core/kernels.py:831"
# phase 13: mesh entries (word ranges, shares, key-range slices) and the
# two ranks' time limit
MESH_N = 4
RANK_TIMEOUT = 600
# the dense-plane phases: COMMET's default k, 4 GiB plane sets
PLANE_K = 33
PLANE_BATCH = 65536
PLANE_FILL_READS = 4_000_000
PLANE_SET_READS = 4_000_000
# the plane kernels' edge shapes (phase 9): k, t and slot counts
EDGE_K = (15, 21, 31, 33)
EDGE_T = (1, 2, 17)
EDGE_S = (1, 3, 32)
# least-time bounds: the H100 SXM's HBM rate (NVIDIA's data sheet) and the
# 32 B sector, the least the card moves for a random access
HBM_BYTES_PER_S = 3.35e12
SECTOR = 32
# no single PyTorch call computes a kernel's function (no scatter-OR, no
# four-plane test with a greedy count, no three-way join verdict), so no
# library time; every kernel is bound by the bytes it moves
NO_LIBRARY = {"bound_by": "bytes", "library_ms": None}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() on the card after one warm-up call."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n_bytes: int) -> float:
    """Least milliseconds the card needs to move ``n_bytes`` at its HBM
    rate. The plane and join kernels do integer compares and bit tests,
    far below any peak rate per byte, so the bytes bound them."""
    return n_bytes / HBM_BYTES_PER_S * 1e3


def join_bytes(ikas, mis, qa, verdicts) -> int:
    """Least bytes a join of the sorted query pairs (2 x int64, read once)
    against S indexes must move: the queries, the [S, M] int8 verdicts
    written once and, per index, the sectors it cannot avoid: the ika
    sector at each query's lower-bound position, and the ikb sector there
    for each query whose keya is in the index (distinct sectors)."""
    import torch
    from commet_tpu_torch.core import stream
    total = qa.numel() * 16 + verdicts.numel()
    for ika, mi, v in zip(ikas, mis, verdicts.reshape(len(mis), -1)):
        if mi == 0:
            continue
        pos = torch.searchsorted(ika[:mi], qa).clamp_(max=mi - 1) // 4
        total += SECTOR * (torch.unique(pos).numel()
                           + torch.unique(pos[v != stream.NONMEM]).numel())
    return total


def make_join_case(device, rng, index_pairs: int, query_pairs: int):
    """A k = 32 index of ``index_pairs`` random pairs (an eighth of them
    equal-keya runs with other keyb values, a sixteenth exact duplicates, the
    all-G/T key) and ``query_pairs`` queries: a third exact index pairs, a
    third an index keya with another keyb, a third absent keya. Returns the
    StreamIndex, the queries as made and the queries sorted by keya."""
    import torch
    from commet_tpu_torch.core import stream
    top = 1 << K
    a = rng.integers(0, top, index_pairs, dtype=np.int64)
    b = rng.integers(0, top, index_pairs, dtype=np.int64)
    run = index_pairs // 8  # equal-keya runs with other keyb values
    a[index_pairs // 2:index_pairs // 2 + run] = a[:run]
    dup = index_pairs // 16  # exact duplicate pairs
    a[-dup:], b[-dup:] = a[:dup], b[:dup]
    a[1], b[1] = top - 1, top - 1  # all-G/T key
    sidx = stream.finalize_index([torch.from_numpy(a).to(device)],
                                 [torch.from_numpy(b).to(device)])
    pick = rng.integers(0, index_pairs, query_pairs)
    qa, qb = a[pick], b[pick]
    third = query_pairs // 3
    qb[third:2 * third] = rng.integers(0, top, third)  # keya-only hits
    qa[2 * third:] = rng.integers(0, top, query_pairs - 2 * third)  # absent
    qa[0], qb[0] = top - 1, top - 1
    del a, b
    qa_t = torch.from_numpy(qa).to(device)
    qb_t = torch.from_numpy(qb).to(device)
    qa_s, order = torch.sort(qa_t)  # the stream probe joins sorted keys
    return sidx, (qa_t, qb_t), (qa_s, qb_t[order])


def staged_share(stream, ika, mi: int, qa, geometry=None):
    """Share of the join's query tiles whose index range the kernel stages
    in shared memory (stream.join_tiles_staged, at the launch's geometry);
    None for a package whose join has no tiles."""
    if not hasattr(stream, "join_tiles_staged"):
        return None
    return float(stream.join_tiles_staged(ika, mi, qa, geometry)
                 .float().mean())


def _geometry(stream, mi: int, m: int):
    """The join launch's (tile, capacity), or None for a package
    whose join has no tiles."""
    if not hasattr(stream, "join_launch_geometry"):
        return None
    return list(stream.join_launch_geometry(mi, m))


def join_yardsticks(sidx, qa_s) -> dict:
    """PyTorch calls beside the join, on its inputs (none computes its
    function, the port calls none of them for the join): searchsorted of
    the sorted queries in the keya column (the keya half of the join), a
    gather of the keya column at the positions the bound charges, and a
    plain copy of the keya column (the rate a streamed read reaches)."""
    import torch
    ika = sidx.ika[:sidx.mi]
    pos = torch.searchsorted(ika, qa_s).clamp_(max=sidx.mi - 1)
    dst = torch.empty_like(ika)
    copy_ms = cuda_ms(lambda: dst.copy_(ika), 10)
    return {"searchsorted_ms": cuda_ms(
                lambda: torch.searchsorted(ika, qa_s), 10),
            "gather_ms": cuda_ms(lambda: ika[pos], 10),
            "copy_ms": copy_ms,
            "copy_gb_s": 2 * ika.numel() * 8 / copy_ms / 1e6}


def check_join(stream, sidx, qa, qb, what: str):
    """The join kernel's verdicts, held equal to the plain version's."""
    import torch
    got = stream.join_membership(sidx.ika, sidx.ikb, sidx.mi, qa, qb)
    want = stream.join_membership_plain(sidx.ika, sidx.ikb, sidx.mi, qa, qb)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"join kernel disagrees with plain version on "
                             f"{int((got != want).sum())} of {qa.numel()} "
                             f"({what})")
    return got, want


def phase_kernel(device, rng, index_pairs: int, query_pairs: int):
    """Join kernel vs join_membership_plain at the main path's shapes, its
    yardsticks, and the kernel on an index of twice the pairs (the density
    of the refinement's indexes)."""
    import torch
    from commet_tpu_torch.core import stream
    sidx, (qa_t, qb_t), (qa_s, qb_s) = make_join_case(
        device, rng, index_pairs, query_pairs)

    def kernel():
        return stream.join_membership(sidx.ika, sidx.ikb, sidx.mi, qa_s, qb_s)

    def plain():
        return stream.join_membership_plain(sidx.ika, sidx.ikb, sidx.mi,
                                            qa_s, qb_s)

    got, want = check_join(stream, sidx, qa_s, qb_s, "sorted queries")
    err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max())
    check_join(stream, sidx, qa_t, qb_t, "unsorted queries")
    counts = torch.bincount(got.to(torch.int64), minlength=3).tolist()
    if min(counts[:3]) == 0:
        raise AssertionError(f"verdict classes not all exercised: {counts}")
    empty = stream.join_membership(sidx.ika, sidx.ikb, 0, qa_s, qb_s)
    if int(empty.max()) != stream.NONMEM:
        raise AssertionError("empty index prefix must give NONMEM only")
    ms = cuda_ms(kernel, 10)
    plain_ms = cuda_ms(plain, 3)
    # the cost and benefit of sorting the queries (kept for locality)
    unsorted_ms = cuda_ms(lambda: stream.join_membership(
        sidx.ika, sidx.ikb, sidx.mi, qa_t, qb_t), 10)

    def sort_unsort():
        sk, perm = torch.sort(qa_t)
        skb = qb_t[perm]
        out = torch.empty_like(got)
        out[perm] = got
        return sk, skb, out

    sort_ms = cuda_ms(sort_unsort, 10)
    bound = bound_ms(join_bytes([sidx.ika], [sidx.mi], qa_s, got))
    yard = join_yardsticks(sidx, qa_s)
    share = staged_share(stream, sidx.ika, sidx.mi, qa_s)
    share_unsorted = staged_share(stream, sidx.ika, sidx.mi, qa_t)

    # the same queries against twice the pairs: 15 index entries a query
    big, _made, (ba_s, bb_s) = make_join_case(
        device, np.random.default_rng(128), 2 * index_pairs, query_pairs)
    bgot, _want = check_join(stream, big, ba_s, bb_s, "the larger index")
    dense = {"mi": big.mi,
             "geometry": _geometry(stream, big.mi, ba_s.numel()),
             "ms": cuda_ms(lambda: stream.join_membership(
                 big.ika, big.ikb, big.mi, ba_s, bb_s), 10),
             "bound_ms": bound_ms(join_bytes([big.ika], [big.mi], ba_s,
                                             bgot)),
             "staged_share": staged_share(stream, big.ika, big.mi, ba_s)}
    del big, ba_s, bb_s, bgot, _made, _want
    torch.cuda.empty_cache()
    return {"counts": counts, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound,
            "unsorted_ms": unsorted_ms,
            "sort_unsort_ms": sort_ms, "mi": sidx.mi,
            "geometry": _geometry(stream, sidx.mi, qa_s.numel()),
            "staged_share": share, "staged_share_unsorted": share_unsorted,
            "yardsticks": yard, "larger_index": dense,
            "launches": stream.join_membership.launches,
            "sidx": sidx, "queries": (qa_s, qb_s), "verdicts": got}


def phase_multi_kernel(device, rng, kern, probe_batch: bool = True):
    """The grouped join on phase 3's index and two more (a quarter of each
    new index's pairs copied from the first, a quarter with its keya and
    another keyb) against phase 3's sorted queries, vs its plain version
    and vs three single-index launches; then, with ``probe_batch``, one
    probe batch's stages."""
    import torch
    from commet_tpu_torch.core import keys, stream
    first = kern["sidx"]
    qa_s, qb_s = kern["queries"]
    top = 1 << K
    a0 = first.ika.cpu().numpy()
    b0 = first.ikb.cpu().numpy()
    idxs = [first]
    for _ in range(2):
        a = rng.integers(0, top, INDEX_PAIRS, dtype=np.int64)
        b = rng.integers(0, top, INDEX_PAIRS, dtype=np.int64)
        q = INDEX_PAIRS // 4
        pick = rng.integers(0, len(a0), 2 * q)
        a[:2 * q] = a0[pick]
        b[:q] = b0[pick[:q]]
        idxs.append(stream.finalize_index([torch.from_numpy(a).to(device)],
                                          [torch.from_numpy(b).to(device)]))
    del a0, b0
    slots = stream.JoinSlots([x.ika for x in idxs], [x.ikb for x in idxs],
                             [x.mi for x in idxs])

    def kernel():
        return stream.join_membership_multi(slots, qa_s, qb_s)

    def plain():
        return stream.join_membership_multi_plain(
            slots.ikas, slots.ikbs, slots.mis, qa_s, qb_s)

    def singles():
        return [stream.join_membership(x.ika, x.ikb, x.mi, qa_s, qb_s)
                for x in idxs]

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"multi join kernel disagrees with its plain "
                             f"version on {int((got != want).sum())} of "
                             f"{got.numel()}")
    if not torch.equal(got[0], kern["verdicts"]):
        raise AssertionError("multi join slot 0 differs from the single "
                             "join of phase 3")
    counts = [torch.bincount(g.to(torch.int64), minlength=3).tolist()[:3]
              for g in got]
    if min(min(c) for c in counts) == 0:
        raise AssertionError(f"verdict classes not all exercised: {counts}")
    ms = cuda_ms(kernel, 10)
    plain_ms = cuda_ms(plain, 3)
    singles_ms = cuda_ms(singles, 10)
    bound = bound_ms(join_bytes(slots.ikas, slots.mis, qa_s, got))
    timed = {"counts": counts, "max_abs_err": err, "ms": ms,
             "plain_ms": plain_ms, "bound_ms": bound,
             "singles_ms": singles_ms,
             "staged_share": [
                 staged_share(stream, x.ika, x.mi, qa_s, _geometry(
                     stream, slots.typical_mi, qa_s.numel()))
                 if hasattr(slots, "typical_mi") else None for x in idxs]}
    if not probe_batch:
        return timed

    # one probe batch of the main path's shape against the three indexes:
    # random N-free 100 bp reads
    n, lpad, wmax = 65536, 128, READ_LEN - K + 1
    words = rng.integers(0, 1 << 32, (n, lpad // 16), dtype=np.uint64)
    codes2 = keys.host_u32(words.astype(np.uint32)).to(device)
    lengths = torch.full((n,), READ_LEN, dtype=torch.int32, device=device)
    stages = {}
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ev[0].record()
    codes = keys.unpack_codes_clean(codes2, lengths, lpad)
    wk = keys.window_keys(codes, K, "both", wmax)
    ev[1].record()
    sk, skb, perm = stream._sorted_queries(wk)
    ev[2].record()
    mem_s = stream.join_membership_multi(slots, sk, skb)
    ev[3].record()
    mem = torch.empty_like(mem_s).index_copy_(1, perm, mem_s)
    verdicts = stream._multi_verdicts(
        wk["ok"], mem.reshape(len(slots), n, 2, wmax), K, T)
    ev[4].record()
    torch.cuda.synchronize()
    n_keys = n * 2 * wmax
    for i, name in enumerate(("keygen", "sort", "join", "unsort_verdict")):
        stages[name] = ev[i].elapsed_time(ev[i + 1])
    peak = torch.cuda.max_memory_allocated() - base
    want_v = stream.probe_multi_stream_clean(slots, codes2, lengths, lpad, K,
                                             T, wmax)
    if not torch.equal(verdicts, want_v):
        raise AssertionError("staged probe batch differs from "
                             "probe_multi_stream_clean")
    del codes, wk, sk, skb, perm, mem_s, mem
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    stream.probe_stream_clean(idxs[0], codes2, lengths, lpad, K, T, wmax)
    torch.cuda.synchronize()
    peak1 = torch.cuda.max_memory_allocated() - base
    return {**timed, "stages": stages, "n_keys": n_keys,
            "bytes_per_key_s3": peak / n_keys,
            "bytes_per_key_s1": peak1 / n_keys}


def _misaligned(x):
    """A copy of the 1-D tensor ``x`` whose storage starts 8 bytes off a
    16-byte boundary."""
    import torch
    buf = torch.empty(x.numel() + 2, dtype=x.dtype, device=x.device)
    out = buf[1 if buf.data_ptr() % 16 == 0 else 2:][:x.numel()]
    out.copy_(x)
    if out.data_ptr() % 16 != 8 or not out.is_contiguous():
        raise AssertionError("could not make a misaligned column")
    return out


def phase_join_edges(device, rng):
    """The join kernels against their plain versions at edge shapes, exact
    equality: m around the tile size, tiny and odd index prefixes, columns
    8 bytes off a 16-byte boundary, an equal-keya run longer than the
    staging capacity that spans three tiles' ranges (and a shorter one that
    is staged), CONF and CAND queries inside both, queries all below, all
    above and all equal, unsorted queries, keys at k = 36's greatest value,
    a leading block of (0, 0) queries with and without keya = 0 in the
    index, and the grouped kernel at S in {1, 3, 32, 33} with an empty slot
    and slots of very different sizes, from one slot a block to all S.
    Returns (cases, tiles staged, tiles searched in device memory)."""
    import torch
    from commet_tpu_torch.core import stream
    tile, cap = stream.JOIN_TILE, stream.JOIN_CAPACITY
    top = 1 << 36
    tally = {"cases": 0, "staged": 0, "global": 0}
    modes = set()  # launch geometries taken: (stages, full tile)

    def dev(x):
        return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int64)
                                ).to(device)

    def index(a, b):
        return stream.lexsort_pairs(dev(a), dev(b))

    def count_tiles(ika, mi, qa, geometry=None):
        geometry = geometry or stream.join_launch_geometry(mi, qa.numel())
        modes.add((geometry[1] > 0, geometry[0] == tile))
        staged = stream.join_tiles_staged(ika, mi, qa, geometry)
        n_staged = int(staged.sum())
        tally["staged"] += n_staged
        tally["global"] += staged.numel() - n_staged
        return n_staged, staged.numel() - n_staged

    def single(what, ika, ikb, mi, qa, qb, classes=None):
        got = stream.join_membership(ika, ikb, mi, qa, qb)
        want = stream.join_membership_plain(ika, ikb, mi, qa, qb)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"join edges, {what}: kernel differs from "
                                 f"plain on {int((got != want).sum())} of "
                                 f"{qa.numel()}")
        if classes is not None and set(torch.unique(got).tolist()) != classes:
            raise AssertionError(f"join edges, {what}: verdicts "
                                 f"{torch.unique(got).tolist()}, expected "
                                 f"{sorted(classes)}")
        tally["cases"] += 1
        return count_tiles(ika, mi, qa)

    def queries(a, b, m, lo=0, hi=top):
        """m sorted queries: half exact index pairs (their keyb kept or
        redrawn), half fresh keya in [lo, hi)."""
        pick = rng.integers(0, len(a), m)
        qa, qb = a[pick].copy(), b[pick].copy()
        qb[::3] = rng.integers(0, 8, len(qb[::3]))
        fresh = rng.random(m) < 0.5
        qa[fresh] = rng.integers(lo, hi, int(fresh.sum()))
        order = np.argsort(qa, kind="stable")
        return qa[order], qb[order]

    all3 = {stream.NONMEM, stream.CAND, stream.CONF}
    # a dense and a sparse index over the same key range: the tiles of one
    # are searched in device memory, of the other staged
    span = 1 << 20
    made = {}
    for name, n in (("dense", 60_000), ("sparse", 12_000)):
        a = rng.integers(0, span, n, dtype=np.int64)
        b = rng.integers(0, 8, n, dtype=np.int64)
        made[name] = (a, b, *index(a, b))
    for name, (a, b, ika, ikb) in made.items():
        for m in (1, tile - 1, tile, tile + 1, 3 * tile + 5):
            qa, qb = queries(a, b, m, 0, span)
            single(f"{name} m={m}", ika, ikb, len(a), dev(qa), dev(qb))
        qa, qb = queries(a, b, 3 * tile + 5, 0, span)
        st, gl = single(f"{name} sorted", ika, ikb, len(a), dev(qa), dev(qb),
                        all3)
        # (a launch against the dense index stages nothing)
        if (st, gl) != ((0, 4) if name == "dense" else (4, 0)):
            raise AssertionError(f"join edges: {name} index staged {st} and "
                                 f"searched {gl} tiles in device memory")
        for mi in (0, 1, 2, 4097, len(a) - 1):
            single(f"{name} mi={mi}", ika, ikb, mi, dev(qa), dev(qb))
        perm = rng.permutation(len(qa))
        single(f"{name} unsorted", ika, ikb, len(a), dev(qa[perm]),
               dev(qb[perm]), all3)
        # columns 8 bytes off a 16-byte boundary, each alone and all four
        cols = [ika, ikb, dev(qa), dev(qb)]
        for which in ((0,), (1,), (2,), (3,), (0, 1, 2, 3)):
            args = [_misaligned(c) if i in which else c
                    for i, c in enumerate(cols)]
            for mi in (len(a), len(a) - 1):
                single(f"{name} misaligned {which} mi={mi}", args[0], args[1],
                       mi, args[2], args[3])
        for what, val in (("below", 0), ("above", top - 1)):
            # the index shifted up by one so that 0 lies below every key
            single(f"{name} all {what}", ika + 1, ikb, len(a),
                   dev(np.full(tile + 3, val)), dev(np.zeros(tile + 3)),
                   {stream.NONMEM})
        eq = int(a[0])
        single(f"{name} all equal", ika, ikb, len(a),
               dev(np.full(2 * tile + 1, eq)),
               dev(rng.integers(0, 8, 2 * tile + 1)),
               {stream.CAND, stream.CONF})
    # equal-keya runs: one longer than the capacity (searched in device
    # memory by the three tiles whose ranges it spans), one shorter (staged)
    for name, run in (("long run", cap + 3000), ("short run", 3000)):
        other = rng.integers(0, span, 4000, dtype=np.int64)
        other[other == span // 2] += 1
        a = np.concatenate([other, np.full(run, span // 2, dtype=np.int64)])
        b = np.concatenate([rng.integers(0, 8, 4000, dtype=np.int64),
                            2 * np.arange(run, dtype=np.int64)])
        ika, ikb = index(a, b)
        below = np.sort(rng.integers(0, span // 2, tile - 100))
        above = np.sort(rng.integers(span // 2 + 1, span, tile - 100))
        qa = np.concatenate([below, np.full(tile + 200, span // 2), above])
        qb = rng.integers(0, 2 * run, len(qa))  # even: CONF, odd: CAND
        st, gl = single(name, ika, ikb, len(a), dev(qa), dev(qb), all3)
        if (st, gl) != ((0, 3) if run > cap else (3, 0)):
            raise AssertionError(f"join edges: {name} staged {st} and "
                                 f"searched {gl} tiles in device memory")
        inside = qa == span // 2
        got = stream.join_membership(ika, ikb, len(a), dev(qa), dev(qb))
        want = np.where(qb[inside] % 2 == 0, stream.CONF, stream.CAND)
        if not np.array_equal(got.cpu().numpy()[inside], want):
            raise AssertionError(f"join edges: {name}: wrong verdicts "
                                 "inside the run")
    # k = 36's greatest key, and the leading (0, 0) queries of invalid
    # windows with and without keya = 0 in the index
    a = rng.integers(top - 5000, top, 3000, dtype=np.int64)
    b = rng.integers(top - 4, top, 3000, dtype=np.int64)
    a[0], b[0] = top - 1, top - 1
    ika, ikb = index(a, b)
    qa, qb = queries(a, b, 2 * tile + 9, top - 5000, top)
    qa[-1], qb[-1] = top - 1, top - 1
    got = stream.join_membership(ika, ikb, len(a), dev(qa), dev(qb))
    if int(got[-1]) != stream.CONF:
        raise AssertionError("join edges: the greatest k = 36 pair is not "
                             "CONF")
    single("k = 36 greatest keys", ika, ikb, len(a), dev(qa), dev(qb), all3)
    for zeros, first in (((0, 0), stream.CONF), ((0, 5), stream.CAND),
                         (None, stream.NONMEM)):
        a = rng.integers(1, span, 5000, dtype=np.int64)
        b = rng.integers(0, 8, 5000, dtype=np.int64)
        if zeros is not None:
            a[:3], b[:3] = zeros[0], zeros[1]
        ika, ikb = index(a, b)
        qa, qb = queries(a, b, 2 * tile, 1, span)
        qa[:tile + 300] = qb[:tile + 300] = 0
        single(f"leading (0, 0) queries, index zeros {zeros}", ika, ikb,
               len(a), dev(qa), dev(qb))
        got = stream.join_membership(ika, ikb, len(a), dev(qa), dev(qb))
        if set(torch.unique(got[:tile + 300]).tolist()) != {first}:
            raise AssertionError(f"join edges: (0, 0) queries against index "
                                 f"zeros {zeros} are not all {first}")
    # the grouped kernel: slots cycle over a large, an empty, a tiny and a
    # sparse index; short streams take one slot a block, long ones all S
    da, db, dika, dikb = made["dense"]
    _sa, _sb, sika, sikb = made["sparse"]
    cycle = [(dika, dikb, len(da)), (dika, dikb, 0), (sika, sikb, 7),
             (sika, sikb, len(_sa)), (_misaligned(dika), dikb, len(da) - 1)]
    for m in (3 * tile + 5, 200 * tile + 7, 400 * tile + 5):
        qa, qb = queries(da, db, m, 0, span)
        qa_t, qb_t = dev(qa), dev(qb)
        for s in (1, 3, 32, 33):
            picks = [cycle[j % len(cycle)] for j in range(s)]
            slots = stream.JoinSlots([p[0] for p in picks],
                                     [p[1] for p in picks],
                                     [p[2] for p in picks])
            got = stream.join_membership_multi(slots, qa_t, qb_t)
            want = stream.join_membership_multi_plain(
                slots.ikas, slots.ikbs, slots.mis, qa_t, qb_t)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(
                    f"join edges, S={s} m={m}: grouped kernel differs from "
                    f"plain on {int((got != want).sum())} of {got.numel()}")
            if s > 1 and int(got[1].max()) != stream.NONMEM:
                raise AssertionError("join edges: the empty slot is not all "
                                     "NONMEM")
            tally["cases"] += 1
            geometry = stream.join_launch_geometry(slots.typical_mi, m)
            for p in picks[:len(cycle)]:
                count_tiles(p[0], p[2], qa_t, geometry)
    # a density at which the launch shortens its tile to stage it
    a = rng.integers(0, span, 38_748, dtype=np.int64)
    b = rng.integers(0, 8, len(a), dtype=np.int64)
    ika, ikb = index(a, b)
    qa, qb = queries(a, b, 4 * tile + 5, 0, span)
    single("shortened tile", ika, ikb, len(a), dev(qa), dev(qb), all3)
    want = {(True, True), (True, False), (False, True)}
    if tally["staged"] == 0 or tally["global"] == 0 or modes != want:
        raise AssertionError(f"join edges: branches taken {tally}, launch "
                             f"geometries {sorted(modes)}")
    return tally["cases"], tally["staged"], tally["global"]


def _pack_codes(codes: np.ndarray) -> np.ndarray:
    """[n, L] codes 0..3 -> [n, ceil(L/16)] uint32 2-bit words, base p at
    bits 2*(p%16) of word p/16."""
    n, length = codes.shape
    w = -(-length // 16)
    c = np.zeros((n, w * 16), dtype=np.uint32)
    c[:, :length] = codes
    shifts = 2 * np.arange(16, dtype=np.uint32)
    return np.bitwise_or.reduce(c.reshape(n, w, 16) << shifts, axis=2)


def _unpack_codes(words: np.ndarray, length: int) -> np.ndarray:
    shifts = 2 * np.arange(16, dtype=np.uint32)
    codes = (words[:, :, None] >> shifts) & 3
    return codes.reshape(len(words), -1)[:, :length].astype(np.uint8)


def _events_ms(fns) -> float:
    """Milliseconds of running every fn in ``fns`` once, by CUDA events."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for fn in fns:
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def _plane_fill(pl, k: int) -> float:
    """Share of plane A's 2^k bits that are set (a popcount by bit tricks
    over int64 chunks of the uint32 words)."""
    import torch
    from commet_tpu_torch.core import planes
    w = planes.plane_words(k)
    ones = 0
    for start in range(0, w, 1 << 26):
        x = pl[start:min(w, start + (1 << 26))].to(torch.int64) & 0xFFFFFFFF
        x = x - ((x >> 1) & 0x55555555)
        x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
        x = (x + (x >> 4)) & 0x0F0F0F0F
        ones += int((((x * 0x01010101) & 0xFFFFFFFF) >> 24).sum())
    return ones / float(w * 32)


def _complete_windows(lengths, length: int, k: int) -> int:
    """Complete windows of N-free reads of ``lengths`` in a batch padded to
    ``length``."""
    return int((lengths.clamp(max=length) - k + 1).clamp(min=0).sum())


def _sectors(words) -> int:
    """Distinct 32 B sectors (8 words) among int64 word addresses."""
    import torch
    return torch.unique(words >> 3).numel()


def _build_addrs(c2, lengths, length: int, k: int):
    """Word addresses, into one four-plane set, of the build's atomics on
    these N-free reads: four per complete window, repeats kept."""
    import torch
    from commet_tpu_torch.core import keys, planes
    a, b = keys.index_keys(keys.unpack_codes_clean(c2, lengths, length), k)
    w = planes.plane_words(k)
    return torch.cat([p * w + (key >> 5) for p, key in
                      enumerate(planes.four_plane_keys(a, b))])


def _probe_addrs(pl, c2, lengths, length: int, k: int, t: int, wmax: int):
    """Word addresses, into ``pl``, of the plane loads the sequential probe
    needs on these N-free reads, repeats kept: per strand, a plane-A load
    for each window it reaches (complete, at or past the greedy skip,
    before the count reaches t) and B, C, D loads for each of those whose
    A bit is set; the reverse strand only for reads whose forward count
    stays below t."""
    import torch
    from commet_tpu_torch.core import keys, planes
    wk = keys.window_keys(keys.unpack_codes_clean(c2, lengths, length), k,
                          "both", wmax)
    ok = wk["ok"]
    n = ok.shape[0]
    pw = planes.plane_words(k)
    counting = torch.ones(n, dtype=torch.bool, device=ok.device)
    addrs = []
    for s in ("f", "r"):
        a = torch.where(ok, wk[s + "a"], 0)
        b = torch.where(ok, wk[s + "b"], 0)
        word, bit = planes.plane_addr(a)
        hit_a = ((pl[word].to(torch.int64) >> bit) & 1 == 1) & ok
        member = planes._plane_member(pl, a, b, k) & ok
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
        for p, key in enumerate(planes.four_plane_keys(a, b)):
            addrs.append(p * pw + (key[reached if p == 0 else
                                       reached & hit_a] >> 5))
    return torch.cat(addrs)


def _plane_reads(device, gen_seed: int, lpad: int):
    """Phase 9's indexed reads: PLANE_FILL_READS random N-free 100 bp reads
    as [n, lpad / 16] int32 code words, from a torch generator seeded with
    ``gen_seed``, and the generator."""
    import torch
    gen = torch.Generator(device=device)
    gen.manual_seed(gen_seed)
    words = torch.randint(-2 ** 31, 2 ** 31, (PLANE_FILL_READS, lpad // 16),
                          dtype=torch.int32, device=device, generator=gen)
    return words, gen


def _probe_batch(words, device, gen_seed: int, lpad: int):
    """Phase 9's probe batch: PLANE_BATCH random reads, a third holding a
    2k bp fragment of an indexed read (N-free: lengths carry the validity),
    as code words on the card."""
    import torch
    n, k = PLANE_BATCH, PLANE_K
    rng = np.random.default_rng(gen_seed)
    qcodes = rng.integers(0, 4, (n, READ_LEN), dtype=np.uint8)
    third = n // 3
    donors = rng.integers(0, PLANE_FILL_READS, third)
    dcodes = _unpack_codes(words[torch.from_numpy(donors).to(device)]
                           .cpu().numpy().view(np.uint32), READ_LEN)
    frag = 2 * k
    src = rng.integers(0, READ_LEN - frag + 1, third)
    dst = rng.integers(0, READ_LEN - frag + 1, third)
    off = np.arange(frag)
    qcodes[np.arange(third)[:, None], dst[:, None] + off] = \
        dcodes[np.arange(third)[:, None], src[:, None] + off]
    return torch.from_numpy(_pack_codes(np.pad(
        qcodes, ((0, 0), (0, lpad - READ_LEN)))).view(np.int32)).to(device)


def phase_plane_kernels(device, gen_seed: int):
    """The plane kernels at k = 33 (4 GiB plane sets) against their plain
    versions: the build on one 65,536-read x 100 bp batch (word-for-word
    equal planes), then timed on more batches into both plane sets; the
    kernel's set then filled from 4M random reads (272M k-mers); the probe
    of one 65,536-read batch, a third of whose reads hold a 66 bp fragment
    of an indexed read, kernel vs plain (equal tags, every fragment read
    tagged); the grouped probe at S = 3 vs its plain version and vs three
    single launches. Each kernel's bound: the bytes it must move at the
    HBM rate (bound_ms)."""
    import torch
    from commet_tpu_torch.core import planes
    k, n, lpad = PLANE_K, PLANE_BATCH, 128
    wmax = READ_LEN - k + 1
    words, gen = _plane_reads(device, gen_seed, lpad)
    lengths = torch.full((n,), READ_LEN, dtype=torch.int32, device=device)
    batches = [words[i:i + n] for i in range(0, PLANE_FILL_READS, n)]

    def build(pl, c2):
        return planes.build_planes(pl, c2, lengths[:len(c2)], True, lpad, k)

    def build_plain(pl, c2):
        return planes.build_planes_plain(pl, c2, lengths[:len(c2)], True,
                                         lpad, k)

    kern = planes.alloc_planes(k, device)
    plain = planes.alloc_planes(k, device)
    build(kern, batches[0])
    build_plain(plain, batches[0])
    torch.cuda.synchronize()
    if not torch.equal(kern, plain):
        raise AssertionError(f"build kernel differs from its plain version "
                             f"in {int((kern != plain).sum())} words")
    reps = 4  # fresh batches: each call sets new bits, as a build does
    timed = batches[1:1 + reps]
    ms = _events_ms([lambda b=b: build(kern, b) for b in timed])
    plain_ms = _events_ms([lambda b=b: build_plain(plain, b) for b in timed])
    if not torch.equal(kern, plain):
        raise AssertionError("build kernel differs from its plain version "
                             "after the timed batches")
    build_err = int((kern != plain).sum())
    # each batch: its words and lengths read once, and every distinct plane
    # sector its atomics touch read and written once
    build_windows = sum(_complete_windows(lengths[:len(b)], lpad, k)
                        for b in timed) // reps
    build_addrs = [_build_addrs(b, lengths[:len(b)], lpad, k) for b in timed]
    build_sectors = sum(_sectors(x) for x in build_addrs) // reps
    build_bytes = (timed[0].numel() * 4 + n * 4
                   + 2 * SECTOR * build_sectors)
    yard = _atomic_yardsticks(build_addrs[0], 4 * planes.plane_words(k), gen)
    del build_addrs
    t0 = time.perf_counter()
    for b in batches[1 + reps:]:
        build(kern, b)
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    fill = _plane_fill(kern, k)

    qc2 = _probe_batch(words, device, gen_seed, lpad)
    third = n // 3

    def probe(pl):
        return planes.probe_planes(pl, qc2, lengths, True, lpad, k, T, wmax)

    def probe_plain(pl):
        return planes.probe_planes_plain(pl, qc2, lengths, True, lpad, k, T,
                                         wmax)

    got, want = probe(kern), probe_plain(kern)
    torch.cuda.synchronize()
    probe_err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"probe kernel differs from its plain version "
                             f"on {int((got != want).sum())} of {n} reads")
    if not bool(got[:third].all()):
        raise AssertionError("a read holding an indexed fragment is untagged")
    tagged_random = int(got[third:].sum())
    probe_ms = cuda_ms(lambda: probe(kern), 10)
    probe_plain_ms = cuda_ms(lambda: probe_plain(kern), 3)
    # the batch read once, the tags written once, and every distinct plane
    # sector of the loads the probe needs read once
    batch_bytes = qc2.numel() * 4 + n * 4
    probe_addrs = _probe_addrs(kern, qc2, lengths, lpad, k, T, wmax)
    probe_loads, probe_sectors = probe_addrs.numel(), _sectors(probe_addrs)
    yard.update(_gather_yardsticks(kern, probe_addrs, gen))
    del probe_addrs

    # S = 3: the filled set, the plain-built set, one more from 1M reads
    third_set = planes.alloc_planes(k, device)
    gen.manual_seed(gen_seed + 1)
    for _ in range(PLANE_FILL_READS // 4 // n):
        build(third_set, torch.randint(-2 ** 31, 2 ** 31, (n, lpad // 16),
                                       dtype=torch.int32, device=device,
                                       generator=gen))
    slots = planes.PlaneSlots([kern, plain, third_set])

    def multi():
        return planes.probe_planes_multi(slots, qc2, lengths, True, lpad, k,
                                         T, wmax)

    def multi_plain():
        return planes.probe_planes_multi_plain(slots.planes, qc2, lengths,
                                               True, lpad, k, T, wmax)

    def singles():
        return [probe(pl) for pl in slots.planes]

    mgot, mwant = multi(), multi_plain()
    torch.cuda.synchronize()
    multi_err = int((mgot.to(torch.int32) - mwant.to(torch.int32)).abs()
                    .max())
    if not torch.equal(mgot, mwant):
        raise AssertionError(f"grouped probe kernel differs from its plain "
                             f"version on {int((mgot != mwant).sum())} tags")
    if not torch.equal(mgot[0], got) or not torch.equal(
            torch.stack(singles()), mgot):
        raise AssertionError("grouped probe differs from the single probes")
    multi_ms = cuda_ms(multi, 10)
    multi_plain_ms = cuda_ms(multi_plain, 3)
    singles_ms = cuda_ms(singles, 10)
    multi_loads = multi_sectors = 0
    for pl in slots.planes:  # distinct sectors per plane set
        addrs = _probe_addrs(pl, qc2, lengths, lpad, k, T, wmax)
        multi_loads += addrs.numel()
        multi_sectors += _sectors(addrs)
    return {
        "build": {"max_abs_err": build_err, "ms": ms / reps,
                  "plain_ms": plain_ms / reps,
                  "bound_ms": bound_ms(build_bytes)},
        "probe": {"max_abs_err": probe_err, "ms": probe_ms,
                  "plain_ms": probe_plain_ms,
                  "bound_ms": bound_ms(batch_bytes
                                       + SECTOR * probe_sectors)},
        "multi": {"max_abs_err": multi_err, "ms": multi_ms,
                  "plain_ms": multi_plain_ms,
                  "bound_ms": bound_ms(batch_bytes + 2 * n * 4
                                       + SECTOR * multi_sectors)},
        "singles_ms": singles_ms, "fill": fill, "fill_s": fill_s,
        "build_windows": build_windows, "build_sectors": build_sectors,
        "probe_loads": probe_loads, "probe_sectors": probe_sectors,
        "multi_loads": multi_loads, "multi_sectors": multi_sectors,
        "yardsticks": yard,
        "tagged": [int(x.sum()) for x in mgot],
        "tagged_random": tagged_random}


def _atomic_yardsticks(addrs, words: int, gen) -> dict:
    """PyTorch's own atomics at the build's address mix: ms of
    ``index_add_`` of int32 ones into a zeroed four-plane set at the
    build's word addresses (all four planes, then plane D's alone), and at
    as many uniform random words of the set."""
    import torch
    arr = torch.zeros(words, dtype=torch.int32, device=addrs.device)
    d = addrs[3 * addrs.numel() // 4:]  # four_plane_keys order: A, B, C, D
    out = {}
    for name, idx in (("build_addrs", addrs), ("d_addrs", d)):
        ones = torch.ones(idx.numel(), dtype=torch.int32, device=idx.device)
        rnd = torch.randint(0, words, (idx.numel(),), device=idx.device,
                            generator=gen)
        out[f"index_add_{name}_ms"] = cuda_ms(
            lambda: arr.index_add_(0, idx, ones), 10)
        out[f"index_add_{name}_random_ms"] = cuda_ms(
            lambda: arr.index_add_(0, rnd, ones), 10)
    return out


def _gather_yardsticks(pl, addrs, gen) -> dict:
    """PyTorch's own gather at the probe's loads: ms of ``pl[addrs]`` at
    the word addresses the probe needs, and at as many uniform random
    words of the set."""
    import torch
    rnd = torch.randint(0, pl.numel(), (addrs.numel(),), device=pl.device,
                        generator=gen)
    return {"gather_probe_addrs_ms": cuda_ms(lambda: pl[addrs], 10),
            "gather_random_ms": cuda_ms(lambda: pl[rnd], 10)}


def _edge_reads(rng, n: int, k: int, n_frac: float):
    """[n, 320] codes (4 = N or past the read's end) of reads whose lengths
    mix shorter than k (a fifth), 100 bp and 300 bp, with Ns at n_frac."""
    lens = rng.choice([100, 300], n)
    lens[:n // 5] = rng.integers(1, k, n // 5)
    codes = rng.integers(0, 4, (n, 320), dtype=np.uint8)
    codes[rng.random((n, 320)) < n_frac] = 4
    codes[np.arange(320) >= lens[:, None]] = 4
    return codes, lens


def _edge_pack(device, codes, lens, clean: bool):
    """(codes2, aux) of ``codes`` on the card: aux the lengths (clean: the
    Ns become A) or the validity words."""
    import torch
    n, length = codes.shape
    body = np.arange(length) < lens[:, None]
    c2 = torch.from_numpy(_pack_codes(np.where(codes < 4, codes, 0)
                                      ).view(np.int32)).to(device)
    if clean:
        return c2, torch.from_numpy(lens.astype(np.int32)).to(device)
    v = (codes < 4) & body
    words = np.bitwise_or.reduce(
        v.reshape(n, length // 32, 32).astype(np.uint32)
        << np.arange(32, dtype=np.uint32), axis=2)
    return c2, torch.from_numpy(words.view(np.int32)).to(device)


def phase_plane_edges(device, rng):
    """The plane kernels against their plain versions at edge shapes, for k
    in EDGE_K: dirty batches (internal Ns, validity words) and clean ones
    (lengths), reads shorter than k, 100 and 300 bp reads (up to nine
    32-window chunks a strand), queries holding a 2k fragment of an indexed
    read and 300 bp queries holding a whole indexed 300 bp read; t in
    EDGE_T, the grouped probe at S in EDGE_S (slots cycling over the built
    set, a second set and an empty one). Returns the cases checked."""
    import torch
    from commet_tpu_torch.core import planes
    cases = 0
    for k in EDGE_K:
        idx, idx_lens = _edge_reads(rng, 20_000, k, 0.003)
        got = planes.alloc_planes(k, device)
        want = planes.alloc_planes(k, device)
        for clean in (False, True):
            c2, aux = _edge_pack(device, idx, idx_lens, clean)
            planes.build_planes(got, c2, aux, clean, 320, k)
            planes.build_planes_plain(want, c2, aux, clean, 320, k)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"k={k}: build kernel differs from its "
                                 f"plain version in "
                                 f"{int((got != want).sum())} words")
        other = planes.alloc_planes(k, device)
        c2, aux = _edge_pack(device, idx[::-1].copy(), idx_lens[::-1].copy(),
                             True)
        planes.build_planes(other, c2, aux, True, 320, k)
        empty = planes.alloc_planes(k, device)
        qry, q_lens = _edge_reads(rng, 4000, k, 0.003)
        long_rows = np.nonzero(idx_lens == 300)[0]
        for i in range(0, 4000, 2):  # even queries: an indexed fragment
            d = long_rows[rng.integers(len(long_rows))]
            if i % 8 == 0:  # a whole indexed 300 bp read
                qry[i], q_lens[i] = idx[d], 300
            elif q_lens[i] >= 2 * k:
                at = rng.integers(0, q_lens[i] - 2 * k + 1)
                src = rng.integers(0, 300 - 2 * k + 1)
                qry[i, at:at + 2 * k] = idx[d, src:src + 2 * k]
        sets = {s: planes.PlaneSlots([(got, other, empty)[j % 3]
                                      for j in range(s)]) for s in EDGE_S}
        for clean in (False, True):
            c2, aux = _edge_pack(device, qry, q_lens, clean)
            for t in EDGE_T:
                for wmax in (320 - k + 1, 100 - k + 1):
                    one = planes.probe_planes(got, c2, aux, clean, 320, k, t,
                                              wmax)
                    ref = planes.probe_planes_plain(got, c2, aux, clean, 320,
                                                    k, t, wmax)
                    torch.cuda.synchronize()
                    if not torch.equal(one, ref):
                        raise AssertionError(
                            f"k={k} t={t} clean={clean} wmax={wmax}: probe "
                            f"kernel differs from its plain version on "
                            f"{int((one != ref).sum())} reads")
                    if t <= 2 and int(one.sum()) < 200:
                        raise AssertionError(f"k={k} t={t}: only "
                                             f"{int(one.sum())} reads tagged")
                    for s, slots in sets.items():
                        multi = planes.probe_planes_multi(
                            slots, c2, aux, clean, 320, k, t, wmax)
                        ref = planes.probe_planes_multi_plain(
                            slots.planes, c2, aux, clean, 320, k, t, wmax)
                        torch.cuda.synchronize()
                        if not torch.equal(multi, ref):
                            raise AssertionError(
                                f"k={k} t={t} S={s} clean={clean} "
                                f"wmax={wmax}: grouped probe differs from "
                                f"its plain version on "
                                f"{int((multi != ref).sum())} tags")
                        cases += 1
        del got, want, other, empty, sets
        torch.cuda.empty_cache()
    return cases


def phase_golden(device: str, tmp: str) -> str:
    """The port's index_and_search on the in-repo fq golden: the .bv bytes
    after its comment line (the comment names the input path, which moved)
    and the counter line must equal the C++ reference's."""
    from commet_tpu_torch.cli import index_and_search
    data = os.path.join(HERE, "tests", "data")
    golden = os.path.join(HERE, "tests", "golden", "unit", "fq")
    fof_i, fof_s = os.path.join(tmp, "idx.txt"), os.path.join(tmp, "qry.txt")
    with open(fof_i, "w") as f:
        f.write(f"QA: {data}/qa.fq.gz\n")
    with open(fof_s, "w") as f:
        f.write(f"QB: {data}/qb.fq\n")
    out = os.path.join(tmp, "golden_out")
    rc = index_and_search.main(["-i", fof_i, "-s", fof_s, "-o", out, "-l",
                                out, "-k", "21", "-t", "2", "--device",
                                device])
    if rc != 0:
        raise AssertionError(f"index_and_search exited {rc}")
    with open(os.path.join(out, "qb.fq_in_QA.bv"), "rb") as f:
        comment, got = f.read().split(b"\n", 1)
    with open(os.path.join(golden, "qb.fq_in_QA.bv"), "rb") as f:
        want = f.read().split(b"\n", 1)[1]
    if comment != f"{data}/qb.fq in QA".encode() or got != want:
        raise AssertionError("qb.fq_in_QA.bv differs from the golden")
    with open(os.path.join(out, "QB_in_QA.log")) as f:
        counters = f.read().splitlines()[-1]
    with open(os.path.join(golden, "QB_in_QA.log.counters")) as f:
        if counters != f.read().strip():
            raise AssertionError(f"counters {counters} differ from golden")
    return counters


def _write_fasta(path: str, codes: np.ndarray) -> None:
    """[n, L] codes (0..3, 4 = N) -> fasta with headers >r<8 digits>."""
    n = codes.shape[0]
    head = np.empty((n, 11), dtype=np.uint8)
    head[:, 0], head[:, 1], head[:, 10] = ord(">"), ord("r"), ord("\n")
    head[:, 2:10] = (np.arange(n)[:, None] // 10 ** np.arange(7, -1, -1)) \
        % 10 + ord("0")
    body = np.frombuffer(b"ACGTN", np.uint8)[codes]
    newline = np.full((n, 1), ord("\n"), dtype=np.uint8)
    np.concatenate([head, body, newline], axis=1).tofile(path)


def _implant(rng, sets, q: int, donor: int, rows, donor_rows, frag: int):
    """Copy a ``frag`` bp fragment (2k: two non-overlapping k-mers) of a
    random ``donor_rows`` read of set ``donor`` into each ``rows`` read of
    set ``q``; returns the known shared counts (set q reads holding an
    N-free fragment, distinct donor reads of such fragments) and the donor
    rows."""
    donors = donor_rows[rng.integers(0, len(donor_rows), len(rows))]
    src = rng.integers(0, READ_LEN - frag + 1, len(rows))
    dst = rng.integers(0, READ_LEN - frag + 1, len(rows))
    off = np.arange(frag)
    s, d = sets[q], sets[donor]
    fragments = d[donors[:, None], src[:, None] + off]
    s[rows[:, None], dst[:, None] + off] = fragments
    # the bases beside a fragment differ from the donor's, so a shared
    # window never extends past it: a read is shared iff its fragment is
    # N-free (two non-overlapping k-mers)
    for side, ok in ((-1, (src > 0) & (dst > 0)),
                     (frag, (src + frag < READ_LEN)
                      & (dst + frag < READ_LEN))):
        r, qs, ds = rows[ok], dst[ok] + side, src[ok] + side
        s[r, qs] = (d[donors[ok], ds] + 1) % 4
    clean = (fragments < 4).all(axis=1)
    return (int(clean.sum()), len(np.unique(donors[clean]))), donors


def make_sets(rng, tmp: str, n_reads: int, frag: int = FRAG,
              n_free_fragments: bool = False):
    """Four fasta sets: sets 2 and 3 hold ``frag`` bp fragments of set 1 in
    their even reads, set 4 fragments of set 2's odd reads (which hold none
    of set 1) in its even reads; 1% of each set's reads carry one N, drawn
    before the fragments or, with ``n_free_fragments``, after them among
    the reads that neither hold nor give a fragment. Returns the manifest
    path and the known shared counts {(query set, donor set): (n_query,
    n_donor)}, 0-based."""
    sets = [rng.integers(0, 4, (n_reads, READ_LEN), dtype=np.uint8)
            for _ in range(4)]

    def add_ns(s, rows):
        rows = rng.choice(rows, n_reads // 100, replace=False)
        s[rows, rng.integers(0, READ_LEN, len(rows))] = 4

    if not n_free_fragments:
        for s in sets:
            add_ns(s, n_reads)
    even, odd = np.arange(0, n_reads, 2), np.arange(1, n_reads, 2)
    expected = {}
    used = [np.zeros(n_reads, dtype=bool) for _ in sets]
    for q, donor, donor_rows in ((1, 0, np.arange(n_reads)),
                                 (2, 0, np.arange(n_reads)), (3, 1, odd)):
        expected[(q, donor)], donors = _implant(rng, sets, q, donor, even,
                                                donor_rows, frag)
        used[q][even] = used[donor][donors] = True
    if n_free_fragments:
        for s, u in zip(sets, used):
            add_ns(s, np.nonzero(~u)[0])
    lines = []
    for i, s in enumerate(sets):
        path = os.path.join(tmp, f"set{i + 1}.fa")
        _write_fasta(path, s)
        lines.append(f"set{i + 1}: {path}")
    fof = os.path.join(tmp, "sets.txt")
    with open(fof, "w") as f:
        f.write("\n".join(lines) + "\n")
    return fof, expected


class _Tee(io.TextIOBase):
    """Standard output that is also kept, to read the driver's lines."""

    def __init__(self, out):
        self.out, self.kept = out, io.StringIO()

    def write(self, text):
        self.out.write(text)
        self.kept.write(text)
        return len(text)

    def flush(self):
        self.out.flush()


def read_matrix(path: str) -> np.ndarray:
    with open(path) as f:
        rows = [ln.split(";") for ln in f.read().splitlines()]
    return np.array([[int(v) for v in r[1:]] for r in rows[1:]])


def phase_main_path(device: str, rng, tmp: str, n_reads: int, k: int,
                    schedule: str, frag: int, n_free_fragments: bool = False):
    """The commet driver, default schedule, on four sets; it must say it
    took ``schedule``. Returns per-call wall times, the largest slot count,
    the matrix and the peak memory."""
    import torch
    from commet_tpu_torch.cli import commet
    from commet_tpu_torch.device import synchronize
    from commet_tpu_torch.engine.engine import Engine
    t0 = time.perf_counter()
    fof, expected = make_sets(rng, tmp, n_reads, frag, n_free_fragments)
    calls = [("make_sets (host, numpy; not the driver)",
              time.perf_counter() - t0)]
    slots = []
    real = {name: getattr(Engine, name) for name in (
        "index_and_search", "search_multi_set", "search_multi_set_planes")}

    def timed_pair(self, index_set, query_sets, **kw):
        t0 = time.perf_counter()
        out = real["index_and_search"](self, index_set, query_sets, **kw)
        synchronize(self.device)
        names = "+".join(q.name for q in query_sets)
        calls.append((f"index_and_search {names} in {index_set.name} (host "
                      f"pack {self.last_io_stats.get('host_pack_s', 0.0):.3f}"
                      " s of the last search)", time.perf_counter() - t0))
        return out

    def timed_multi(name):
        def run(self, query_set, residents, **kw):
            t0 = time.perf_counter()
            out = real[name](self, query_set, residents, **kw)
            synchronize(self.device)
            slots.append(sum(len(r.partitions) for r in residents))
            names = ", ".join(r.name for r in residents)
            io_s = self.last_io_stats
            calls.append((f"{name} {query_set.name} in {{{names}}} "
                          f"(S = {slots[-1]}; host pack "
                          f"{io_s.get('host_pack_s', 0.0):.3f} s, dispatch "
                          f"waited {io_s.get('host_block_s', 0.0):.3f} s)",
                          time.perf_counter() - t0))
            return out
        return run

    Engine.index_and_search = timed_pair
    Engine.search_multi_set = timed_multi("search_multi_set")
    Engine.search_multi_set_planes = timed_multi("search_multi_set_planes")
    tee = _Tee(sys.stdout)
    try:
        out = os.path.join(tmp, "commet_out") + "/"
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(tee):
            rc = commet.main([fof, "-k", str(k), "-t", str(T), "--no-plots",
                              "-o", out, "--device", device])
        calls.append(("commet driver, whole run", time.perf_counter() - t0))
    finally:
        for name, fn in real.items():
            setattr(Engine, name, fn)
    if rc != 0:
        raise AssertionError(f"commet exited {rc}")
    said = tee.kept.getvalue()
    if f"schedule: {schedule}" not in said or "schedule: classic" in said:
        raise AssertionError(f"the driver did not take the {schedule} "
                             "schedule")
    if max(slots, default=0) != 3:
        raise AssertionError(f"set 4 probed {slots} slots, expected 3")
    for kind in ("plain", "percentage", "normalized"):
        if not os.path.exists(out + f"matrix_{kind}.csv"):
            raise AssertionError(f"matrix_{kind}.csv missing")
    plain = read_matrix(out + "matrix_plain.csv")
    for (q, donor), (n_query, n_donor) in expected.items():
        if plain[q, donor] != n_query or plain[donor, q] != n_donor:
            raise AssertionError(
                f"set{q + 1} vs set{donor + 1}: matrix ({plain[q, donor]}, "
                f"{plain[donor, q]}) != expected ({n_query}, {n_donor})")
    peak = (torch.cuda.max_memory_allocated()
            if device.startswith("cuda") else 0)
    return calls, max(slots), plain, peak


def phase_schedules(device: str, rng, tmp: str, n_reads: int):
    """Amortized vs classic driver, then --one_vs_all, on four sets."""
    from commet_tpu_torch.cli import commet
    fof, _expected = make_sets(rng, tmp, n_reads)
    runs, walls = {}, {}
    for name, env, extra in (("amortized", "1", []), ("classic", "0", []),
                             ("one_vs_all", "1", ["--one_vs_all"])):
        os.environ["COMMET_TPU_MULTI"] = env
        out = os.path.join(tmp, name) + "/"
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                rc = commet.main([fof, "-k", str(K), "-t", str(T),
                                  "--no-plots", "-o", out, "--device",
                                  device] + extra)
        finally:
            del os.environ["COMMET_TPU_MULTI"]
        if rc != 0:
            raise AssertionError(f"commet ({name}) exited {rc}")
        runs[name], walls[name] = out, time.perf_counter() - t0
    files = sorted(os.path.basename(p) for p in
                   glob.glob(runs["classic"] + "*_in_*.bv")
                   + glob.glob(runs["classic"] + "matrix_*.csv"))
    if len(files) != 4 * 3 + 3:
        raise AssertionError(f"classic run wrote {len(files)} files")
    for name in files:
        with open(runs["amortized"] + name, "rb") as f1, \
                open(runs["classic"] + name, "rb") as f2:
            if f1.read() != f2.read():
                raise AssertionError(f"{name}: amortized != classic")
    plain = read_matrix(runs["classic"] + "matrix_plain.csv")
    with open(runs["one_vs_all"] + "vector_plain.csv") as f:
        cells = f.read().splitlines()[1].split(";")[1:]
    want = [f"{plain[0, j]}/{plain[j, 0]}" for j in range(len(plain))]
    if cells != want:
        raise AssertionError(f"vector_plain {cells} != matrix {want}")
    return len(files), cells, walls, fof, runs["amortized"], files


def phase_routes(device: str, tmp: str, fof: str, default_out: str, files):
    """The driver on phase 7's sets with COMMET_TPU_STREAM=0 (every
    partition on the planes: plane cohorts, plane refinement) and =force
    (every partition on the sorted index): the .bv and matrix files of
    the default run. Returns each route's wall, schedule line and plane
    kernel launches."""
    import torch
    from commet_tpu_torch.cli import commet
    from commet_tpu_torch.core import planes
    report = {}
    for name, mode in (("planes", "0"), ("sorted", "force")):
        counts = _plane_launches(planes)
        torch.cuda.empty_cache()
        os.environ["COMMET_TPU_STREAM"] = mode
        out = os.path.join(tmp, "route_" + name) + "/"
        tee = _Tee(io.StringIO())
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(tee):
                rc = commet.main([fof, "-k", str(K), "-t", str(T),
                                  "--no-plots", "-o", out, "--device",
                                  device])
        finally:
            del os.environ["COMMET_TPU_STREAM"]
        wall = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"commet ({name} route) exited {rc}")
        for f in files:
            with open(default_out + f, "rb") as f1, open(out + f, "rb") as f2:
                if f1.read() != f2.read():
                    raise AssertionError(f"{f}: {name} route != default")
        launched = [b - a for a, b in zip(counts, _plane_launches(planes))]
        line = [ln for ln in tee.kept.getvalue().splitlines()
                if ln.startswith("schedule:")][0]
        report[name] = (wall, line, launched)
    if min(report["planes"][2]) == 0 or max(report["sorted"][2]) != 0:
        raise AssertionError(f"plane kernel launches per route: {report}")
    return report


def phase_compare_reads(device: str, tmp: str):
    """COMMET's compare_reads at its defaults (-k 33 -t 2) on phase 10's
    sets 1 and 2 with the driver's filter .bv's and set names: pass 1 must
    run on the planes, passes 2 and 3 on sorted indexes, and the two result
    vectors must equal the driver's. Returns per-pass (wall, host pack,
    peak bytes, route) and the result files."""
    import torch
    from commet_tpu_torch.cli import compare_reads
    from commet_tpu_torch.core import planes, stream
    from commet_tpu_torch.device import synchronize
    from commet_tpu_torch.engine.engine import Engine
    drv = os.path.join(tmp, "commet_out") + "/"
    fofs = []
    for i in (1, 2):
        fofs.append(os.path.join(tmp, f"cr_set{i}.txt"))
        with open(fofs[-1], "w") as f:
            f.write(f"set{i}: {os.path.join(tmp, f'set{i}.fa')},"
                    f"{drv}set{i}.fa.bv\n")
    real = Engine.index_and_search
    passes = []

    def timed(self, index_set, query_sets, **kw):
        builds, joins = (planes.build_planes.launches,
                         stream.join_membership.launches)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = real(self, index_set, query_sets, **kw)
        synchronize(self.device)
        wall = time.perf_counter() - t0
        routes = (planes.build_planes.launches - builds,
                  stream.join_membership.launches - joins)
        passes.append((f"{query_sets[0].name} in {index_set.name}", wall,
                        self.last_io_stats.get("host_pack_s", 0.0),
                        torch.cuda.max_memory_allocated(), routes))
        return out

    out = os.path.join(tmp, "compare_reads") + "/"
    Engine.index_and_search = timed
    try:
        rc = compare_reads.main(["-i", fofs[0], "-s", fofs[1], "-k",
                                 str(PLANE_K), "-t", str(T), "-o", out,
                                 "-l", out, "--device", device])
    finally:
        Engine.index_and_search = real
    if rc != 0:
        raise AssertionError(f"compare_reads exited {rc}")
    routes = [launched for *_x, launched in passes]
    if len(routes) != 3 or routes[0][0] == 0 or routes[0][1] != 0 or any(
            b != 0 or j == 0 for b, j in routes[1:]):
        raise AssertionError("pass 1 must build planes and passes 2 and 3 "
                             f"join sorted indexes: {passes}")
    names = ["set1.fa_in_set2.bv", "set2.fa_in_set1.bv"]
    for name in names:
        with open(out + name, "rb") as f1, open(drv + name, "rb") as f2:
            if f1.read() != f2.read():
                raise AssertionError(f"compare_reads {name} != the driver's")
    return passes, names


def _same_files(dir_a: str, dir_b: str, names) -> None:
    for name in names:
        with open(dir_a + name, "rb") as f1, open(dir_b + name, "rb") as f2:
            if f1.read() != f2.read():
                raise AssertionError(f"{name}: {dir_a} != {dir_b}")


def _log_mtimes(out: str) -> dict:
    return {os.path.basename(p): os.stat(p).st_mtime_ns
            for p in glob.glob(out + "*.log")}


def phase_jobs(device: str, tmp: str, fof: str, classic: str, files):
    """The job DAG on phase 7's sets: --jobs 2 writes the classic run's
    files and a marker a job; so does --jobs 4 in a directory of its own,
    both timed beside a classic run made just before them; a --sge re-run
    skips every job; with one pair's markers deleted a third run recomputes
    exactly that pair. Returns the walls (classic, --jobs 2, --jobs 4,
    --sge, resume), the markers and the join launches of the --jobs 2
    run."""
    from commet_tpu_torch.cli import commet
    from commet_tpu_torch.core import planes, stream
    out = os.path.join(tmp, "jobs") + "/"
    walls = []

    def run(*flags, out=out):
        tee = _Tee(io.StringIO())
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(tee):
            rc = commet.main([fof, "-k", str(K), "-t", str(T), "--no-plots",
                              "-o", out, "--device", device, *flags])
        walls.append(time.perf_counter() - t0)
        if rc != 0:
            raise AssertionError(f"commet {flags} exited {rc}")
        return tee.kept.getvalue()

    os.environ["COMMET_TPU_MULTI"] = "0"
    try:
        run(out=os.path.join(tmp, "classic_again") + "/")
    finally:
        del os.environ["COMMET_TPU_MULTI"]
    _same_files(classic, os.path.join(tmp, "classic_again") + "/", files)
    zero_counts(stream, planes)
    run("--jobs", "2")
    joins = stream.join_membership.launches
    if joins == 0:
        raise AssertionError("commet --jobs 2 launched no join")
    _same_files(classic, out, files)
    run("--jobs", "4", out=os.path.join(tmp, "jobs4") + "/")
    _same_files(classic, os.path.join(tmp, "jobs4") + "/", files)
    markers = sorted(os.path.basename(p) for p in glob.glob(out + ".job_*"))
    if len(markers) != 3 + 2 * 6:
        raise AssertionError(f"--jobs 2 wrote markers {markers}")
    logs = _log_mtimes(out)
    if "SGE mode requested: running as an in-process job DAG" not in run(
            "--sge") or _log_mtimes(out) != logs:
        raise AssertionError("--sge re-run: no SGE line, or logs rewritten")
    _same_files(classic, out, files)
    for name in ("0_in_2", "2_in_0"):
        os.remove(out + f".job_{name}.done")
    run("--jobs", "2")
    after = _log_mtimes(out)
    changed = {f for f in logs if after[f] != logs[f]}
    if changed != {"set1_in_set3.log", "set3_in_set1.log"}:
        raise AssertionError(f"resume recomputed {changed}")
    _same_files(classic, out, files)
    return walls, len(markers), joins


def phase_tools(device: str, tmp: str, fof: str, classic: str):
    """The standalone tools on phase 7's sets and its classic run's output:
    index_and_search -f = compare_reads; commet_analysis rewrites the
    classic CSVs; bvop = numpy's bit algebra; extract_reads writes the
    records of the set bits; generate_random_bv keeps about a quarter.
    Returns the walls of each."""
    import random
    from commet_tpu_torch.cli import (bvop, commet_analysis, compare_reads,
                                      extract_reads, generate_random_bv,
                                      index_and_search)
    from commet_tpu_torch.io.bv import BitVector
    walls = {}
    set_files = []
    for i in (1, 2):
        set_files.append(os.path.join(tmp, f"tools_set{i}.txt"))
        with open(set_files[-1], "w") as f:
            f.write(f"set{i}: {os.path.join(tmp, f'set{i}.fa')}\n")
    outs = {}
    for name, cli, extra in (("index_and_search -f", index_and_search,
                              ["-f"]),
                             ("compare_reads", compare_reads, [])):
        out = os.path.join(tmp, name.split()[0]) + "/"
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main(["-i", set_files[0], "-s", set_files[1], "-k",
                           str(K), "-t", str(T), "-o", out, "-l", out,
                           "--device", device] + extra)
        walls[name] = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"{name} exited {rc}")
        outs[name] = out
    pair = ["set1.fa_in_set2.bv", "set2.fa_in_set1.bv"]
    _same_files(outs["compare_reads"], outs["index_and_search -f"], pair)
    for log in ("set1_in_set2.log", "set2_in_set1.log"):
        lines = []
        for o in outs.values():
            with open(o + log) as f:
                lines.append(f.read().splitlines()[-1])
        if lines[0] != lines[1]:
            raise AssertionError(f"{log}: counters {lines}")

    csvs = [f"matrix_{kind}.csv" for kind in
            ("plain", "percentage", "normalized")]
    before = {}
    for name in csvs:
        with open(classic + name, "rb") as f:
            before[name] = f.read()
        os.remove(classic + name)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = commet_analysis.main([fof, "-o", classic, "--no-plots"])
    walls["commet_analysis"] = time.perf_counter() - t0
    for name in csvs:
        if rc != 0 or not os.path.exists(classic + name):
            raise AssertionError(f"commet_analysis exited {rc}")
        with open(classic + name, "rb") as f:
            if f.read() != before[name]:
                raise AssertionError(f"commet_analysis {name} differs")

    a_path, b_path = (classic + "set1.fa_in_set2.bv",
                      classic + "set1.fa_in_set3.bv")
    a, b = BitVector.read(a_path), BitVector.read(b_path)
    t0 = time.perf_counter()
    for flag, want in (("-a", a.data & b.data), ("-o", a.data | b.data),
                       ("-d", a.data & ~b.data), ("-n", ~a.data)):
        res = os.path.join(tmp, f"bvop{flag}.bv")
        argv = [a_path, flag] + ([] if flag == "-n" else [b_path])
        said = io.StringIO()
        with contextlib.redirect_stdout(said):
            rc = bvop.main(argv + ["-i", "-p", res])
        got = BitVector.read(res)
        if rc != 0 or got.data.tobytes() != want.tobytes():
            raise AssertionError(f"bvop {flag} differs from numpy")
        info = f"{a.comment}\nReads:\n  {got.nb_one()} / {a.size} reads " \
               "selected\n"
        if said.getvalue() != info or got.nb_one() != min(
                int(np.unpackbits(want).sum()), a.size):
            raise AssertionError(f"bvop {flag} -i: {said.getvalue()!r}")
    walls["bvop"] = time.perf_counter() - t0

    src, sel = os.path.join(tmp, "set4.fa"), classic + "set4.fa_in_set2.bv"
    out = os.path.join(tmp, "extracted.fa")
    t0 = time.perf_counter()
    if extract_reads.main([src, sel, "-o", out]) != 0:
        raise AssertionError("extract_reads failed")
    walls["extract_reads"] = time.perf_counter() - t0
    keep = np.nonzero(BitVector.read(sel).as_bool_array())[0]
    with open(src, "rb") as f:
        lines = f.read().split(b"\n")
    want = b"".join(lines[2 * i] + b"\n" + lines[2 * i + 1] + b"\n"
                    for i in keep)
    with open(out, "rb") as f:
        if f.read() != want or not len(keep):
            raise AssertionError("extract_reads records differ")

    random.seed(11)
    res = os.path.join(tmp, "random.bv")
    t0 = time.perf_counter()
    if generate_random_bv.main([os.path.join(tmp, "set1.fa"), "25",
                                res]) != 0:
        raise AssertionError("generate_random_bv failed")
    walls["generate_random_bv"] = time.perf_counter() - t0
    bv = BitVector.read(res)
    share = bv.nb_one() / bv.size
    if bv.size != SCHED_READS or not 0.2 < share < 0.3:
        raise AssertionError(f"generate_random_bv kept {share}")
    return walls, len(keep), share


def smoke_mesh(device, n: int):
    """A mesh of ``n`` entries: n distinct cards where the machine has them,
    else ``device`` repeated (its shares then run one after another)."""
    import torch
    from commet_tpu_torch.parallel import sharded
    if torch.cuda.device_count() >= n:
        return sharded.make_mesh([f"cuda:{i}" for i in range(n)])
    return sharded.Mesh([device] * n)


def _dirty_batch(device, seed: int, lpad: int):
    """PLANE_BATCH reads of 50-100 random bases, 1% of the bases N: code
    words, validity words and lengths, as numpy arrays and on the card."""
    import torch
    from commet_tpu_torch.core import keys
    rng = np.random.default_rng(seed)
    n = PLANE_BATCH
    codes = rng.integers(0, 4, (n, lpad), dtype=np.uint8)
    lens = rng.integers(READ_LEN // 2, READ_LEN + 1, n).astype(np.int32)
    valid = (np.arange(lpad) < lens[:, None]) & (rng.random((n, lpad)) > 0.01)
    c2 = _pack_codes(codes)
    vd = np.bitwise_or.reduce(valid.reshape(n, lpad // 32, 32).astype(
        np.uint32) << np.arange(32, dtype=np.uint32), axis=2)
    on_card = (keys.host_u32(c2).to(device), keys.host_u32(vd).to(device),
               torch.from_numpy(lens).to(device))
    host_counts = np.stack([((codes == c) & valid).sum(axis=1)
                            for c in range(4)], axis=1)
    host_counts = np.concatenate(
        [host_counts, (lens - host_counts.sum(axis=1))[:, None]], axis=1)
    return (c2, vd, lens), on_card, host_counts.astype(np.int64)


def phase_mesh_kernels(device, gen_seed: int):
    """Phase 13.1: the multi-device kernels against their plain versions.
    The ranged build at k = 33 into 4 word ranges (1 GiB shards) of phase
    9's first 65,536-read batch, each range equal to its plain version's and
    to its words of commet_build_planes' planes; timed on fresh batches;
    then every range and the whole set filled from phase 9's 4M reads. The
    ranged probe of phase 9's probe batch against each range, masks equal to
    the plain version's, the sharded tags equal to probe_planes'. The class
    counts of a dirty 65,536-read batch equal to the plain version's and to
    numpy's; then filter_batch_device on it (the path the launch count
    reads) equal to the host filter. Each kernel's ms by CUDA events per
    launch, beside its bound (the bytes it must move at the HBM rate) and
    its plain version's ms."""
    import torch
    from commet_tpu_torch.core import filter as tfilter
    from commet_tpu_torch.core import keys, planes
    from commet_tpu_torch.parallel import sharded
    k, n, lpad = PLANE_K, PLANE_BATCH, 128
    wmax = READ_LEN - k + 1
    words, _gen = _plane_reads(device, gen_seed, lpad)
    lengths = torch.full((n,), READ_LEN, dtype=torch.int32, device=device)
    batches = [words[i:i + n] for i in range(0, PLANE_FILL_READS, n)]
    ps = sharded.alloc_planes_sharded(k, sharded.Mesh([device] * MESH_N))
    wl, w = ps.wl, planes.plane_words(k)
    whole = planes.alloc_planes(k, device)

    def build(c2):
        planes.build_planes(whole, c2, lengths[:len(c2)], True, lpad, k)

    def ranged(d, c2):
        planes.build_planes_range(ps.shards[d], c2, lengths[:len(c2)], True,
                                  lpad, k, d * wl, wl)

    def ranged_plain(d, c2, shard):
        planes.build_planes_plain(shard, c2, lengths[:len(c2)], True, lpad,
                                  k, d * wl, wl)

    def same_as_whole(d):
        return torch.equal(ps.shards[d].view(4, wl),
                           whole.view(4, w)[:, d * wl:(d + 1) * wl])

    build(batches[0])
    plain = torch.zeros_like(ps.shards[0])
    for d in range(MESH_N):
        ranged(d, batches[0])
        plain.zero_()
        ranged_plain(d, batches[0], plain)
        torch.cuda.synchronize()
        if not torch.equal(ps.shards[d], plain):
            raise AssertionError(f"ranged build differs from its plain "
                                 f"version in range {d}")
        if not same_as_whole(d):
            raise AssertionError(f"range {d} differs from its words of "
                                 "commet_build_planes' planes")
    reps = 4  # fresh batches: each call sets new bits, as a build does
    timed = batches[1:1 + reps]
    launches = reps * MESH_N
    build_ms = _events_ms([lambda b=b, d=d: ranged(d, b) for b in timed
                           for d in range(MESH_N)]) / launches
    build_plain_ms = _events_ms([lambda b=b, d=d: ranged_plain(d, b, plain)
                                 for b in timed
                                 for d in range(MESH_N)]) / launches
    del plain
    # per batch: the 4 ranges each read the batch once, and together touch
    # each distinct plane sector of the batch's atomics once (read and
    # written); a range boundary is a multiple of 8 words, so no sector
    # straddles two
    batch_bytes = n * (lpad // 16) * 4 + n * 4
    build_sectors = sum(_sectors(_build_addrs(b, lengths[:len(b)], lpad, k))
                        for b in timed) // reps
    build_bound = bound_ms((MESH_N * batch_bytes + 2 * SECTOR * build_sectors)
                           / MESH_N)
    t0 = time.perf_counter()
    for i, b in enumerate(batches[1:]):
        build(b)
        if i >= reps:
            for d in range(MESH_N):
                ranged(d, b)
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    if not all(same_as_whole(d) for d in range(MESH_N)):
        raise AssertionError("the filled ranges differ from the whole set")

    qc2 = _probe_batch(words, device, gen_seed, lpad)
    del words, batches

    def part(d):
        return planes.probe_planes_part(ps.shards[d], qc2, lengths, True,
                                        lpad, k, d * wl, wl, wmax)

    def part_plain(d):
        return planes.probe_planes_part_plain(ps.shards[d], qc2, lengths,
                                              True, lpad, k, d * wl, wl,
                                              wmax)

    merged = None
    for d in range(MESH_N):
        got, want = part(d), part_plain(d)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"ranged probe differs from its plain "
                                 f"version in range {d} on "
                                 f"{int((got != want).sum())} masks")
        merged = got if merged is None else merged | got
    tags = sharded.probe_planes_sharded(ps, qc2, lengths, True, lpad, T, wmax)
    single = planes.probe_planes(whole, qc2, lengths, True, lpad, k, T, wmax)
    if not torch.equal(tags, single) or not bool(tags[:n // 3].all()):
        raise AssertionError("sharded tags differ from probe_planes' or miss "
                             "a read holding an indexed fragment")
    members = int((merged == 15).sum())
    part_ms = cuda_ms(lambda: [part(d) for d in range(MESH_N)], 10) / MESH_N
    part_plain_ms = cuda_ms(lambda: [part_plain(d) for d in range(MESH_N)],
                            2) / MESH_N
    # per range: the batch read and the [n, 2, wmax] masks written once;
    # together the ranges load each distinct sector of every complete
    # window's four plane words, both strands, once
    wk = keys.window_keys(keys.unpack_codes_clean(qc2, lengths, lpad), k,
                          "both", wmax)
    ok = wk["ok"]
    addrs = torch.cat([p * w + (key[ok] >> 5) for s in ("f", "r")
                       for p, key in enumerate(planes.four_plane_keys(
                           wk[s + "a"], wk[s + "b"]))])
    part_loads, part_sectors = addrs.numel(), _sectors(addrs)
    del wk, ok, addrs, ps, whole
    part_bound = bound_ms((MESH_N * (qc2.numel() * 4 + n * 4
                                     + n * 2 * wmax)
                           + SECTOR * part_sectors) / MESH_N)

    host, (c2, vd, lens), want_counts = _dirty_batch(device, gen_seed + 2,
                                                     lpad)
    got = tfilter.class_counts_packed(c2, vd, lens, lpad)
    want = tfilter.class_counts_packed_plain(c2, vd, lens, lpad)
    torch.cuda.synchronize()
    cc_err = int((got - want).abs().max())
    if not torch.equal(got, want) or not np.array_equal(
            got.cpu().numpy(), want_counts):
        raise AssertionError("class counts kernel differs from its plain "
                             "version or from numpy")
    cc_ms = cuda_ms(lambda: tfilter.class_counts_packed(c2, vd, lens, lpad),
                    20)
    cc_plain_ms = cuda_ms(lambda: tfilter.class_counts_packed_plain(
        c2, vd, lens, lpad), 5)
    cc_bound = bound_ms(c2.numel() * 4 + vd.numel() * 4 + n * 4 + n * 5 * 4)
    tfilter.class_counts_packed.launches = 0
    kw = {"min_size": 60, "max_n": 0, "min_shannon": 1.9}
    keep, stats = tfilter.filter_batch_device(*host, lpad, device=device, **kw)
    cc_launches = tfilter.class_counts_packed.launches
    keep_h, stats_h = tfilter.filter_reads_counts(
        want_counts, host[2].astype(np.int64), **kw)
    if cc_launches == 0 or stats != stats_h or not np.array_equal(keep,
                                                                  keep_h):
        raise AssertionError(f"filter_batch_device {stats} (launches "
                             f"{cc_launches}) != the host filter {stats_h}")
    return {
        "build_range": {"max_abs_err": 0, "ms": build_ms,
                        "plain_ms": build_plain_ms, "bound_ms": build_bound},
        "probe_part": {"max_abs_err": 0, "ms": part_ms,
                       "plain_ms": part_plain_ms, "bound_ms": part_bound},
        "class_counts": {"max_abs_err": cc_err, "ms": cc_ms,
                         "plain_ms": cc_plain_ms, "bound_ms": cc_bound},
        "build_sectors": build_sectors, "fill_s": fill_s,
        "part_loads": part_loads, "part_sectors": part_sectors,
        "members": members, "tagged": int(tags.sum()),
        "filter_stats": stats, "class_counts_launches": cc_launches}


def _pair_sets(tmp: str, names):
    """Read sets of <tmp>/<name>.fa, every read eligible."""
    from commet_tpu_torch.io.reads import ReadSet
    out = []
    for name in names:
        rs = ReadSet(name)
        rs.add_file(os.path.join(tmp, name + ".fa"))
        out.append(rs)
    return out


def _engine_pair(device, tmp: str, k: int, name: str, **engine_kw):
    """set2 against set1 of ``tmp`` through an Engine: (wall, .bv bytes,
    counter line, max_memory_allocated, launches by kernel)."""
    import torch
    from commet_tpu_torch.core import filter as tfilter
    from commet_tpu_torch.core import planes, stream
    from commet_tpu_torch.device import synchronize
    from commet_tpu_torch.engine.engine import Engine
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(stream, planes)
    out = os.path.join(tmp, "mesh13_" + name) + "/"
    os.makedirs(out, exist_ok=True)
    index_set, query = _pair_sets(tmp, ("set1", "set2"))
    eng = Engine(k=k, t=T, device=device, **engine_kw)
    t0 = time.perf_counter()
    eng.index_and_search(index_set, [query], out_dir=out, log_dir=out)
    synchronize(eng.device)
    wall = time.perf_counter() - t0
    launched = {fn.__name__: fn.launches for fn in _kernel_fns(
        stream, planes, tfilter) if fn.launches}
    with open(out + "set2.fa_in_set1.bv", "rb") as f:
        payload = f.read()
    return (wall, payload, last_line(out + "set2_in_set1.log"),
            torch.cuda.max_memory_allocated(), launched)


def last_line(path: str) -> str:
    with open(path) as f:
        return f.read().splitlines()[-1]


def phase_mesh_pair(device, tmp: str, k: int, runs):
    """Phases 13.2 and 13.3: set2 against set1 of ``tmp`` on one device and
    through each of ``runs`` ((name, engine keywords)); every run's .bv bytes
    and counter line must equal the single-device call's. Returns {name:
    (wall, counter line, peak bytes, launches)}."""
    report = {}
    wall, payload, counters, peak, launched = _engine_pair(device, tmp, k,
                                                           "single")
    report["single"] = (wall, counters, peak, launched)
    for name, kw in runs:
        got = _engine_pair(device, tmp, k, name, **kw)
        if got[1] != payload or got[2] != counters:
            raise AssertionError(f"{name}: set2.fa_in_set1.bv or counters "
                                 f"{got[2]} differ from the single-device "
                                 f"call's {counters}")
        report[name] = (got[0], got[2], got[3], got[4])
    return report


def phase_mesh_key_range(device, tmp: str, mesh):
    """Phase 13.6: phase 6's set 1 as one sorted index (69M pairs, phase 3's
    density) cut into len(mesh) key-range slices; the first 65,536 reads of
    set 2 through sharded_stream_step (each slice joins the full sorted
    query stream, verdicts max-merged) and sharded_exact_step for the AMBIG
    residue give the tags of the single join path after its exact fallback;
    no decided verdict contradicts them. Returns the walls, the AMBIG
    counts, the tags and the slices' sizes."""
    import torch
    from commet_tpu_torch.core import keys, stream
    from commet_tpu_torch.engine.engine import EncodedSet, Engine
    from commet_tpu_torch.parallel import sharded
    eng = Engine(k=K, t=T, device=device)
    index_set, query = _pair_sets(tmp, ("set1", "set2"))
    enc = EncodedSet(index_set)
    elig = index_set.eligible()
    sidx = eng.build_index(enc, elig, int(eng.count_kmers(enc, elig).sum()))
    rows = query.eligible()[:PLANE_BATCH]
    lpad = 128
    wmax = READ_LEN - K + 1
    c2, vd, _ln, _clean = EncodedSet(query).gather_packed(rows, lpad)
    c2, vd = keys.host_u32(c2).to(device), keys.host_u32(vd).to(device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    v1 = stream.probe_stream_packed(sidx, c2, vd, lpad, K, T, wmax)
    want = v1 == stream.VERDICT_TAGGED
    amb1 = v1 == stream.VERDICT_AMBIG
    want[amb1] = stream.probe_exact_sets(sidx, c2[amb1], vd[amb1], lpad, K,
                                         T, wmax)
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t0
    shards = sharded.shard_stream_index(sidx, len(mesh), mesh)
    if sum(shards["mi_loc"]) != sidx.mi or sum(shards["set_mi"]) != sidx.mi:
        raise AssertionError("the slices do not hold the index")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    v = sharded.sharded_stream_step(mesh, shards, c2, vd, False, lpad, K, T,
                                    wmax)
    dec = v != stream.VERDICT_AMBIG
    tags = v == stream.VERDICT_TAGGED
    if not torch.equal(tags[dec], want[dec]):
        raise AssertionError("a decided sharded verdict contradicts the "
                             "single path's tags")
    amb = ~dec
    tags[amb] = sharded.sharded_exact_step(mesh, shards, c2[amb], vd[amb],
                                           lpad, K, T, wmax)
    torch.cuda.synchronize()
    sharded_s = time.perf_counter() - t0
    if not torch.equal(tags, want):
        raise AssertionError("key-range-sharded tags differ from the single "
                             "join path's")
    return {"single_s": single_s, "sharded_s": sharded_s,
            "ambig": (int(amb1.sum()), int(amb.sum())),
            "tagged": int(tags.sum()), "mi": sidx.mi,
            "mi_loc": shards["mi_loc"]}


def phase_mesh_driver(device, tmp: str, fof: str, classic: str, files):
    """Phase 13.4: the commet driver with a 2-entry mesh engine on phase
    7's sets (the --devices 2 engine: on a machine with one card that card
    twice) takes the classic rounds and writes the classic run's files; with
    two or more cards `commet --devices 2` as well. Returns the walls and
    the join launches of the first run."""
    import torch
    from commet_tpu_torch.cli import commet
    from commet_tpu_torch.core import planes, stream
    mesh = smoke_mesh(device, 2)
    runs = [("mesh2", [])]
    if torch.cuda.device_count() >= 2:
        runs.append(("devices2", ["--devices", "2"]))
    walls, joins = {}, None
    real = commet.auto_mesh
    for name, flags in runs:
        out = os.path.join(tmp, name) + "/"
        zero_counts(stream, planes)
        tee = _Tee(io.StringIO())
        if not flags:
            commet.auto_mesh = lambda _device: mesh
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(tee):
                rc = commet.main([fof, "-k", str(K), "-t", str(T),
                                  "--no-plots", "-o", out, "--device",
                                  str(device), *flags])
        finally:
            commet.auto_mesh = real
            os.environ.pop("COMMET_TPU_DEVICES", None)
        walls[name] = time.perf_counter() - t0
        joins = stream.join_membership.launches if joins is None else joins
        if rc != 0 or "schedule: classic rounds (a mesh of 2 devices" \
                not in tee.kept.getvalue():
            raise AssertionError(f"commet {name}: rc {rc}, not the classic "
                                 "rounds of a 2-device mesh")
        _same_files(classic, out, files)
    return walls, joins


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def phase_two_ranks(tmp: str, fof: str, classic: str, files, *flags):
    """Phase 13.5: two `commet` processes on the card joined through
    COMMET_TPU_COORDINATOR on a free localhost port (rank 0 filters, both
    meet at the barrier, rank r runs rounds r, r + 2), then commet_analysis:
    the classic run's .bv and CSV files. Returns the ranks' wall and the
    analysis wall."""
    from commet_tpu_torch.cli import commet_analysis
    out = os.path.join(tmp, "ranks") + "/"
    port = _free_port()
    procs = []
    t0 = time.perf_counter()
    try:
        for rank in range(2):
            env = dict(os.environ, COMMET_TPU_COORDINATOR=f"localhost:{port}",
                       COMMET_TPU_NUM_PROCESSES="2",
                       COMMET_TPU_PROCESS_ID=str(rank))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "commet_tpu_torch.cli.commet", fof,
                 "-k", str(K), "-t", str(T), "--no-plots", "-o", out,
                 *flags],
                cwd=HERE, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        said = [p.communicate(timeout=RANK_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    ranks_s = time.perf_counter() - t0
    for rank, (p, text) in enumerate(zip(procs, said)):
        if p.returncode != 0 or (f"multi-host run: rank {rank}/2 finished "
                                 "its rounds") not in text:
            raise AssertionError(f"rank {rank} exited {p.returncode}:\n"
                                 f"{text[-3000:]}")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = commet_analysis.main([fof, "-o", out, "--no-plots"])
    if rc != 0:
        raise AssertionError(f"commet_analysis exited {rc}")
    analysis_s = time.perf_counter() - t0
    _same_files(classic, out, files)
    return ranks_s, analysis_s


def _kernel_fns(stream, planes, tfilter):
    """Every kernel wrapper, in the kernels line's order."""
    return (stream.join_membership, stream.join_membership_multi,
            planes.build_planes, planes.probe_planes,
            planes.probe_planes_multi, planes.build_planes_range,
            planes.probe_planes_part, tfilter.class_counts_packed)


def zero_counts(stream, planes):
    """Every kernel wrapper's launch count set to 0."""
    from commet_tpu_torch.core import filter as tfilter
    for fn in _kernel_fns(stream, planes, tfilter):
        fn.launches = 0


def _plane_launches(planes):
    return (planes.build_planes.launches, planes.probe_planes.launches,
            planes.probe_planes_multi.launches)


def run_phase_plane_kernels(device) -> dict:
    """Phase 9's timed part: runs phase_plane_kernels and logs its line."""
    from commet_tpu_torch.core import planes
    t0 = time.perf_counter()
    pk = phase_plane_kernels(device, 33)
    share = {key: f"bound {pk[key]['bound_ms']:.4f} ms, "
                  f"{100 * pk[key]['bound_ms'] / pk[key]['ms']:.1f}% of bound"
             for key in ("build", "probe", "multi")}
    yard = ", ".join(f"{name} {ms:.4f}" for name, ms in
                     pk["yardsticks"].items())
    log(f"phase plane kernels: k = {PLANE_K}, {planes.plane_bytes(PLANE_K)} "
        f"B per plane set; build of one {PLANE_BATCH}-read batch equal word "
        f"for word to the plain version's, kernel {pk['build']['ms']:.4f} "
        f"ms, plain {pk['build']['plain_ms']:.4f} ms per batch, "
        f"{pk['build_windows']} windows, {4 * pk['build_windows']} atomics "
        f"on {pk['build_sectors']} distinct sectors ({share['build']}); "
        f"{PLANE_FILL_READS} reads built in {pk['fill_s']:.3f} s, plane A "
        f"fill {pk['fill']:.5f}; probe of {PLANE_BATCH} reads (a third with "
        f"a {2 * PLANE_K} bp indexed fragment, all tagged; "
        f"{pk['tagged_random']} others tagged) equal to the plain version's, "
        f"kernel {pk['probe']['ms']:.4f} ms, plain "
        f"{pk['probe']['plain_ms']:.4f} ms, {pk['probe_loads']} plane loads "
        f"on {pk['probe_sectors']} distinct sectors ({share['probe']}); "
        f"probe_multi at S = 3 (tags per slot {pk['tagged']}) equal to its "
        f"plain version's and to three single probes, kernel "
        f"{pk['multi']['ms']:.4f} ms, plain {pk['multi']['plain_ms']:.4f} "
        f"ms, 3 single launches {pk['singles_ms']:.4f} ms, "
        f"{pk['multi_loads']} plane loads on {pk['multi_sectors']} distinct "
        f"sectors ({share['multi']}); PyTorch at the same addresses (ms): "
        f"{yard} ({time.perf_counter() - t0:.3f} s)")
    return pk


def _kernel_figures(fig: dict) -> str:
    return (f"kernel {fig['ms']:.4f} ms, plain {fig['plain_ms']:.4f} ms, "
            f"bound {fig['bound_ms']:.4f} ms "
            f"({100 * fig['bound_ms'] / fig['ms']:.1f}% of bound)")


def _mesh_walls(pair: dict) -> str:
    """Each run's wall, peak bytes and kernel launches (phase_mesh_pair)."""
    return "; ".join(f"{name} {wall:.3f} s, max_memory_allocated {peak} B, "
                     f"launches {launched}"
                     for name, (wall, _c, peak, launched) in pair.items())


def _pct(share) -> str:
    return "not tiled" if share is None else f"{100 * share:.2f}%"


def run_phase_kernel(device, rng) -> dict:
    """Phase 3: runs phase_kernel and logs its line."""
    t0 = time.perf_counter()
    kern = phase_kernel(device, rng, INDEX_PAIRS, QUERY_PAIRS)
    yard, big = kern["yardsticks"], kern["larger_index"]
    log(f"phase kernel: join on {kern['mi']} index pairs x {QUERY_PAIRS} "
        f"sorted queries, verdicts identical (NONMEM/CAND/CONF "
        f"{kern['counts'][:3]}); kernel {kern['ms']:.4f} ms, plain "
        f"{kern['plain_ms']:.4f} ms, bound {kern['bound_ms']:.4f} ms "
        f"({100 * kern['bound_ms'] / kern['ms']:.1f}% of bound), "
        f"launch (tile, capacity) {kern['geometry']}, "
        f"{_pct(kern['staged_share'])} of tiles staged; kernel on unsorted "
        f"queries {kern['unsorted_ms']:.4f} ms "
        f"({_pct(kern['staged_share_unsorted'])} staged), query sort+unsort "
        f"{kern['sort_unsort_ms']:.4f} ms; on {big['mi']} index pairs "
        f"kernel {big['ms']:.4f} ms, bound {big['bound_ms']:.4f} ms, "
        f"launch {big['geometry']}, {_pct(big['staged_share'])} staged; "
        f"PyTorch on the same inputs "
        f"(ms): searchsorted of the keya column {yard['searchsorted_ms']:.4f}"
        f", gather at the bound's positions {yard['gather_ms']:.4f}, copy of "
        f"the keya column {yard['copy_ms']:.4f} ({yard['copy_gb_s']:.1f} "
        f"GB/s read + written); {kern['launches']} launches "
        f"({time.perf_counter() - t0:.3f} s)")
    return kern


def run_phase_multi_kernel(device, rng, kern, probe_batch: bool = True):
    """Phase 5: runs phase_multi_kernel, logs its line and frees phase 3's
    tensors."""
    t0 = time.perf_counter()
    multi = phase_multi_kernel(device, rng, kern, probe_batch)
    del kern["sidx"], kern["queries"], kern["verdicts"]
    line = (f"phase multi kernel: join_multi on S = 3 x {INDEX_PAIRS} index "
            f"pairs x {QUERY_PAIRS} sorted queries, verdicts identical to "
            f"the plain version's (NONMEM/CAND/CONF per slot "
            f"{multi['counts']}); kernel {multi['ms']:.4f} ms, plain "
            f"{multi['plain_ms']:.4f} ms, bound {multi['bound_ms']:.4f} ms "
            f"({100 * multi['bound_ms'] / multi['ms']:.1f}% of bound), 3 "
            f"single launches {multi['singles_ms']:.4f} ms, tiles staged per "
            f"slot {[_pct(x) for x in multi['staged_share']]}")
    if probe_batch:
        st = multi["stages"]
        line += (f"; one probe batch of {multi['n_keys']} keys: keygen "
                 f"{st['keygen']:.4f} ms, sort {st['sort']:.4f} ms, join "
                 f"{st['join']:.4f} ms, unsort+verdict "
                 f"{st['unsort_verdict']:.4f} ms, peak "
                 f"{multi['bytes_per_key_s3']:.1f} B per key at S = 3, "
                 f"{multi['bytes_per_key_s1']:.1f} at S = 1")
    log(line + f" ({time.perf_counter() - t0:.3f} s)")
    return multi


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    plane_kernels_only = args == ["--plane-kernels"]
    join_kernels_only = args == ["--join-kernels"]
    if args and not (plane_kernels_only or join_kernels_only):
        print("usage: chip_smoke.py [--plane-kernels | --join-kernels]",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    if not os.path.isdir(os.path.join(HERE, "commet_tpu_torch")):
        print("chip_smoke.py: run it from the repository (commet_tpu_torch "
              "is not beside it)", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA card (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    from commet_tpu_torch.core import _cuda, planes, stream
    from commet_tpu_torch.device import resolve_device

    device = resolve_device("cuda")
    rng = np.random.default_rng(2024)

    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log(smi)
    log(f"phase card: {name}, {torch.cuda.device_count()} device(s), torch "
        f"{torch.__version__}, CUDA {torch.version.cuda} "
        f"({time.perf_counter() - t0:.3f} s)")

    t0 = time.perf_counter()
    libs = _cuda.load_all()
    bound = [fn for name, lib in libs.items()
             for fn in _cuda._SIGNATURES[name] if getattr(lib, fn)]
    log(f"phase build: {', '.join(n + '.cu' for n in libs)} built with nvcc "
        f"in parallel and loaded, {', '.join(bound)} bound "
        f"({time.perf_counter() - t0:.3f} s)")
    if plane_kernels_only:
        pk = run_phase_plane_kernels(device)
        log(json.dumps({key: pk[key] for key in (
            "build", "probe", "multi", "singles_ms", "build_windows",
            "build_sectors", "probe_loads", "probe_sectors", "multi_loads",
            "multi_sectors", "yardsticks", "tagged")}))
        return 0

    kern = run_phase_kernel(device, rng)
    if join_kernels_only:
        multi = run_phase_multi_kernel(device, rng, kern, probe_batch=False)
        log(json.dumps({
            "join": {key: kern[key] for key in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "unsorted_ms",
                "sort_unsort_ms", "mi", "staged_share",
                "staged_share_unsorted", "yardsticks", "larger_index")},
            "join_multi": multi}))
        return 0

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        counters = phase_golden("cuda", tmp)
        log(f"phase golden: qb.fq_in_QA.bv bytes equal, {counters} "
            f"({time.perf_counter() - t0:.3f} s)")

    multi = run_phase_multi_kernel(device, rng, kern)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cases, n_staged, n_global = phase_join_edges(device,
                                                 np.random.default_rng(36))
    log(f"phase join edges: join and join_multi equal to their plain "
        f"versions in {cases} cases (m around the {stream.JOIN_TILE}-query "
        f"tile, index prefixes 0, 1, 2 and odd, columns 8 bytes off a 16-byte "
        f"boundary, equal-keya runs longer and shorter than the "
        f"{stream.JOIN_CAPACITY}-entry capacity across three tiles, queries "
        f"all below, above and equal, unsorted, k = 36's greatest key, "
        f"leading (0, 0) queries, S in 1, 3, 32, 33 with an empty slot); "
        f"launches that stage a full tile, a shortened one and nothing; "
        f"{n_staged} tiles staged in shared memory, {n_global} searched in "
        f"device memory "
        f"({time.perf_counter() - t0:.3f} s)")
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.reset_peak_memory_stats()
        zero_counts(stream, planes)
        t0 = time.perf_counter()
        calls, s_max, plain, peak = phase_main_path(
            "cuda", rng, tmp, SET_READS, K, "amortized", FRAG)
        launches = stream.join_membership.launches
        launches_multi = stream.join_membership_multi.launches
        stream_planes = _plane_launches(planes)
        if launches == 0 or launches_multi == 0:
            raise AssertionError(f"the main path launched join {launches} "
                                 f"and join_multi {launches_multi} times")
        for what, secs in calls:
            log(f"  {what}: {secs:.3f} s")
        log(f"phase main path: commet -k {K} -t {T} on 4 x {SET_READS} "
            f"reads, amortized schedule, S up to {s_max}, matrix_plain rows "
            f"{plain.tolist()}, join launches {launches}, join_multi "
            f"launches {launches_multi}, plane kernel launches "
            f"{stream_planes}, max_memory_allocated {peak} B "
            f"({time.perf_counter() - t0:.3f} s)")
        torch.cuda.empty_cache()
        mesh = smoke_mesh(device, MESH_N)
        t0 = time.perf_counter()
        pair = phase_mesh_pair(device, tmp, K, [("dp", {"mesh": mesh})])
        log(f"phase 13.2 mesh DP stream: set2 in set1 of phase 6 (k = {K}, "
            f"sorted index) on {mesh} equal to the single-device call "
            f"(.bv bytes, {pair['single'][1]}); "
            + _mesh_walls(pair) + f" ({time.perf_counter() - t0:.3f} s)")
        if not pair["dp"][3].get("join_membership"):
            raise AssertionError("the DP stream launched no join")
        t0 = time.perf_counter()
        kr = phase_mesh_key_range(device, tmp, mesh)
        log(f"phase 13.6 key-range-sharded stream: set1 of phase 6 as one "
            f"sorted index of {kr['mi']} pairs in {MESH_N} slices "
            f"{kr['mi_loc']}, set2's first {PLANE_BATCH} reads: tags equal "
            f"to the single join path's after the exact fallback "
            f"({kr['tagged']} tagged; AMBIG single/sharded {kr['ambig']}); "
            f"single path {kr['single_s']:.3f} s, sharded path "
            f"{kr['sharded_s']:.3f} s ({time.perf_counter() - t0:.3f} s)")

    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        n_files, cells, walls, fof, default_out, files = phase_schedules(
            "cuda", rng, tmp, SCHED_READS)
        log(f"phase schedules: 4 x {SCHED_READS} reads, amortized and "
            f"classic identical over {n_files} .bv/.csv files, one_vs_all "
            f"vector_plain {cells}; driver wall amortized "
            f"{walls['amortized']:.3f} s, classic {walls['classic']:.3f} s, "
            f"one_vs_all {walls['one_vs_all']:.3f} s "
            f"({time.perf_counter() - t0:.3f} s)")
        t0 = time.perf_counter()
        routes = phase_routes("cuda", tmp, fof, default_out, files)
        log(f"phase routes: the same sets with COMMET_TPU_STREAM=0 and "
            f"=force write the default run's {len(files)} files; driver wall "
            f"default {walls['amortized']:.3f} s, "
            + ", ".join(f"{name} {wall:.3f} s ({line!r}, build/probe/"
                        f"probe_multi launches {launched})"
                        for name, (wall, line, launched) in routes.items())
            + f" ({time.perf_counter() - t0:.3f} s)")
        t0 = time.perf_counter()
        classic = os.path.join(tmp, "classic") + "/"
        job_walls, n_markers, job_joins = phase_jobs("cuda", tmp, fof,
                                                     classic, files)
        tool_walls, n_extracted, share = phase_tools("cuda", tmp, fof,
                                                     classic)
        log(f"phase jobs and tools: commet --jobs 2 and --jobs 4 wrote the "
            f"classic run's {len(files)} files, --jobs 2 {n_markers} markers "
            f"(join launches {job_joins}); a --sge re-run skipped every job; "
            f"with the markers of pair (set1, set3) deleted a third run "
            f"recomputed exactly its two logs; walls classic "
            f"{job_walls[0]:.3f} s (phase 7 {walls['classic']:.3f} s), "
            f"--jobs 2 {job_walls[1]:.3f} s, --jobs 4 {job_walls[2]:.3f} s, "
            f"--sge {job_walls[3]:.3f} s, resume {job_walls[4]:.3f} s; "
            f"index_and_search -f = compare_reads, "
            f"commet_analysis rewrote the classic CSVs, bvop -a/-o/-d/-n/-i "
            f"= numpy, extract_reads wrote the {n_extracted} records of "
            f"set4.fa_in_set2.bv, generate_random_bv at 25% kept "
            f"{100 * share:.2f}%; walls "
            + ", ".join(f"{n} {w:.3f} s" for n, w in tool_walls.items())
            + f" ({time.perf_counter() - t0:.3f} s)")
        t0 = time.perf_counter()
        drv_walls, drv_joins = phase_mesh_driver(device, tmp, fof, classic,
                                                 files)
        log(f"phase 13.4 mesh driver: commet with a 2-entry mesh engine "
            f"({smoke_mesh(device, 2)}) took the classic rounds and wrote the "
            f"classic run's {len(files)} files (join launches {drv_joins}); "
            f"walls " + ", ".join(f"{n} {w:.3f} s" for n, w in
                                  drv_walls.items())
            + f", classic {job_walls[0]:.3f} s "
            f"({time.perf_counter() - t0:.3f} s)")
        t0 = time.perf_counter()
        ranks_s, analysis_s = phase_two_ranks(tmp, fof, classic, files)
        log(f"phase 13.5 two ranks: two commet processes on the card "
            f"(COMMET_TPU_COORDINATOR, gloo) then commet_analysis wrote the "
            f"classic run's {len(files)} files; ranks {ranks_s:.3f} s "
            f"(process start-up included), commet_analysis "
            f"{analysis_s:.3f} s ({time.perf_counter() - t0:.3f} s)")

    torch.cuda.empty_cache()
    pk = run_phase_plane_kernels(device)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cases = phase_plane_edges(device, np.random.default_rng(9))
    log(f"phase plane edges: build, probe and grouped probe equal to their "
        f"plain versions at k in {EDGE_K}, t in {EDGE_T}, S in {EDGE_S}, "
        f"dirty and clean batches of reads shorter than k, 100 and 300 bp "
        f"({cases} grouped cases) ({time.perf_counter() - t0:.3f} s)")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    mk = phase_mesh_kernels(device, 33)
    log(f"phase 13.1 mesh kernels: k = {PLANE_K}; ranged build of one "
        f"{PLANE_BATCH}-read batch into {MESH_N} word ranges equal to its "
        f"plain version's and to commet_build_planes' planes, "
        + _kernel_figures(mk["build_range"])
        + f" per range launch, {mk['build_sectors']} distinct sectors a "
        f"batch; {PLANE_FILL_READS} reads built into the whole set and the "
        f"ranges in {mk['fill_s']:.3f} s; ranged probe masks of the probe "
        f"batch equal to the plain version's, {mk['members']} member "
        f"windows, sharded tags = probe_planes' ({mk['tagged']} tagged), "
        + _kernel_figures(mk["probe_part"])
        + f" per range launch, {mk['part_loads']} plane loads on "
        f"{mk['part_sectors']} distinct sectors; class counts of a dirty "
        f"{PLANE_BATCH}-read batch equal to the plain version's and "
        f"numpy's, " + _kernel_figures(mk["class_counts"])
        + f"; filter_batch_device = the host filter {mk['filter_stats']} "
        f"(class_counts launches {mk['class_counts_launches']}); "
        f"max_memory_allocated {torch.cuda.max_memory_allocated()} B "
        f"({time.perf_counter() - t0:.3f} s)")
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.reset_peak_memory_stats()
        zero_counts(stream, planes)
        t0 = time.perf_counter()
        calls, s_max, plain, peak = phase_main_path(
            "cuda", rng, tmp, PLANE_SET_READS, PLANE_K, "plane cohorts",
            2 * PLANE_K, n_free_fragments=True)
        plane_counts = _plane_launches(planes)
        if min(plane_counts) == 0:
            raise AssertionError(f"the planes main path launched build/"
                                 f"probe/probe_multi {plane_counts} times")
        for what, secs in calls:
            log(f"  {what}: {secs:.3f} s")
        log(f"phase planes main path: commet -k {PLANE_K} -t {T} on 4 x "
            f"{PLANE_SET_READS} reads, plane cohorts, S up to {s_max}, "
            f"matrix_plain rows {plain.tolist()}, build_planes/probe_planes/"
            f"probe_planes_multi launches {plane_counts}, join/join_multi "
            f"launches {stream.join_membership.launches}/"
            f"{stream.join_membership_multi.launches}, max_memory_allocated "
            f"{peak} B ({time.perf_counter() - t0:.3f} s)")
        torch.cuda.empty_cache()
        zero_counts(stream, planes)
        t0 = time.perf_counter()
        passes, same = phase_compare_reads("cuda", tmp)
        cr_counts = (planes.build_planes.launches,
                     planes.probe_planes.launches,
                     stream.join_membership.launches)
        if min(cr_counts) == 0:
            raise AssertionError(f"compare_reads launched build_planes/"
                                 f"probe_planes/join {cr_counts} times")
        for what, wall, pack, peak, (builds, joins) in passes:
            log(f"  compare_reads pass {what}: {wall:.3f} s, host pack "
                f"{pack:.3f} s of the last search, max_memory_allocated "
                f"{peak} B, build_planes/join launches {builds}/{joins}")
        log(f"phase compare_reads: -k {PLANE_K} -t {T} on sets 1 and 2 of 4 "
            f"x {PLANE_SET_READS} reads with the driver's filters, pass 1 on "
            f"the planes, passes 2 and 3 on sorted indexes; "
            f"{' and '.join(same)} equal to the driver's; build_planes/probe_planes/join launches "
            f"{cr_counts} ({time.perf_counter() - t0:.3f} s)")
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        mesh = smoke_mesh(device, MESH_N)
        pair = phase_mesh_pair(device, tmp, PLANE_K, [
            ("dp", {"mesh": mesh, "mesh_mode": "dp"}),
            ("plane", {"mesh": mesh, "mesh_mode": "plane"})])
        mesh_launches = pair["plane"][3]
        if not pair["dp"][3].get("probe_planes") or min(
                mesh_launches.get("build_planes_range", 0),
                mesh_launches.get("probe_planes_part", 0)) == 0:
            raise AssertionError(f"mesh launches {pair}")
        log(f"phase 13.3 mesh planes: set2 in set1 of phase 10 (k = "
            f"{PLANE_K}, {PLANE_SET_READS} reads, planes) with mesh_mode dp "
            f"and plane ({MESH_N} word shards of "
            f"{planes.plane_bytes(PLANE_K) // MESH_N} B) on {mesh} equal to "
            f"the single-device call (.bv bytes, {pair['single'][1]}); "
            + _mesh_walls(pair) + f" ({time.perf_counter() - t0:.3f} s)")

    loaded = [m for m in sys.modules if m == "jax" or m.startswith("jax.")]
    if loaded:
        raise AssertionError(f"the port imported JAX: {loaded[:5]}")
    loaded = [m for m in sys.modules
              if m == "commet_tpu" or m.startswith("commet_tpu.")]
    if loaded:
        raise AssertionError(f"the port imported the JAX package: "
                             f"{loaded[:5]}")
    log(f"total {time.perf_counter() - t_start:.3f} s")
    log(json.dumps({"kernels": [
        {"name": "join", "route": "cuda", "source": JOIN_SOURCE,
         "replaces": JOIN_REPLACES, "launches": launches,
         "max_abs_err": kern["max_abs_err"], "ms": kern["ms"],
         "plain_ms": kern["plain_ms"], "bound_ms": kern["bound_ms"],
         **NO_LIBRARY},
        {"name": "join_multi", "route": "cuda", "source": JOIN_SOURCE,
         "replaces": JOIN_MULTI_REPLACES, "launches": launches_multi,
         "max_abs_err": multi["max_abs_err"], "ms": multi["ms"],
         "plain_ms": multi["plain_ms"], "bound_ms": multi["bound_ms"],
         **NO_LIBRARY}] + [
        {"name": name, "route": "cuda", "source": PLANES_SOURCE,
         "replaces": replaces, "launches": launched, **pk[key],
         **NO_LIBRARY}
        for name, replaces, launched, key in zip(
            ("build_planes", "probe_planes", "probe_planes_multi"),
            (BUILD_REPLACES, PROBE_REPLACES, PROBE_MULTI_REPLACES),
            plane_counts, ("build", "probe", "multi"))] + [
        {"name": name, "route": "cuda", "source": source,
         "replaces": replaces, "launches": launched, **mk[key],
         **NO_LIBRARY}
        for name, source, replaces, launched, key in (
            ("build_planes_range", PLANES_SOURCE, BUILD_RANGE_REPLACES,
             mesh_launches["build_planes_range"], "build_range"),
            ("probe_planes_part", PLANES_SOURCE, PROBE_PART_REPLACES,
             mesh_launches["probe_planes_part"], "probe_part"),
            ("class_counts", FILTER_SOURCE, CLASS_COUNTS_REPLACES,
             mk["class_counts_launches"], "class_counts"))]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
