#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (commet_tpu_torch) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --plane-kernels
    python3 chip_smoke.py --join-kernels
    python3 chip_smoke.py --mesh-kernels
    python3 chip_smoke.py --class-counts
    python3 chip_smoke.py --default-fill
    python3 chip_smoke.py --bulk-build
    python3 chip_smoke.py --pack-kernel

With --plane-kernels it runs phases 1, 2 and 9's timed part only, with
--join-kernels phases 1, 2, 3 and 5's timed part only, with --mesh-kernels
phases 1, 2 and 13.1's plane kernels, with --class-counts phases 1, 2 and
13.1's class counts, with --default-fill phases 1, 2 and 14, with
--bulk-build phases 1, 2 and 14's kernels at 11.6% fill (the atomic fill,
the probes and the bulk build, without the CLI pair), with --pack-kernel
phases 1, 2 and the gather and pack of a 65,536-read batch on the card
(commet_gather_pack against the host's pack and its plain version, its
ms, the host pack's and a pageable upload's rate), and prints their
figures as one JSON line. To time two versions of the kernels in
turns on one card, run it in a checkout of each in one command (order:
other, this, this, other); --join-kernels needs of the package only
join_membership, join_membership_multi, JoinSlots, their plain versions and
finalize_index, and --class-counts only class_counts_packed, its plain
version, filter_batch_device and filter_reads_counts, so this script also
runs on a checkout whose kernels have another design.
Phases, each printing one line with its seconds:
  1. card: the GPU's name and power limit (nvidia-smi) and torch's name;
  2. build: every hand-written kernel from commet_tpu_torch/core/csrc/
     (join.cu: commet_join, commet_join_multi; planes.cu:
     commet_build_planes, commet_probe_planes, commet_probe_planes_multi,
     commet_build_planes_range, commet_probe_planes_part_a,
     commet_probe_planes_part, commet_bulk_hist, commet_bulk_scatter,
     commet_bulk_refine, commet_bulk_apply and, for measurement only,
     commet_bulk_decode and commet_store_runs; filter.cu:
     commet_class_counts; pack.cu: commet_gather_pack), one nvcc per
     source, started together;
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
     shorter than k, 100 and 300 bp reads; and the bulk build's kernels
     (histogram, level-1 scatter, level 2's in-place tile sort, apply)
     against their plain versions on such reads and on a batch skewed into
     plane D's last region (2% A) at the same k, in chunks of three
     2,000-read batches (so a
     BulkChunk flushes many times and its last chunk is smaller) and a
     chunk with no complete window, BulkChunk's planes equal to the
     per-batch build's and bulk_build_planes_plain's;
 10. planes main path: commet -k 33 -t 2 (COMMET's defaults) on four sets of
     4M reads x 100 bp made as in phase 6 with 66 bp fragments, every
     fragment N-free (the 1% N reads are drawn among the reads that hold or
     give none); 272M k-mers per set, 3.2% fill, above the gate, so step 0
     runs the plane cohorts (three 4 GiB residents). The driver must say so,
     probe S = 3 slots for set 4, launch the default build's kernels (the
     bulk build's four) and both probes, and match the known shared
     counts;
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
     13.1 (after phase 9's edges) the ranged plane build
          (commet_build_planes_range) at k = 33 of phase 9's first
          65,536-read batch into 4 word ranges (1 GiB shards), each equal
          to its plain version's and to its words of commet_build_planes'
          planes, timed on fresh batches with its atomics and distinct
          sectors; then all of phase 9's 4M reads. The ranged probe of
          phase 9's probe batch against each range: pass A, then pass
          B/C/D given the merged A words, each equal to its plain version,
          sharded tags equal to probe_planes'; each timed with its plane
          loads and distinct sectors, beside the loads and sectors of the
          one-pass design before it (every in-range word of every window)
          and the bound that design's bytes give; each timed by CUDA
          events per range launch beside its bound and its plain version.
          The class counts of a dirty 65,536-read batch equal to the plain
          version's and numpy's, then filter_batch_device equal to the host
          filter; of 4M dirty reads made on the card equal to the plain
          version's; at both sizes the kernel's own ms from torch.profiler's
          device events beside the wrapper's ms a call (CUDA events), the
          plain version's and the bound. The gather and pack
          (commet_gather_pack) of the main paths' 65,536-read batches of
          100 bp reads from a 1M-read set, rows in order and shuffled,
          equal to the host's pack and to its plain version's on the card,
          its ms timed as the class counts' are, beside the host pack's
          and the bound, and the set's upload from pageable memory;
     13.2 (in phase 6's directory) set 2 against set 1 (1M reads, k = 32,
          sorted index) through Engine on the mesh (DP stream and DP exact)
          and alone: equal .bv bytes and counter line;
     13.3 (in phase 10's directory, after phase 11) set 2 against set 1
          (4M reads, k = 33, planes) with mesh_mode dp (replicated planes,
          split batches) and plane (4 word shards of 1 GiB: the ranged
          build and the probe's two passes), each equal to the
          single-device call;
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
 14. COMMET's default partition (after phase 10's directory is gone): two
     sets of 14.7M reads x 100 bp made as phase 10 makes its sets (set 2's
     even reads hold 66 bp N-free fragments of set 1's reads), about 3.5 GB
     of fasta in a temporary directory deleted after the phase; the port's
     index_and_search CLI (-k 33 -t 2) with set 2 against set 1: 999.6M
     k-mers less the N reads', one partition at 11.6% fill (at least 11%
     required), so the planes; the wall, the pair-search rate, the split
     (parse, index, search, host pack, dispatch wait, the rest), the peak
     and the fill; every fragment read tagged, every chance tag a member
     of set 1's planes built again by commet_build_planes under the plain
     probe and a 65,536-read sample of the untagged reads not, the chance
     tags beside their expectation from the planes. Then set 2's first 2M
     reads against set 1 through Engine with COMMET_TPU_PROFILE (from its
     Chrome trace the card's busy share and top device operations), with
     prefetch and with COMMET_TPU_PREFETCH=0, equal tags. The kernels at
     11.6%: the fill of one default partition (14.7M random reads) timed,
     phase 9's probe batch through probe_planes and the grouped probe at
     S = 3 against their plain versions beside their bounds, plane loads
     split into A and B/C/D; the B/C/D loads a cascade (K7) could skip,
     against its rule. The bulk build (K9) of the same partition: first
     what binds a scatter alone (the level-1 roll storing nothing, ms a
     batch and windows a second; one batch's 17.8M 4-byte stores in runs
     of 1, 4, 8, 32 and 128 words at pseudo-random starts, ms and stores a
     second); in the engine's chunks of 2^27 window slots the whole build
     (host clock and CUDA events) against the fill, equal planes, each
     kernel's ms a launch from CUDA events around its passes beside its
     bound, each kernel against its plain version on the first chunk and
     the plain versions timed, torch.bincount of one batch's (block, coarse
     bin) ids, torch.sort of the first chunk's keys and a stable torch.sort
     of its (tile, slice) keys (the library yardsticks), the build
     again beside the two resident sets with the cohorts' chunk of 2^26,
     equal, with each build's max_memory_allocated; the faster route
     printed beside the engine's card default.
Each main path (phases 6, 10, 11, 14's CLI call and 12's --jobs run, 13.2
to 13.4's runs, 13.1's filter) runs with every kernel's launch count set
to 0 just before it and read just after; the kernels line (fourteen
kernels) takes the plane kernels' and the gather and pack's launches from
phase 10 (the per-batch
build's from 13.3's dp run when the bulk build is the card's default: a
mesh never takes it), the ranged build's and the probe passes' from 13.3's
plane-mode run and the class counts' from 13.1's filter_batch_device, the
class counts' ms from torch.profiler at 65,536 reads and the bulk kernels'
(per launch, CUDA events around their passes) from phase 14 and the gather
and pack's from 13.1's pack, rows in order. At the end no module of
JAX or of the JAX package (commet_tpu) may be loaded.
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
PROBE_PART_A_REPLACES = "commet_tpu/parallel/sharded.py:91"
PROBE_PART_REPLACES = "commet_tpu/parallel/sharded.py:136"
BULK_HIST_REPLACES = "commet_tpu/core/kernels.py:772"
BULK_SCATTER_REPLACES = "commet_tpu/core/kernels.py:813"
BULK_APPLY_REPLACES = "commet_tpu/core/kernels.py:823"
FILTER_SOURCE = "commet_tpu_torch/core/csrc/filter.cu"
CLASS_COUNTS_REPLACES = "commet_tpu/core/kernels.py:831"
PACK_SOURCE = "commet_tpu_torch/core/csrc/pack.cu"
# no TPU kernel: the JAX package gathers and packs each batch on the host
PACK_REPLACES = "commet_tpu/engine/engine.py:170"
# phase 13: mesh entries (word ranges, shares, key-range slices) and the
# two ranks' time limit
MESH_N = 4
RANK_TIMEOUT = 600
# the dense-plane phases: COMMET's default k, 4 GiB plane sets
PLANE_K = 33
PLANE_BATCH = 65536
PLANE_FILL_READS = 4_000_000
PLANE_SET_READS = 4_000_000
# commet_tpu's cascade verifies the V leftmost and V rightmost A hits of a
# strand first, V = 8 at fills of 2-15% (commet_tpu/engine/engine.py:1471-1479)
CASCADE_V = 8
# phase 14: COMMET's default partition, one pair at k = 33: 68 windows a
# 100 bp read, 14.7M x 68 = 999.6M k-mers, one partition under the 1e9 cap
# (11.6% of 2^33); the trace's query set
DEFAULT_FILL_READS = 14_700_000
TRACE_READS = 2_000_000
# reads of the class counts' large batch (phase 13.1): 288 MB at 128
# positions, where the bytes, not the launch, set the bound
CLASS_COUNT_READS = 4 << 20
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


def _probe_loads(pl, c2, lengths, length: int, k: int, t: int, wmax: int,
                 v: int = CASCADE_V) -> dict:
    """The plane loads the sequential probe needs on these N-free reads
    against ``pl``: per strand, a plane-A load for each window it reaches
    (complete, at or past the greedy skip, before the count reaches t) and
    B, C, D loads for each of those whose A bit is set; the reverse strand
    only for reads whose forward count stays below t. Returns their word
    addresses, repeats kept ("addrs"), the counts "a" and "bcd",
    "skippable": the B/C/D loads at A hits past the ``v`` leftmost
    and the ``v`` rightmost A hits of their strand (among its complete
    windows: what commet_tpu's cascade verifies first, so the only loads
    a cascade could skip), and "a_hits": the A hits among all complete
    windows, both strands (plain torch ops, on the card or the CPU). The
    addresses keep the order strand by strand, plane by plane."""
    import torch
    from commet_tpu_torch.core import keys, planes
    wk = keys.window_keys(keys.unpack_codes_clean(c2, lengths, length), k,
                          "both", wmax)
    ok = wk["ok"]
    n = ok.shape[0]
    pw = planes.plane_words(k)
    counting = torch.ones(n, dtype=torch.bool, device=ok.device)
    addrs = []
    n_a = n_bcd = skippable = a_hits = 0
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
        hits = hit_a.to(torch.int64)
        left = torch.cumsum(hits, dim=1) - hits
        right = hits.sum(dim=1, keepdim=True) - left - hits
        loaded = reached & hit_a
        skippable += 3 * int((loaded & (left >= v) & (right >= v)).sum())
        a_hits += int(hits.sum())
        n_a += int(reached.sum())
        n_bcd += 3 * int(loaded.sum())
        for p, key in enumerate(planes.four_plane_keys(a, b)):
            addrs.append(p * pw + (key[reached if p == 0 else loaded] >> 5))
    return {"addrs": torch.cat(addrs), "a": n_a, "bcd": n_bcd,
            "skippable": skippable, "a_hits": a_hits}


def _plane_reads(device, gen_seed: int, lpad: int,
                 n_reads: int = PLANE_FILL_READS):
    """Phase 9's indexed reads: ``n_reads`` random N-free 100 bp reads as
    [n, lpad / 16] int32 code words, from a torch generator seeded with
    ``gen_seed``, and the generator."""
    import torch
    gen = torch.Generator(device=device)
    gen.manual_seed(gen_seed)
    words = torch.randint(-2 ** 31, 2 ** 31, (n_reads, lpad // 16),
                          dtype=torch.int32, device=device, generator=gen)
    return words, gen


def _probe_batch(words, device, gen_seed: int, lpad: int):
    """Phase 9's probe batch: PLANE_BATCH random reads, a third holding a
    2k bp fragment of one of the indexed reads ``words`` (N-free: lengths
    carry the validity), as code words on the card."""
    import torch
    n, k = PLANE_BATCH, PLANE_K
    rng = np.random.default_rng(gen_seed)
    qcodes = rng.integers(0, 4, (n, READ_LEN), dtype=np.uint8)
    third = n // 3
    donors = rng.integers(0, len(words), third)
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
    probe_addrs = _probe_loads(kern, qc2, lengths, lpad, k, T, wmax)["addrs"]
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
        addrs = _probe_loads(pl, qc2, lengths, lpad, k, T, wmax)["addrs"]
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


def _sorted_bins(bins, offsets):
    """Every entry of ``bins`` keyed by its bin (``offsets``), sorted: the
    bins as sets (the level-1 and level-2 kernels place a run's entries in
    the order their shared-memory atomics land)."""
    import torch
    n = offsets[1:] - offsets[:-1]
    b = torch.repeat_interleave(torch.arange(n.numel(), device=n.device), n)
    return torch.sort(b * (1 << 32) + bins[:b.numel()].to(torch.int64)).values


def _run_offsets(table, cstart, k: int):
    """Where each (tile, slice) run of level 2's sorted buffer starts, in
    buffer order (planes.bulk_runs), and the chunk's end."""
    import torch
    from commet_tpu_torch.core import planes
    return torch.cat([planes.bulk_runs(table, cstart, k)[1], cstart[-1:]])


def _bulk_chunk_check(pl, chunk, k: int) -> None:
    """One chunk of packed batches ORed into ``pl`` by the bulk kernels,
    each against its plain version: each batch's histogram table, level
    1's buffer (each coarse bin as a set), level 2 on copies of it (the
    kernel's table and fine counts equal to the plain version's, each
    (tile, slice) run as a set), and the apply onto ``pl`` against the
    plain apply of the same runs onto a copy."""
    import torch
    from commet_tpu_torch.core import planes
    _sb, _sw, ns, _rb = planes.bulk_layout(k)
    tables = [torch.zeros((0, planes.bulk_bins(k)[0]), dtype=torch.int32,
                          device=pl.device)]
    for bt in chunk:
        tables.append(planes.bulk_histogram(*bt, k))
        if not torch.equal(tables[-1], planes.bulk_histogram_plain(*bt, k)):
            raise AssertionError(f"k={k}: bulk_histogram differs from its "
                                 "plain version")
    starts, cstart = planes.bulk_starts(torch.cat(tables))
    size = 4 * sum(planes.bulk_slots(bt[0], bt[3], k) for bt in chunk)
    mid = torch.empty(size, dtype=torch.int32, device=pl.device)
    want_mid = torch.empty_like(mid)
    row0 = 0
    for bt in chunk:
        planes.bulk_scatter(mid, starts, row0, *bt, k)
        planes.bulk_scatter_plain(want_mid, starts, row0, *bt, k)
        row0 += planes.bulk_blocks(bt[0])
    if not torch.equal(_sorted_bins(mid, cstart),
                       _sorted_bins(want_mid, cstart)):
        raise AssertionError(f"k={k}: bulk_scatter differs from its plain "
                             "version")
    want_mid = mid.clone()
    table, want_table = planes.bulk_table(mid, k), planes.bulk_table(mid, k)
    counts = torch.zeros(4 * ns, dtype=torch.int64, device=pl.device)
    want_counts = torch.zeros_like(counts)
    planes.bulk_refine(mid, table, counts, cstart, k)
    planes.bulk_refine_plain(want_mid, want_table, want_counts, cstart, k)
    runs = _run_offsets(table, cstart, k)
    if not (torch.equal(table, want_table)
            and torch.equal(counts, want_counts)
            and torch.equal(_sorted_bins(mid, runs),
                            _sorted_bins(want_mid, runs))):
        raise AssertionError(f"k={k}: bulk_refine differs from its plain "
                             "version")
    del want_mid, want_table, want_counts
    want = planes.bulk_apply_plain(pl.clone(), mid, table, counts, cstart, k)
    planes.bulk_apply(pl, mid, table, counts, cstart, k)
    torch.cuda.synchronize()
    if not torch.equal(pl, want):
        raise AssertionError(f"k={k}: bulk_apply differs from its plain "
                             f"version in {int((pl != want).sum())} words")


def phase_bulk_edges(device, rng):
    """The bulk build's kernels against their plain versions at edge shapes,
    for k in EDGE_K: phase 9's edge reads (dirty and clean batches, reads
    shorter than k, 100 and 300 bp reads, Ns) in batches of 2,000 reads,
    and a clean batch of 300 bp reads with 2% A (plane D's keys, a | b,
    crowd into its last region: coarse bins of many level-2 tiles), in
    chunks of three batches' window slots (so a BulkChunk flushes every
    third batch and its last chunk is smaller), and a chunk with no
    complete window. Per chunk each kernel against its plain version
    (_bulk_chunk_check); the BulkChunk planes against the per-batch kernel
    build and bulk_build_planes_plain. Returns the chunks checked."""
    import torch
    from commet_tpu_torch.core import planes
    chunks = 0
    for k in EDGE_K:
        idx, lens = _edge_reads(rng, 20_000, k, 0.003)
        batches = [(*_edge_pack(device, idx[rows], lens[rows], clean), clean,
                    320)
                   for clean in (False, True)
                   for rows in np.array_split(np.arange(20_000), 5)]
        skew = np.full((2000, 320), 4, dtype=np.uint8)
        skew[:, :300] = rng.choice(4, (2000, 300), p=[0.02, 0.33, 0.33,
                                                       0.32])
        batches.append((*_edge_pack(device, skew, np.full(2000, 300), True),
                        True, 320))
        short = np.nonzero(lens < k)[0]
        empty = (*_edge_pack(device, idx[short], lens[short], False), False,
                 320)
        cap = 3 * planes.bulk_slots(batches[0][0], 320, k)
        per_batch = planes.alloc_planes(k, device)
        for bt in batches:
            planes.build_planes(per_batch, *bt, k)
        checked = planes.alloc_planes(k, device)
        plain = planes.alloc_planes(k, device)
        bulk = planes.alloc_planes(k, device)
        acc = planes.BulkChunk(bulk, k)
        cut = []
        for bt in batches + [empty]:
            cut.append(bt)
            acc.add(*bt)
            if acc.slots >= cap:
                acc.flush()
                _bulk_chunk_check(checked, cut, k)
                planes.bulk_build_planes_plain(plain, cut, k)
                cut, chunks = [], chunks + 1
        acc.flush()
        _bulk_chunk_check(checked, cut, k)
        planes.bulk_build_planes_plain(plain, cut, k)
        before = bulk.clone()
        planes.bulk_build_planes(bulk, [empty], k)
        _bulk_chunk_check(checked, [empty], k)
        torch.cuda.synchronize()
        if not (torch.equal(bulk, before) and torch.equal(bulk, per_batch)
                and torch.equal(plain, per_batch)
                and torch.equal(checked, per_batch)):
            raise AssertionError(f"k={k}: the bulk build differs from the "
                                 "per-batch build or its plain version")
        chunks += 2
        del per_batch, checked, plain, bulk, before, acc, batches
        torch.cuda.empty_cache()
    return chunks


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
        builds, joins = (_build_launches(planes),
                         stream.join_membership.launches)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = real(self, index_set, query_sets, **kw)
        synchronize(self.device)
        wall = time.perf_counter() - t0
        routes = (_build_launches(planes) - builds,
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


def _ranged_probe_addrs(pl, wk, k: int) -> dict:
    """Word addresses, into the whole plane set ``pl``, of the ranged
    probe's plane loads on window keys ``wk``, repeats kept: "a" pass A's
    plane-A word of every complete window, "veto" pass B/C/D's B, C and D
    words of the windows with A set (together what the result needs), and
    "every" the one-pass design's, every word of every complete window
    (each loaded by its shard)."""
    import torch
    from commet_tpu_torch.core import planes
    pw = planes.plane_words(k)
    ok = wk["ok"]
    out = {"a": [], "veto": [], "every": []}
    for s in ("f", "r"):
        keys4 = planes.four_plane_keys(torch.where(ok, wk[s + "a"], 0),
                                       torch.where(ok, wk[s + "b"], 0))
        addr = [p * pw + (key >> 5) for p, key in enumerate(keys4)]
        a_set = (pl[addr[0]].to(torch.int64) >> (keys4[0] & 31)) & 1 == 1
        out["every"] += [a[ok] for a in addr]
        out["a"].append(addr[0][ok])
        out["veto"] += [a[ok & a_set] for a in addr[1:]]
    return {name: torch.cat(x) for name, x in out.items()}


def phase_mesh_kernels(device, gen_seed: int):
    """Phase 13.1: the multi-device kernels against their plain versions,
    beside their bounds (the bytes they must move at the HBM rate) and
    their plain versions' ms, each ms by CUDA events per range launch.
    Build: phase 9's first 65,536-read batch at k = 33 into 4 word ranges
    (1 GiB shards) by commet_build_planes_range, each range equal to the
    plain version's and to its words of commet_build_planes' planes, timed
    on fresh batches; then every range and the whole set filled from phase
    9's 4M reads. Probe of phase 9's probe batch against each range: pass A
    and pass B/C/D equal to their plain versions, sharded tags equal to
    probe_planes'; each timed with its plane loads and distinct sectors,
    beside the one-pass design's loads, sectors and bound."""
    import torch
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
    build_entries = build_sectors = build_words = 0
    for b in timed:
        addrs = _build_addrs(b, lengths[:len(b)], lpad, k)
        build_entries += addrs.numel()
        build_sectors += _sectors(addrs)
        build_words += torch.unique(addrs).numel()
    build_entries //= reps
    build_sectors //= reps
    build_words //= reps
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
    args = (qc2, lengths, True, lpad, k)
    nwords = planes.window_words(wmax)
    packed = torch.zeros((n, 2, nwords), dtype=torch.int32, device=device)

    def part_a(d, out=None):
        return planes.probe_planes_part_a(ps.shards[d], *args, d * wl, wl,
                                          wmax, out)

    def veto(d, ahit, out=None):
        return planes.probe_planes_part(ps.shards[d], *args, d * wl, wl,
                                        wmax, ahit, out)

    ahit = None
    for d in range(MESH_N):
        got = part_a(d)
        want = planes.probe_planes_part_a_plain(ps.shards[d], *args, d * wl,
                                                wl, wmax)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"ranged probe pass A differs from its "
                                 f"plain version in range {d}")
        ahit = got if ahit is None else ahit | got
    vetoes = None
    for d in range(MESH_N):
        got = veto(d, ahit)
        want = planes.probe_planes_part_plain(ps.shards[d], *args, d * wl,
                                              wl, wmax, ahit)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"ranged probe vetoes differ from their "
                                 f"plain version in range {d}")
        vetoes = got if vetoes is None else vetoes | got
    member = planes.unpack_window_bits(ahit & ~vetoes, wmax)
    tags = sharded.probe_planes_sharded(ps, qc2, lengths, True, lpad, T, wmax)
    single = planes.probe_planes(whole, qc2, lengths, True, lpad, k, T, wmax)
    if not torch.equal(tags, single) or not bool(tags[:n // 3].all()):
        raise AssertionError("sharded tags differ from probe_planes' or miss "
                             "a read holding an indexed fragment")
    members = int(member.sum())

    def per_range(fn, reps=10):
        return cuda_ms(lambda: [fn(d) for d in range(MESH_N)], reps) / MESH_N

    probe_ms = {
        "a": per_range(lambda d: part_a(d, packed)),
        "veto": per_range(lambda d: veto(d, ahit, packed)),
        "sharded": cuda_ms(lambda: sharded.probe_planes_sharded(
            ps, qc2, lengths, True, lpad, T, wmax), 10)}
    probe_plain_ms = {
        "a": per_range(lambda d: planes.probe_planes_part_a_plain(
            ps.shards[d], *args, d * wl, wl, wmax), 2),
        "veto": per_range(lambda d: planes.probe_planes_part_plain(
            ps.shards[d], *args, d * wl, wl, wmax, ahit), 2)}
    wk = keys.window_keys(keys.unpack_codes_clean(qc2, lengths, lpad), k,
                          "both", wmax)
    addrs = _ranged_probe_addrs(whole, wk, k)
    loads = {name: x.numel() for name, x in addrs.items()}
    sectors = {name: _sectors(x) for name, x in addrs.items()}
    sectors["needed"] = _sectors(torch.cat([addrs["a"], addrs["veto"]]))
    del wk, addrs, ps, whole
    # per range: the batch read once, and the packed words written (and
    # read where a pass takes the merged A words; the one-pass design wrote
    # a byte a window and strand); together the ranges load each distinct
    # sector of the design's loads once
    qbytes = qc2.numel() * 4 + n * 4
    words_bytes = packed.numel() * 4

    def part_bound(io_bytes, n_sectors):
        return bound_ms((MESH_N * io_bytes + SECTOR * n_sectors) / MESH_N)

    probe_bound = {
        "a": part_bound(qbytes + words_bytes, sectors["a"]),
        "veto": part_bound(qbytes + 2 * words_bytes, sectors["veto"]),
        "every": part_bound(qbytes + n * 2 * wmax, sectors["every"])}

    def fig(ms, plain_ms, bound):
        return {"max_abs_err": 0, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound}

    return {
        "build_range": fig(build_ms, build_plain_ms, build_bound),
        "probe_part_a": fig(probe_ms["a"], probe_plain_ms["a"],
                            probe_bound["a"]),
        "probe_part": fig(probe_ms["veto"], probe_plain_ms["veto"],
                          probe_bound["veto"]),
        "build_entries": build_entries, "build_words": build_words,
        "build_sectors": build_sectors, "fill_s": fill_s,
        "two_pass_ms": probe_ms["a"] + probe_ms["veto"],
        "two_pass_bound_ms": probe_bound["a"] + probe_bound["veto"],
        "one_pass_bound_ms": probe_bound["every"],
        "sharded_ms": probe_ms["sharded"], "loads": loads,
        "sectors": sectors, "members": members, "tagged": int(tags.sum())}


def device_ms(fn, names) -> dict:
    """{name: [milliseconds, events]} of the kernels whose name holds each
    of ``names`` over one call of fn, summed from torch.profiler's device
    events (the kernels' own time, without the calls' host work)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {name: [0.0, 0] for name in names}
    for evt in prof.key_averages():
        for name in names:
            if name in evt.key:
                out[name][0] += (getattr(evt, "device_time_total", None)
                                 or evt.cuda_time_total) / 1e3
                out[name][1] += evt.count
    return out


def kernel_ms(fn, name: str, reps: int) -> float:
    """Mean device milliseconds of the kernels whose name holds ``name``
    over ``reps`` calls of fn after one warm-up call (device_ms). The
    profiler can miss a device event of its window (one of 20 in an H100
    run), so the mean is over the events it saw; it fails on none or more
    than ``reps``."""
    import torch
    fn()
    torch.cuda.synchronize()
    total, count = device_ms(lambda: [fn() for _ in range(reps)],
                             [name])[name]
    if not 0 < count <= reps:
        raise AssertionError(f"torch.profiler saw {count} device events of "
                             f"{name} for {reps} calls")
    return total / count


def _dirty_batch_on_card(device, seed: int, n: int, lpad: int):
    """``n`` reads of 50-100 random bases, 1% of the bases N, made on the
    card: (codes2, valid, lengths) int32 tensors."""
    import torch
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    c2 = torch.randint(-2 ** 31, 2 ** 31, (n, lpad // 16), dtype=torch.int32,
                       device=device, generator=gen)
    lens = torch.randint(READ_LEN // 2, READ_LEN + 1, (n,), dtype=torch.int32,
                         device=device, generator=gen)
    pos = torch.arange(lpad, device=device)
    shifts = torch.arange(32, device=device, dtype=torch.int64)
    vd = torch.empty((n, lpad // 32), dtype=torch.int32, device=device)
    for start in range(0, n, 1 << 20):
        sl = slice(start, min(n, start + (1 << 20)))
        bits = (pos < lens[sl, None]) & (torch.rand(
            (sl.stop - start, lpad), device=device, generator=gen) > 0.01)
        vd[sl] = (bits.view(-1, lpad // 32, 32).to(torch.int64)
                  << shifts).sum(dim=2).to(torch.int32)
    return c2, vd, lens


def phase_class_counts(device, gen_seed: int) -> dict:
    """The class counts (commet_class_counts) of a dirty 65,536-read batch
    (phase 13.1's, 128 positions) equal to the plain version's and to
    numpy's, then filter_batch_device on it (the path the launch count
    reads) equal to the host filter; and of 4M dirty reads made on the card
    equal to the plain version's. At both sizes the kernel's own ms
    (kernel_ms: torch.profiler's device time), the wrapper's ms per call
    (CUDA events around back-to-back calls: shape checks, allocation and
    the launch included), the plain version's and the bound (the batch read
    once and the counts written once at the HBM rate)."""
    import torch
    from commet_tpu_torch.core import filter as tfilter
    lpad, big = 128, CLASS_COUNT_READS
    host, (c2, vd, lens), want_counts = _dirty_batch(device, gen_seed + 2,
                                                     lpad)
    got = tfilter.class_counts_packed(c2, vd, lens, lpad)
    want = tfilter.class_counts_packed_plain(c2, vd, lens, lpad)
    torch.cuda.synchronize()
    err = int((got - want).abs().max())
    if not torch.equal(got, want) or not np.array_equal(
            got.cpu().numpy(), want_counts):
        raise AssertionError("class counts kernel differs from its plain "
                             "version or from numpy")
    tfilter.class_counts_packed.launches = 0
    kw = {"min_size": 60, "max_n": 0, "min_shannon": 1.9}
    keep, stats = tfilter.filter_batch_device(*host, lpad, device=device, **kw)
    launches = tfilter.class_counts_packed.launches
    keep_h, stats_h = tfilter.filter_reads_counts(
        want_counts, host[2].astype(np.int64), **kw)
    if launches == 0 or stats != stats_h or not np.array_equal(keep,
                                                               keep_h):
        raise AssertionError(f"filter_batch_device {stats} (launches "
                             f"{launches}) != the host filter {stats_h}")
    figs = {}
    for size, batch in ((PLANE_BATCH, (c2, vd, lens)),
                        (big, _dirty_batch_on_card(device, gen_seed + 3, big,
                                                   lpad))):
        if size == big and not torch.equal(
                tfilter.class_counts_packed(*batch, lpad),
                tfilter.class_counts_packed_plain(*batch, lpad)):
            raise AssertionError(f"class counts kernel differs from its "
                                 f"plain version on {size} reads")

        def call(batch=batch):
            return tfilter.class_counts_packed(*batch, lpad)

        def plain(batch=batch):
            return tfilter.class_counts_packed_plain(*batch, lpad)

        figs[size] = {
            "max_abs_err": err,
            "ms": kernel_ms(call, "class_counts_kernel", 20),
            "wrapper_ms": cuda_ms(call, 20),
            "plain_ms": cuda_ms(plain, 3),
            "bound_ms": bound_ms(sum(x.numel() * 4 for x in batch)
                                 + size * 5 * 4)}
        torch.cuda.empty_cache()
    return {"batch": figs[PLANE_BATCH], "large": figs[big],
            "large_reads": big, "filter_stats": stats,
            "launches": launches}


def phase_pack_kernel(device, seed: int) -> dict:
    """The gather and pack on the card (pack.gather_pack, csrc/pack.cu) of
    65,536-read batches of a 1M-read set of 100 bp reads (1% of the reads
    with an N; a query set of the benchmark's partition-search), the rows
    in order and shuffled: equal bit for bit to the host's pack
    (native.gather_packed) and to the plain version run on the card. The
    kernel's own ms (kernel_ms: torch.profiler's device time) and the
    wrapper's ms a call (CUDA events around back-to-back calls), the plain
    version's, the host pack's ms for the same batch, the bound (ids,
    offsets, lengths and codes read once, the batch written once at the HBM
    rate), and the set's upload from pageable memory into memory already
    allocated on the card, after a first small copy, in GB/s."""
    import torch
    from commet_tpu_torch.core import pack
    from commet_tpu_torch.native import parser as native
    rng = np.random.default_rng(seed)
    n_set, n, lpad = 1 << 20, PLANE_BATCH, 128
    codes = rng.integers(0, 4, n_set * READ_LEN, dtype=np.uint8)
    codes[rng.choice(n_set, n_set // 100, replace=False) * READ_LEN
          + rng.integers(0, READ_LEN, n_set // 100)] = 4
    offsets = np.arange(n_set + 1, dtype=np.int64) * READ_LEN
    lengths = np.full(n_set, READ_LEN, dtype=np.int32)
    dev_codes = torch.empty(len(codes), dtype=torch.uint8, device=device)
    dev_codes[:1 << 20].copy_(torch.from_numpy(codes[:1 << 20]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dev_codes.copy_(torch.from_numpy(codes))
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    dev_off = torch.from_numpy(offsets[:-1]).to(device)
    dev_len = torch.from_numpy(lengths).to(device)
    figs = {}
    for order in ("in_order", "shuffled"):
        rows = (np.arange(n, dtype=np.int64) + n_set // 3 if order ==
                "in_order" else rng.choice(n_set, n, replace=False))
        ids = torch.from_numpy(rows).to(device)
        t0 = time.perf_counter()
        for _ in range(3):
            want = native.gather_packed(codes, offsets, lengths, rows, lpad)
        host_ms = (time.perf_counter() - t0) / 3 * 1e3

        def call(ids=ids):
            return pack.gather_pack(dev_codes, dev_off, dev_len, ids, lpad)

        def plain(ids=ids):
            return pack.gather_pack_plain(dev_codes, dev_off, dev_len, ids,
                                          lpad)

        got, ref = call(), plain()
        for g, r, h in zip(got, ref, want[:3]):
            if not torch.equal(g, r) or not np.array_equal(
                    g.cpu().numpy().view(h.dtype), h):
                raise AssertionError(f"gather_pack ({order}) differs from "
                                     "its plain version or the host pack")
        n_bytes = (n * READ_LEN + n * (8 + 8 + 4)
                   + n * 4 * (lpad // 16 + lpad // 32 + 1))
        figs[order] = {
            "max_abs_err": 0,
            "ms": kernel_ms(call, "gather_pack_kernel", 20),
            "wrapper_ms": cuda_ms(call, 20),
            "plain_ms": cuda_ms(plain, 3),
            "host_ms": host_ms,
            "bound_ms": bound_ms(n_bytes)}
    return {**figs, "reads": n, "upload_GB_per_s": len(codes) / upload_s
            / 1e9, "upload_bytes": len(codes)}


def _class_counts_line(cc: dict) -> str:
    parts = []
    for key, reads in (("batch", PLANE_BATCH), ("large", cc["large_reads"])):
        fig = cc[key]
        parts.append(
            f"{reads} reads: kernel {fig['ms']:.4f} ms (torch.profiler), "
            f"wrapper {fig['wrapper_ms']:.4f} ms a call, plain "
            f"{fig['plain_ms']:.4f} ms, bound {fig['bound_ms']:.4f} ms "
            f"({100 * fig['bound_ms'] / fig['ms']:.1f}% of bound)")
    return "; ".join(parts)


def _plane_fills(pl, k: int):
    """Share of set bits in each of the four planes of ``pl``."""
    from commet_tpu_torch.core import planes
    w = planes.plane_words(k)
    return [_plane_fill(pl[p * w:(p + 1) * w], k) for p in range(4)]


def _chance_tags(rates, n_reads: int, k: int) -> float:
    """Reads of ``n_reads`` random 100 bp reads a four-plane set tags at
    t = 2 by chance, where a random window finds its bit set in each plane
    at these ``rates``: a window passes with probability p = their product
    (the four bits taken as independent); a strand counts two when a pass
    follows its first at least k windows on; a read is tagged when either
    strand does."""
    p = float(np.prod(rates))
    w = READ_LEN - k + 1
    q = sum((1 - p) ** i * p * (1 - (1 - p) ** max(0, w - i - k))
            for i in range(w))
    return n_reads * (1 - (1 - q) ** 2)


def make_pair(rng, tmp: str, n_reads: int, frag: int):
    """Two fasta sets made as phase 10 makes its sets: set 2's even reads
    hold ``frag`` bp N-free fragments of random set-1 reads; 1% of each
    set's reads carry one N, drawn among the reads that neither hold nor
    give a fragment. Writes set1.fa, set2.fa and set2_cut.fa (set 2's first
    TRACE_READS reads); returns the two sets' [n_reads, 100] codes."""
    sets = [rng.integers(0, 4, (n_reads, READ_LEN), dtype=np.uint8)
            for _ in range(2)]
    even = np.arange(0, n_reads, 2)
    _counts, donors = _implant(rng, sets, 1, 0, even, np.arange(n_reads),
                               frag)
    used = [np.zeros(n_reads, dtype=bool) for _ in sets]
    used[1][even] = used[0][donors] = True
    del donors
    for s, u in zip(sets, used):
        rows = rng.choice(np.nonzero(~u)[0], n_reads // 100, replace=False)
        s[rows, rng.integers(0, READ_LEN, len(rows))] = 4
    for i, s in enumerate(sets):
        _write_fasta(os.path.join(tmp, f"set{i + 1}.fa"), s)
    _write_fasta(os.path.join(tmp, "set2_cut.fa"), sets[1][:TRACE_READS])
    return sets


def _pack_on_card(codes, device, lpad: int):
    """[b, L] uint8 numpy codes (4 = N) -> (codes2, valid) int32 words on
    the card, padded to ``lpad`` positions."""
    import torch
    b, length = codes.shape
    x = torch.full((b, lpad), 4, dtype=torch.uint8, device=device)
    x[:, :length] = torch.from_numpy(codes).to(device)
    valid = x < 4
    fields = torch.where(valid, x, 0).to(torch.int64)

    def words(bits, per_word, width):
        shifts = torch.arange(per_word, device=device) * width
        w = (bits.view(b, -1, per_word) << shifts).sum(dim=2)
        return ((w + 2 ** 31) % 2 ** 32 - 2 ** 31).to(torch.int32)

    return words(fields, 16, 2), words(valid.to(torch.int64), 32, 1)


def _planes_from_codes(codes, device):
    """Set 1's planes built again by commet_build_planes, batch by batch,
    from its [n, 100] codes (every read indexed: one partition)."""
    from commet_tpu_torch.core import planes
    pl = planes.alloc_planes(PLANE_K, device)
    for start in range(0, len(codes), PLANE_BATCH):
        c2, vd = _pack_on_card(codes[start:start + PLANE_BATCH], device, 128)
        planes.build_planes(pl, c2, vd, False, 128, PLANE_K)
    return pl


def _plane_hit_rates(pl, codes, rows, device):
    """Share of the complete windows (both strands) of reads ``rows`` of
    ``codes`` whose bit is set, in each of the four planes of ``pl``: the
    fill a random window meets (plane D's keys, a | b, are not uniform, so
    its rate exceeds its fill)."""
    import torch
    from commet_tpu_torch.core import keys, planes
    c2, vd = _pack_on_card(codes[rows], device, 128)
    wk = keys.window_keys(keys.unpack_codes(c2, vd, 128), PLANE_K, "both",
                          READ_LEN - PLANE_K + 1)
    ok, w = wk["ok"], planes.plane_words(PLANE_K)
    hits = torch.zeros(4, dtype=torch.int64, device=ok.device)
    for s in ("f", "r"):
        for p, key in enumerate(planes.four_plane_keys(
                torch.where(ok, wk[s + "a"], 0),
                torch.where(ok, wk[s + "b"], 0))):
            word, bit = planes.plane_addr(key)
            hits[p] += (((pl[p * w + word].to(torch.int64) >> bit) & 1 == 1)
                        & ok).sum()
    return (hits.cpu().numpy() / float(2 * int(ok.sum()))).tolist()


def _plain_tags(pl, codes, rows, device):
    """probe_planes_plain's tags of reads ``rows`` of ``codes``."""
    import torch
    from commet_tpu_torch.core import planes
    out = []
    for start in range(0, len(rows), PLANE_BATCH):
        c2, vd = _pack_on_card(codes[rows[start:start + PLANE_BATCH]],
                               device, 128)
        out.append(planes.probe_planes_plain(pl, c2, vd, False, 128, PLANE_K,
                                             T, READ_LEN - PLANE_K + 1))
    return (torch.cat(out).cpu().numpy() if out
            else np.zeros(0, dtype=bool))


def trace_figures(path: str, wall_s: float) -> dict:
    """From a Chrome trace of torch.profiler: the card's busy milliseconds
    (the union of its kernel, copy and set intervals), their share of
    ``wall_s`` (the same call's unprofiled wall: the profiler's own CPU
    recording lengthens the profiled one), and the device operations with
    the most milliseconds."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    dev = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                 if e.get("ph") == "X" and e.get("cat") in (
                     "kernel", "gpu_memcpy", "gpu_memset"))
    if not dev:
        raise AssertionError(f"{path} holds no device event")
    busy_us, end = 0.0, None
    by_name = {}
    for start, stop, name in dev:
        by_name[name] = by_name.get(name, 0.0) + (stop - start)
        if end is None or start > end:
            busy_us += stop - start
            end = stop
        elif stop > end:
            busy_us += stop - end
            end = stop
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"busy_ms": busy_us / 1e3, "busy_share": busy_us / 1e6 / wall_s,
            "device_events": len(dev),
            "top": [(name[:60], us / 1e3) for name, us in top]}


def _log_times(path: str):
    """(index time, search time, counter line) of a .log."""
    with open(path) as f:
        lines = f.read().splitlines()
    return (float(lines[0].split(":")[1].split()[0]),
            float(lines[1].split(":")[1].split()[0]), lines[-1])


def phase_default_fill(device: str, rng, tmp: str) -> dict:
    """Phase 14: COMMET's own partition size on the card. Two sets of
    DEFAULT_FILL_READS reads (make_pair); the port's index_and_search CLI
    (-k 33 -t 2) with set 2 against set 1: 999.6M k-mers less the N reads'
    in one partition (11.6% fill), so the planes. Every fragment read must
    be tagged; each chance tag (a tagged read without a fragment) must be a
    member of set 1's planes built again by commet_build_planes under the
    plain probe, and a 65,536-read sample of the untagged reads must not.
    Then set 2's first TRACE_READS reads against set 1 through Engine three
    times: with COMMET_TPU_PROFILE (its trace gives the card's busy share),
    with prefetch, and with COMMET_TPU_PREFETCH=0; equal tags."""
    import torch
    from commet_tpu_torch.cli import index_and_search
    from commet_tpu_torch.core import planes, stream
    from commet_tpu_torch.device import synchronize
    from commet_tpu_torch.engine.engine import Engine
    from commet_tpu_torch.io.bv import BitVector
    from commet_tpu_torch.io.reads import ReadSet
    n = DEFAULT_FILL_READS
    t0 = time.perf_counter()
    sets = make_pair(rng, tmp, n, 2 * PLANE_K)
    fig = {"make_s": time.perf_counter() - t0}
    fofs = []
    for i in (1, 2):
        fofs.append(os.path.join(tmp, f"pair{i}.txt"))
        with open(fofs[-1], "w") as f:
            f.write(f"set{i}: {os.path.join(tmp, f'set{i}.fa')}\n")
    seen = {}
    real = {name: getattr(Engine, name) for name in ("index_and_search",
                                                      "partitions")}

    def timed(self, index_set, query_sets, **kw):
        seen["call_start"] = time.perf_counter()
        out = real["index_and_search"](self, index_set, query_sets, **kw)
        synchronize(self.device)
        seen["io"] = dict(self.last_io_stats)
        return out

    def parts(self, kmer_counts):
        out = real["partitions"](self, kmer_counts)
        seen["fills"] = [float(kmer_counts[p].sum()) / 2.0 ** self.k
                         for p in out]
        return out

    out = os.path.join(tmp, "pair_out")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(stream, planes)
    Engine.index_and_search, Engine.partitions = timed, parts
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            rc = index_and_search.main([
                "-i", fofs[0], "-s", fofs[1], "-k", str(PLANE_K), "-t",
                str(T), "-o", out, "-l", out, "--device", device])
    finally:
        for name, fn in real.items():
            setattr(Engine, name, fn)
    fig["wall_s"] = time.perf_counter() - t0
    fig["peak"] = torch.cuda.max_memory_allocated()
    fig["launches"] = _plane_launches(planes)[:-1] + (
        stream.join_membership.launches,)
    if rc != 0:
        raise AssertionError(f"index_and_search exited {rc}")
    if min(fig["launches"][:-1]) == 0 or fig["launches"][-1] != 0:
        raise AssertionError(f"{_plane_names(planes)}/join launches "
                             f"{fig['launches']}: the planes must serve")
    if len(seen["fills"]) != 1 or seen["fills"][0] < 0.11:
        raise AssertionError(f"partition fills {seen['fills']}: one "
                             "partition of at least 11% expected")
    fig["fill"] = seen["fills"][0]
    index_s, search_s, counters = _log_times(
        os.path.join(out, "set2_in_set1.log"))
    searched = int(counters.split("searched ")[1].split(",")[0])
    fig.update(counters=counters, rate=searched / search_s, split={
        "parse": seen["call_start"] - t0, "index": index_s,
        "search": search_s, "host_pack": seen["io"]["host_pack_s"],
        "host_block": seen["io"]["host_block_s"],
        "rest": fig["wall_s"] - (seen["call_start"] - t0) - index_s
        - search_s})
    tags = BitVector.read(os.path.join(out, "set2.fa_in_set1.bv")) \
        .as_bool_array()[:n]
    frag = np.arange(n) % 2 == 0
    if not tags[frag].all():
        raise AssertionError(f"{int((~tags[frag]).sum())} reads holding a "
                             "fragment are untagged")
    chance = np.nonzero(tags & ~frag)[0]
    untagged = np.nonzero(~tags)[0]
    sample = np.sort(rng.choice(untagged, PLANE_BATCH, replace=False))
    t0 = time.perf_counter()
    pl = _planes_from_codes(sets[0], device)
    fig["fills4"] = _plane_fills(pl, PLANE_K)
    if not _plain_tags(pl, sets[1], chance, device).all() or _plain_tags(
            pl, sets[1], sample, device).any():
        raise AssertionError("a chance tag or an untagged read disagrees "
                             "with the plain probe on set 1's planes")
    fig["hit_rates"] = _plane_hit_rates(pl, sets[1], sample, device)
    del pl
    torch.cuda.empty_cache()
    fig.update(chance=len(chance), check_s=time.perf_counter() - t0,
               chance_expected=_chance_tags(fig["hit_rates"],
                                            int((~frag).sum()), PLANE_K),
               chance_expected_fills=_chance_tags(
                   fig["fills4"], int((~frag).sum()), PLANE_K))

    index_set, cut = ReadSet("set1"), ReadSet("set2")
    index_set.add_file(os.path.join(tmp, "set1.fa"))
    cut.add_file(os.path.join(tmp, "set2_cut.fa"))
    trace_dir = os.path.join(tmp, "traces")
    fig["cut_walls"] = {}
    for name, env in (("profiled", {"COMMET_TPU_PROFILE": trace_dir}),
                      ("prefetched", {}), ("inline",
                                           {"COMMET_TPU_PREFETCH": "0"})):
        os.environ.update(env)
        try:
            eng = Engine(k=PLANE_K, t=T, device=device)
            for bv in cut.result_bvs:
                bv.set_all_false()
            cut_out = os.path.join(tmp, "cut_" + name)
            os.makedirs(cut_out)
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            eng.index_and_search(index_set, [cut], out_dir=cut_out,
                                 log_dir=cut_out)
            synchronize(eng.device)
            fig["cut_walls"][name] = time.perf_counter() - t0
        finally:
            for key in env:
                del os.environ[key]
        got = BitVector.read(os.path.join(cut_out, "set2_cut.fa_in_set1.bv"))
        if not np.array_equal(got.as_bool_array()[:TRACE_READS],
                              tags[:TRACE_READS]):
            raise AssertionError(f"the cut call ({name}) tags differently")
        if name == "profiled":
            if eng.last_trace is None or not eng.last_trace.startswith(
                    trace_dir):
                raise AssertionError("COMMET_TPU_PROFILE wrote no trace")
            trace_path = eng.last_trace
    fig["trace"] = trace_figures(trace_path, fig["cut_walls"]["prefetched"])
    fig["trace_bytes"] = os.path.getsize(trace_path)
    return fig


def phase_default_fill_kernels(device, gen_seed: int) -> dict:
    """Phase 14's kernels at 11.6% fill: a four-plane set filled from
    DEFAULT_FILL_READS random N-free reads (999.6M k-mers, one default
    partition) by commet_build_planes, timed whole, and one more batch on
    copies of it against the plain build, beside the bound of its distinct
    sectors; phase 9's probe batch
    (its fragments drawn from these reads) through probe_planes and the
    grouped probe at S = 3 (two more sets filled the same way), each equal
    to its plain version, timed beside its bound with its plane loads split
    into A and B/C/D; the B/C/D loads a cascade could skip (_probe_loads);
    and the bulk build (K9) of the same batches against the fill
    (phase_bulk_default_fill)."""
    import torch
    from commet_tpu_torch.core import planes
    k, n, lpad, reads = PLANE_K, PLANE_BATCH, 128, DEFAULT_FILL_READS
    wmax = READ_LEN - k + 1
    words, gen = _plane_reads(device, gen_seed, lpad, reads)
    lengths = torch.full((n,), READ_LEN, dtype=torch.int32, device=device)
    batches = [words[i:i + n] for i in range(0, reads, n)]

    def build(pl, c2):
        planes.build_planes(pl, c2, lengths[:len(c2)], True, lpad, k)

    def fill(pl, batch_list):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        for b in batch_list:
            build(pl, b)
        end.record()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, start.elapsed_time(end)

    pl = planes.alloc_planes(k, device)
    build(pl, batches[0])  # warm-up, then from zero
    pl.zero_()
    fill_s, fill_ms = fill(pl, batches)
    fills = _plane_fills(pl, k)
    # one more batch onto copies of the filled set, kernel and plain
    gen.manual_seed(gen_seed + 3)
    extra = torch.randint(-2 ** 31, 2 ** 31, (n, lpad // 16),
                          dtype=torch.int32, device=device, generator=gen)
    kern_pl, plain_pl = pl.clone(), pl.clone()
    build(kern_pl, extra)
    # warm-up: batch 0 is in the set already, so it sets no bit
    planes.build_planes_plain(plain_pl, batches[0], lengths, True, lpad, k)
    build_plain_ms = _events_ms([lambda: planes.build_planes_plain(
        plain_pl, extra, lengths, True, lpad, k)])
    if not torch.equal(kern_pl, plain_pl):
        raise AssertionError("build kernel differs from its plain version "
                             "on a filled set")
    del kern_pl, plain_pl
    build_sectors = _sectors(_build_addrs(extra, lengths, lpad, k))
    build_fig = {"max_abs_err": 0, "ms": fill_ms / len(batches),
                 "plain_ms": build_plain_ms,
                 "bound_ms": bound_ms(extra.numel() * 4 + n * 4
                                      + 2 * SECTOR * build_sectors)}
    qc2 = _probe_batch(words, device, gen_seed, lpad)
    third = n // 3

    def probe(p):
        return planes.probe_planes(p, qc2, lengths, True, lpad, k, T, wmax)

    def probe_plain(p):
        return planes.probe_planes_plain(p, qc2, lengths, True, lpad, k, T,
                                         wmax)

    got, want = probe(pl), probe_plain(pl)
    if not torch.equal(got, want):
        raise AssertionError(f"probe kernel differs from its plain version "
                             f"on {int((got != want).sum())} reads at 11.6%")
    if not bool(got[:third].all()):
        raise AssertionError("a read holding an indexed fragment is untagged")
    batch_bytes = qc2.numel() * 4 + n * 4
    loads = _probe_loads(pl, qc2, lengths, lpad, k, T, wmax)
    sectors = _sectors(loads["addrs"])
    fig = {"fill_s": fill_s, "fill_ms": fill_ms, "fills": fills,
           "build": build_fig, "build_sectors": build_sectors,
           "build_windows": reads * wmax,
           "probe": {"max_abs_err": 0, "ms": cuda_ms(lambda: probe(pl), 10),
                     "plain_ms": cuda_ms(lambda: probe_plain(pl), 3),
                     "bound_ms": bound_ms(batch_bytes + SECTOR * sectors)},
           "tagged_random": int(got[third:].sum()),
           "loads": {key: loads[key] for key in ("a", "bcd", "skippable",
                                                 "a_hits")},
           "sectors": sectors,
           "a_hits_per_strand": loads["a_hits"] / (2 * n)}
    del loads

    others = []
    for seed in (gen_seed + 1, gen_seed + 2):
        gen.manual_seed(seed)
        others.append(planes.alloc_planes(k, device))
        for _ in range(len(batches)):
            build(others[-1], torch.randint(
                -2 ** 31, 2 ** 31, (n, lpad // 16), dtype=torch.int32,
                device=device, generator=gen))
    slots = planes.PlaneSlots([pl] + others)

    def multi():
        return planes.probe_planes_multi(slots, qc2, lengths, True, lpad, k,
                                         T, wmax)

    def multi_plain():
        return planes.probe_planes_multi_plain(slots.planes, qc2, lengths,
                                               True, lpad, k, T, wmax)

    mgot = multi()
    if not torch.equal(mgot, multi_plain()) or not torch.equal(mgot[0], got):
        raise AssertionError("grouped probe differs from its plain version "
                             "or from the single probe at 11.6%")
    multi_loads = {"a": 0, "bcd": 0}
    multi_sectors = 0
    for p in slots.planes:
        got_loads = _probe_loads(p, qc2, lengths, lpad, k, T, wmax)
        multi_loads["a"] += got_loads["a"]
        multi_loads["bcd"] += got_loads["bcd"]
        multi_sectors += _sectors(got_loads["addrs"])
    fig.update(
        multi={"max_abs_err": 0, "ms": cuda_ms(multi, 10),
               "plain_ms": cuda_ms(multi_plain, 3),
               "bound_ms": bound_ms(batch_bytes + 2 * n * 4
                                    + SECTOR * multi_sectors)},
        multi_loads=multi_loads, multi_sectors=multi_sectors,
        multi_tagged=[int(x.sum()) for x in mgot])
    del slots, others, mgot, p, got_loads
    torch.cuda.empty_cache()

    fig["bulk"] = phase_bulk_default_fill(pl, batches, lengths, lpad,
                                          fill_ms)
    return fig


def _bulk_fill(pl, batches, lengths, lpad: int, chunk: int, stats=None):
    """``pl`` zeroed, then ``batches`` (clean [n, lpad / 16] code words of
    100 bp reads) built into it by planes.BulkChunk as Engine.build_planes
    cuts a partition: a chunk flushed once it reaches ``chunk`` window
    slots. With ``stats``, adds each chunk's entries, its fine bins that
    hold entries, its level-2 tiles and the chunks to it. Returns (wall s,
    CUDA-event ms)."""
    import torch
    from commet_tpu_torch.core import planes
    pl.zero_()
    acc = planes.BulkChunk(pl, PLANE_K)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def flush():
        acc.flush()
        if stats is not None:
            stats["entries"] += int(acc.counts.sum())
            stats["bins"] += int((acc.counts > 0).sum())
            stats["tiles"] += int(-(-acc.counts.view(
                planes.bulk_bins(PLANE_K)[0], -1).sum(1)
                // planes.BULK_TILE).sum())
            stats["chunks"] += 1

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    for b in batches:
        acc.add(b, lengths[:len(b)], True, lpad)
        if acc.slots >= chunk:
            flush()
    if acc.batches:
        flush()
    end.record()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, start.elapsed_time(end)


BULK_PASSES = ("hist", "scatter", "refine", "apply")
# clock cycles the card sleeps before a timed pass (about 2 ms on an H100)
PASS_SLEEP_CYCLES = 4_000_000
# the passes' events may sum to at most this share of the whole build's
# (which also holds the tables' scans and the allocations); above it a
# pass's launches outran the sleep and timed the host: the passes are
# timed again, at most PASS_TRIES times in all
PASS_SUM_SLACK, PASS_TRIES = 1.1, 3


def _bulk_passes(pl, batches, lengths, lpad: int, chunk: int):
    """The bulk build of ``batches`` into ``pl`` (zeroed first) in the
    engine's chunks, as planes.BulkChunk flushes them, with CUDA events
    around each pass of each chunk: {pass: ms summed over the build}, in
    BULK_PASSES order (the histograms of a chunk's batches, their level-1
    scatters, level 2's in-place tile sort, the apply). Each
    pass starts behind a sleep on the card long enough for the host to
    queue all its launches, so its events time the card, not the host's
    launch rate (a histogram launch takes about as long as its wrapper's
    host work). The wrappers' own glue (the tiles' scan of level 2 and
    the apply) is inside its pass; the tables' scan and the allocations
    are outside every pass."""
    import torch
    from commet_tpu_torch.core import planes
    k, device = PLANE_K, pl.device
    ns = planes.bulk_layout(k)[2]
    pl.zero_()
    ms = dict.fromkeys(BULK_PASSES, 0.0)
    events = []

    def timed(name, fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(PASS_SLEEP_CYCLES)
        start.record()
        out = fn()
        end.record()
        events.append((name, start, end))
        return out

    per = -(-chunk // planes.bulk_slots(batches[0], lpad, k))
    for i in range(0, len(batches), per):
        cut = [(b, lengths[:len(b)], True, lpad) for b in batches[i:i + per]]
        tables = timed("hist", lambda: [planes.bulk_histogram(*bt, k)
                                        for bt in cut])
        starts, cstart = planes.bulk_starts(torch.cat(tables))
        mid = torch.empty(4 * sum(planes.bulk_slots(bt[0], lpad, k)
                                  for bt in cut), dtype=torch.int32,
                          device=device)

        def scatter():
            row0 = 0
            for bt in cut:
                planes.bulk_scatter(mid, starts, row0, *bt, k)
                row0 += planes.bulk_blocks(bt[0])

        timed("scatter", scatter)
        del starts
        counts = torch.zeros(4 * ns, dtype=torch.int64, device=device)
        table = planes.bulk_table(mid, k)
        timed("refine", lambda: planes.bulk_refine(mid, table, counts,
                                                   cstart, k))
        timed("apply", lambda: planes.bulk_apply(pl, mid, table, counts,
                                                 cstart, k))
        del mid, table
    torch.cuda.synchronize()
    for name, start, end in events:
        ms[name] += start.elapsed_time(end)
    return ms


def _bulk_micro(batches, lengths, lpad: int) -> dict:
    """What binds a scatter, measured alone: the decode rate (the level-1
    roll of every batch computing each window's four coarse bins and
    entries and storing nothing, csrc/planes.cu commet_bulk_decode, timed
    over all batches by CUDA events) and the rate of one batch's count of
    4-byte stores (4 a window slot) written as runs of 1, 4, 8, 32 and 128
    consecutive words at pseudo-random starts in the first half of a
    2 GiB buffer (commet_store_runs)."""
    import ctypes
    import torch
    from commet_tpu_torch.core import _cuda, planes
    k, device = PLANE_K, batches[0].device
    lib = _cuda.load("planes")
    nbins, rb = planes.bulk_bins(k)[0], planes.bulk_layout(k)[3]
    sink = torch.zeros(8 * planes.bulk_blocks(batches[0]), dtype=torch.int32,
                       device=device)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def decode(b):
        err = lib.commet_bulk_decode(
            planes._ptr(sink), nbins, rb,
            *planes._batch_args(b, lengths[:len(b)], True, lpad), k, stream)
        if err:
            raise RuntimeError(f"commet_bulk_decode: cudaError {err}")

    decode(batches[0])  # warm-up
    decode_ms = _events_ms([lambda b=b: decode(b) for b in batches])
    windows = len(batches) * len(batches[0]) * (READ_LEN - k + 1)
    n = 4 * len(batches[0]) * (READ_LEN - k + 1)
    words = 1 << 29
    out = torch.empty(words, dtype=torch.int32, device=device)
    runs = {}
    for run in (1, 4, 8, 32, 128):
        def store(run=run):
            err = lib.commet_store_runs(planes._ptr(out), words, n,
                                        run.bit_length() - 1, stream)
            if err:
                raise RuntimeError(f"commet_store_runs: cudaError {err}")
        got = cuda_ms(store, 5)
        runs[run] = {"ms": got, "entries_per_s": n / got * 1e3}
    del out
    torch.cuda.empty_cache()
    return {"decode_ms_batch": decode_ms / len(batches),
            "decode_windows_per_s": windows / decode_ms * 1e3,
            "decode_batches": len(batches), "stores": n,
            "store_runs": runs}


def phase_bulk_default_fill(pl, batches, lengths, lpad: int,
                            fill_ms: float) -> dict:
    """Phase 14's bulk build (K9) of the default partition whose batches
    the atomic fill built into ``pl`` in ``fill_ms``: first what binds a
    scatter alone (_bulk_micro); the whole build in the engine's chunks
    (engine.BULK_CHUNK_WIDE window slots) timed by the host clock and CUDA
    events, planes equal to ``pl``; each kernel's ms a launch from CUDA
    events around its whole passes (_bulk_passes, planes equal again)
    beside its bound (the bytes of its launches: the histogram the batches
    read and the tables written; level 1 the batches read, the starts read
    and the entries written; level 2 the entries read and written once,
    its table of slice starts written (2 B a slice start, spr + 1 a tile
    of this run's tiles) and the fine counts read and written; the apply
    the entries, the table and the fine counts read and each plane word of
    a fine bin that holds entries read and written once a chunk); the
    first chunk's kernels against their plain versions (_bulk_chunk_check)
    and the plain versions timed, one batch or one chunk; the library
    yardsticks: torch.bincount of one batch's (block, coarse bin) ids for
    the histogram, torch.sort of the first chunk's four planes' keys for
    the scatter, a stable torch.sort of its entries' (tile, slice) int32
    keys for level 2 (the same order); the build again beside the two
    resident sets with the cohorts' chunk (engine.BULK_CHUNK_BESIDE),
    equal, with the peak of each build; the faster route."""
    import torch
    from commet_tpu_torch.core import keys, planes
    from commet_tpu_torch.engine import engine
    k, device = PLANE_K, pl.device
    chunk = engine.BULK_CHUNK_WIDE
    _sb, sw, ns, _rb = planes.bulk_layout(k)
    nbins, spr = planes.bulk_bins(k)
    micro = _bulk_micro(batches, lengths, lpad)
    bulk = planes.alloc_planes(k, device)
    stats = {"entries": 0, "bins": 0, "tiles": 0, "chunks": 0}
    _bulk_fill(bulk, batches, lengths, lpad, chunk, stats)  # warm-up
    if not torch.equal(bulk, pl):
        raise AssertionError("the bulk build's planes differ from the "
                             "atomic fill's")
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    wall_s, ms = _bulk_fill(bulk, batches, lengths, lpad, chunk)
    peak = torch.cuda.max_memory_allocated()
    if not torch.equal(bulk, pl):
        raise AssertionError("the timed bulk build differs from the atomic "
                             "fill")
    for _attempt in range(PASS_TRIES):
        pass_ms = _bulk_passes(bulk, batches, lengths, lpad, chunk)
        if not torch.equal(bulk, pl):
            raise AssertionError("the bulk build pass by pass differs from "
                                 "the atomic fill")
        if sum(pass_ms.values()) <= PASS_SUM_SLACK * ms:
            break
    else:
        raise AssertionError(
            f"the bulk passes' events sum to {sum(pass_ms.values()):.3f} ms "
            f"against the whole build's {ms:.3f} ms in {PASS_TRIES} tries: "
            f"a pass's launches outran the card's sleep ({pass_ms})")
    n_batches, n_chunks = len(batches), stats["chunks"]
    launches = [n_batches, n_batches, n_chunks, n_chunks]
    batch_bytes = sum(b.numel() * 4 + len(b) * 4 for b in batches)
    blocks = sum(-(-len(b) // planes.BULK_BLOCK_READS) for b in batches)
    table_bytes = 4 * nbins * blocks
    entry_bytes = 4 * stats["entries"]  # 4 B an entry, 4 entries a window
    fine_bytes = 8 * 4 * ns * n_chunks
    starts_bytes = 2 * (spr + 1) * stats["tiles"]  # level 2's tables
    bounds = [bound_ms(batch_bytes + table_bytes),
              bound_ms(batch_bytes + 2 * table_bytes + entry_bytes),
              bound_ms(2 * entry_bytes + starts_bytes + 2 * fine_bytes),
              bound_ms(entry_bytes + starts_bytes + fine_bytes
                       + 2 * 4 * sw * stats["bins"])]

    # the first chunk: each kernel against its plain version, the plain
    # versions timed, and the library yardsticks
    first = [(b, lengths[:len(b)], True, lpad) for b in batches[:-(
        -chunk // planes.bulk_slots(batches[0], lpad, k))]]
    check = planes.alloc_planes(k, device)
    _bulk_chunk_check(check, first, k)
    del check
    bt0 = first[0]
    table = planes.bulk_histogram(*bt0, k)
    starts, _cs = planes.bulk_starts(table)
    mid = torch.empty(4 * planes.bulk_slots(bt0[0], lpad, k),
                      dtype=torch.int32, device=device)
    plain_ms = [cuda_ms(lambda: planes.bulk_histogram_plain(*bt0, k), 3),
                cuda_ms(lambda: planes.bulk_scatter_plain(
                    mid, starts, 0, *bt0, k), 3)]
    block, cbin, _e = planes._coarse_entries(*bt0, k)
    ids = block * nbins + cbin
    hist_library_ms = cuda_ms(lambda: torch.bincount(
        ids, minlength=table.numel()), 10)
    del block, cbin, _e, ids, mid, starts
    tables = torch.cat([planes.bulk_histogram(*bt, k) for bt in first])
    starts, cstart = planes.bulk_starts(tables)
    mid = torch.empty(4 * sum(planes.bulk_slots(bt[0], lpad, k)
                              for bt in first), dtype=torch.int32,
                      device=device)
    row0 = 0
    for bt in first:
        planes.bulk_scatter(mid, starts, row0, *bt, k)
        row0 += planes.bulk_blocks(bt[0])
    del starts
    # a stable sort of the chunk's (tile, slice) keys: level 2's order
    tile_keys = planes.bulk_tile_keys(mid, cstart, k).to(torch.int32)
    torch.sort(tile_keys[:1 << 20], stable=True)  # warm-up
    tile_sort_ms = _events_ms([lambda: torch.sort(tile_keys, stable=True)])
    n_tile_keys = tile_keys.numel()
    del tile_keys
    torch.cuda.empty_cache()
    table = planes.bulk_table(mid, k)
    counts = torch.zeros(4 * ns, dtype=torch.int64, device=device)
    planes.bulk_refine_plain(mid, table, counts, cstart, k)  # warm-up
    plain_ms.append(_events_ms([lambda: planes.bulk_refine_plain(
        mid, table, torch.zeros_like(counts), cstart, k)]))
    torch.cuda.empty_cache()
    target = planes.alloc_planes(k, device)
    planes.bulk_apply_plain(target, mid, table, counts, cstart, k)  # warm-up
    plain_ms.append(_events_ms([lambda: planes.bulk_apply_plain(
        target, mid, table, counts, cstart, k)]))
    del target, mid, table, counts
    torch.cuda.empty_cache()
    tagged = []
    for bt in first:
        a, b = keys.index_keys(keys.unpack_codes_clean(bt[0], bt[1], lpad), k)
        tagged += [(p << k) | key
                   for p, key in enumerate(planes.four_plane_keys(a, b))]
    tagged = torch.cat(tagged)
    torch.sort(tagged[:1 << 20])  # warm-up
    sort_ms = _events_ms([lambda: torch.sort(tagged)])
    n_sorted = tagged.numel()
    del tagged
    torch.cuda.empty_cache()

    # a set built beside the two resident sets with the cohorts' chunk
    half = planes.alloc_planes(k, device)
    half_held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    half_wall, half_ms = _bulk_fill(half, batches, lengths, lpad,
                                    engine.BULK_CHUNK_BESIDE)
    half_peak = torch.cuda.max_memory_allocated()
    if not torch.equal(half, pl):
        raise AssertionError("the bulk build with the cohorts' chunk "
                             "differs from the atomic fill")
    del half, bulk
    torch.cuda.empty_cache()
    library = [hist_library_ms, sort_ms, tile_sort_ms, None]
    kernels = {}
    for key, count, bound, plain, lib_ms in zip(
            BULK_PASSES, launches, bounds, plain_ms, library):
        kernels[key] = {"max_abs_err": 0, "ms": pass_ms[key] / count,
                        "plain_ms": plain, "bound_ms": bound / count,
                        "library_ms": lib_ms}
    return {"wall_s": wall_s, "ms": ms, "fill_ms": fill_ms,
            "chunk": chunk, "chunks": n_chunks,
            "windows": stats["entries"] // 4, "bins": stats["bins"],
            "tiles": stats["tiles"], "tile_keys": n_tile_keys,
            "kernels": kernels, "totals": pass_ms, "passes_ms": sum(
                pass_ms.values()), "bounds": bounds, "launches": launches,
            "micro": micro, "first_batches": len(first), "sort_ms": sort_ms,
            "sorted": n_sorted, "held": held, "peak": peak,
            "beside_chunk": engine.BULK_CHUNK_BESIDE, "half_wall_s": half_wall,
            "half_ms": half_ms, "half_held": half_held,
            "half_peak": half_peak,
            "faster": "bulk" if ms < fill_ms else "per-batch",
            "default": "bulk"}


def run_phase_default_fill(device, rng) -> dict:
    """Phase 14: runs phase_default_fill in a temporary directory (its
    fasta files, about 3.5 GB, go with it) and phase_default_fill_kernels,
    logs their lines and the K7 and K9 figures."""
    import torch
    from commet_tpu_torch.core import planes
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        pair = phase_default_fill("cuda", rng, tmp)
    torch.cuda.empty_cache()
    sp, tr = pair["split"], pair["trace"]
    log(f"phase 14 default fill: index_and_search -k {PLANE_K} -t {T} on "
        f"2 x {DEFAULT_FILL_READS} reads x {READ_LEN} bp (set2 in set1, "
        f"66 bp N-free fragments in set 2's even reads), one partition at "
        f"fill {pair['fill']:.5f}, plane fills "
        f"{[round(f, 5) for f in pair['fills4']]}; wall "
        f"{pair['wall_s']:.3f} s (sets made in {pair['make_s']:.3f} s "
        f"before it): parse {sp['parse']:.3f} s, index {sp['index']:.3f} s, "
        f"search {sp['search']:.3f} s (host pack {sp['host_pack']:.3f} s, "
        f"dispatch waited {sp['host_block']:.3f} s), rest {sp['rest']:.3f} "
        f"s; {pair['rate']:.0f} reads/s searched; {pair['counters']}; "
        f"{_plane_names(planes).rsplit('/', 1)[0]}/join launches "
        f"{pair['launches']}; "
        f"max_memory_allocated {pair['peak']} B; every fragment read "
        f"tagged, {pair['chance']} chance tags (expected "
        f"{pair['chance_expected']:.1f} from the planes' hit rates on "
        f"{PLANE_BATCH} untagged reads' windows "
        f"{[round(f, 5) for f in pair['hit_rates']]}, "
        f"{pair['chance_expected_fills']:.1f} from the fills), each a member "
        f"of set 1's planes built again under the plain probe, and "
        f"{PLANE_BATCH} untagged reads not ({pair['check_s']:.3f} s)")
    walls = pair["cut_walls"]
    log(f"phase 14 trace: set 2's first {TRACE_READS} reads against set 1 "
        f"(full fill): COMMET_TPU_PROFILE call {walls['profiled']:.3f} s, "
        f"trace of {pair['trace_bytes']} B, {tr['device_events']} device "
        f"events, card busy {tr['busy_ms']:.3f} ms = "
        f"{100 * tr['busy_share']:.2f}% of the unprofiled prefetch call's "
        f"wall; top device "
        f"operations (ms) "
        + ", ".join(f"{name} {ms:.3f}" for name, ms in tr["top"])
        + f"; unprofiled walls: prefetch {walls['prefetched']:.3f} s, "
        f"COMMET_TPU_PREFETCH=0 {walls['inline']:.3f} s; equal tags")
    fk = run_phase_default_fill_kernels(device, t0)
    return {"pair": {key: val for key, val in pair.items()
                     if key != "trace"}, "trace": tr, "kernels": fk}


def run_phase_default_fill_kernels(device, t0: float) -> dict:
    """Phase 14's kernels at 11.6% (phase_default_fill_kernels): logs
    their lines, the bulk build's and the K7 and build decisions; ``t0``
    the phase's start."""
    import torch
    fk = phase_default_fill_kernels(device, 33)
    torch.cuda.empty_cache()
    ld, ml = fk["loads"], fk["multi_loads"]
    total = ld["a"] + ld["bcd"]
    skip_share = ld["skippable"] / total
    pb, mb, bk = fk["probe"], fk["multi"], fk["bulk"]
    log(f"phase 14 kernels at 11.6%: {DEFAULT_FILL_READS} random reads "
        f"({fk['build_windows']} windows) built into a 4 GiB set in "
        f"{fk['fill_s']:.3f} s ({fk['fill_ms']:.3f} ms by CUDA events), "
        f"plane fills {[round(f, 5) for f in fk['fills']]}; a "
        f"{PLANE_BATCH}-read batch on the filled set equal to the plain "
        f"version's, " + _kernel_figures(fk["build"])
        + f" (kernel ms the fill's mean a batch; {fk['build_sectors']} "
        f"distinct sectors); probe of phase 9's batch "
        f"equal to the plain version's, " + _kernel_figures(pb)
        + f", {ld['a']} A and {ld['bcd']} B/C/D plane loads on "
        f"{fk['sectors']} distinct sectors, {fk['a_hits_per_strand']:.3f} "
        f"A hits per read and strand, {fk['tagged_random']} random reads "
        f"tagged; probe_multi at S = 3 (tags per slot {fk['multi_tagged']}) "
        f"equal to its plain version's, " + _kernel_figures(mb)
        + f", {ml['a']} A and {ml['bcd']} B/C/D loads on "
        f"{fk['multi_sectors']} distinct sectors")
    mc = bk["micro"]
    log(f"phase 14 bulk build (K9), what binds a scatter: the level-1 roll "
        f"alone (every window's four coarse bins and entries, nothing "
        f"stored) {mc['decode_ms_batch']:.4f} ms a {PLANE_BATCH}-read batch "
        f"over {mc['decode_batches']} batches, "
        f"{mc['decode_windows_per_s']:.4g} windows/s; {mc['stores']} 4-byte "
        f"stores (one batch's entries) in runs of "
        + ", ".join(f"{run}: {fig['ms']:.4f} ms ({fig['entries_per_s']:.4g}"
                    f"/s)" for run, fig in mc["store_runs"].items())
        + " consecutive words at pseudo-random starts")
    log(f"phase 14 bulk build (K9): the same {DEFAULT_FILL_READS} reads "
        f"({bk['windows']} windows) in chunks of {bk['chunk']} window slots "
        f"({bk['chunks']} chunks, {bk['bins']} fine bins holding entries, "
        f"{bk['tiles']} level-2 tiles) in "
        f"{bk['wall_s']:.3f} s, {bk['ms']:.3f} ms by CUDA events, planes "
        f"equal to the atomic fill's; pass by pass (CUDA events around each "
        f"pass, {bk['passes_ms']:.3f} ms in all, equal planes), ms and bound "
        f"ms of all launches: "
        + ", ".join(f"{key} {bk['totals'][key]:.3f} (bound {bound:.3f}, "
                    f"{100 * bound / bk['totals'][key]:.1f}%; {n} launches)"
                    for key, bound, n in zip(BULK_PASSES, bk["bounds"],
                                             bk["launches"]))
        + f"; per launch: "
        + "; ".join(f"{key} " + _kernel_figures(bk["kernels"][key])
                    + (f", library {bk['kernels'][key]['library_ms']:.4f}"
                       if bk["kernels"][key]["library_ms"] is not None
                       else "")
                    for key in BULK_PASSES)
        + f" (plain: one batch, one batch, the first chunk of "
        f"{bk['first_batches']} batches twice, each kernel equal to its "
        f"plain version there; library: torch.bincount of one batch's "
        f"(block, coarse bin) ids, torch.sort of that chunk's {bk['sorted']} "
        f"plane-tagged int64 keys, a stable torch.sort of its "
        f"{bk['tile_keys']} (tile, slice) int32 keys); "
        f"max_memory_allocated {bk['peak']} B ({bk['held']} B held before, "
        f"{bk['peak'] - bk['held']} B above); "
        f"beside them with the cohorts' chunk of {bk['beside_chunk']} slots: "
        f"{bk['half_wall_s']:.3f} s, {bk['half_ms']:.3f} ms, equal planes, "
        f"max_memory_allocated {bk['half_peak']} B ({bk['half_held']} B "
        f"held before, {bk['half_peak'] - bk['half_held']} B above)")
    log(f"phase 14 decisions: K7: {ld['skippable']} of the probe's {total} "
        f"plane loads are B/C/D loads past the {CASCADE_V} leftmost and "
        f"{CASCADE_V} rightmost A hits of their strand "
        f"({100 * skip_share:.2f}%; close under 15%: "
        f"{'close' if skip_share < 0.15 else 'queue'}); the build of one "
        f"default partition: bulk {bk['ms']:.3f} ms, per-batch atomic fill "
        f"{fk['fill_ms']:.3f} ms: faster {bk['faster']}, the engine's card "
        f"default {bk['default']} (Engine.uses_bulk_build) "
        f"({time.perf_counter() - t0:.3f} s for phase 14)")
    return fk


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
    from commet_tpu_torch.core import pack
    return (stream.join_membership, stream.join_membership_multi,
            planes.build_planes, planes.probe_planes,
            planes.probe_planes_multi, planes.build_planes_range,
            planes.probe_planes_part_a, planes.probe_planes_part,
            tfilter.class_counts_packed, planes.bulk_histogram,
            planes.bulk_scatter, planes.bulk_refine, planes.bulk_apply,
            pack.gather_pack)


def zero_counts(stream, planes):
    """Every kernel wrapper's launch count set to 0."""
    from commet_tpu_torch.core import filter as tfilter
    for fn in _kernel_fns(stream, planes, tfilter):
        fn.launches = 0


def _build_fns(planes):
    """The wrappers of the dense-plane build the card takes by default
    (Engine.uses_bulk_build): the bulk build's four."""
    return (planes.bulk_histogram, planes.bulk_scatter, planes.bulk_refine,
            planes.bulk_apply)


def _build_launches(planes) -> int:
    """Launches of the default build's kernels, the fewest of them."""
    return min(fn.launches for fn in _build_fns(planes))


def _plane_launches(planes):
    """Launches of the default build's kernels, of probe_planes and of
    probe_planes_multi."""
    return tuple(fn.launches for fn in _build_fns(planes)) + (
        planes.probe_planes.launches, planes.probe_planes_multi.launches)


def _plane_names(planes) -> str:
    return "/".join(fn.__name__ for fn in _build_fns(planes)) + (
        "/probe_planes/probe_planes_multi")


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


def run_phase_mesh_kernels(device) -> dict:
    """Phase 13.1: runs phase_mesh_kernels and logs its line."""
    import torch
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    mk = phase_mesh_kernels(device, 33)
    loads, sectors = mk["loads"], mk["sectors"]

    def probe(key, what):
        return (f"{_kernel_figures(mk[key])} per range launch, "
                f"{loads[what]} plane loads on {sectors[what]} distinct "
                f"sectors over the {MESH_N} ranges")

    log(f"phase 13.1 mesh kernels: k = {PLANE_K}, {MESH_N} word ranges; "
        f"ranged build of one {PLANE_BATCH}-read batch equal to the plain "
        f"version's and to commet_build_planes' planes, "
        f"{mk['build_entries']} atomics ({mk['build_words']} distinct words, "
        f"{mk['build_sectors']} distinct sectors) a batch, "
        + _kernel_figures(mk["build_range"])
        + f" per range launch; {PLANE_FILL_READS} reads built into the whole "
        f"set and the ranges in {mk['fill_s']:.3f} s; probes of the probe "
        f"batch equal to their plain versions, {mk['members']} member "
        f"windows, sharded tags = probe_planes' ({mk['tagged']} tagged): "
        f"pass A " + probe("probe_part_a", "a") + "; pass B/C/D "
        + probe("probe_part", "veto")
        + f"; two passes {mk['two_pass_ms']:.4f} ms a range (bound "
        f"{mk['two_pass_bound_ms']:.4f} ms, {sectors['needed']} distinct "
        f"sectors the result needs); the one-pass design's "
        f"{loads['every']} plane loads on {sectors['every']} distinct "
        f"sectors (bound {mk['one_pass_bound_ms']:.4f} ms a range); whole "
        f"sharded probe {mk['sharded_ms']:.4f} ms; "
        f"max_memory_allocated {torch.cuda.max_memory_allocated()} B "
        f"({time.perf_counter() - t0:.3f} s)")
    return mk


def run_phase_class_counts(device) -> dict:
    """Phase 13.1's class counts: runs phase_class_counts and logs its
    line."""
    t0 = time.perf_counter()
    cc = phase_class_counts(device, 33)
    log(f"phase 13.1 class counts: a dirty {PLANE_BATCH}-read batch of 128 "
        f"positions and {cc['large_reads']} dirty reads made on the card "
        f"equal to the plain version's (and the batch to numpy's); "
        + _class_counts_line(cc)
        + f"; filter_batch_device = the host filter {cc['filter_stats']} "
        f"(class_counts launches {cc['launches']}) "
        f"({time.perf_counter() - t0:.3f} s)")
    return cc


def run_phase_pack_kernel(device) -> dict:
    """Phase 13.1's gather and pack: runs phase_pack_kernel and logs its
    line."""
    t0 = time.perf_counter()
    gp = phase_pack_kernel(device, 18)
    log(f"phase 13.1 pack: {gp['reads']}-read batches of {READ_LEN} bp "
        f"gathered and packed on the card equal to the host's pack and to "
        f"the plain version's; "
        + "; ".join(f"{order} kernel {gp[order]['ms']:.4f} ms, wrapper "
                    f"{gp[order]['wrapper_ms']:.4f} ms, plain "
                    f"{gp[order]['plain_ms']:.4f} ms, host pack "
                    f"{gp[order]['host_ms']:.3f} ms, bound "
                    f"{gp[order]['bound_ms']:.4f} ms"
                    for order in ("in_order", "shuffled"))
        + f"; {gp['upload_bytes']} B uploaded from pageable memory at "
        f"{gp['upload_GB_per_s']:.2f} GB/s "
        f"({time.perf_counter() - t0:.3f} s)")
    return gp


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
    mesh_kernels_only = args == ["--mesh-kernels"]
    class_counts_only = args == ["--class-counts"]
    default_fill_only = args == ["--default-fill"]
    bulk_build_only = args == ["--bulk-build"]
    pack_kernel_only = args == ["--pack-kernel"]
    if args and not (plane_kernels_only or join_kernels_only
                     or mesh_kernels_only or class_counts_only
                     or default_fill_only or bulk_build_only
                     or pack_kernel_only):
        print("usage: chip_smoke.py [--plane-kernels | --join-kernels | "
              "--mesh-kernels | --class-counts | --default-fill | "
              "--bulk-build | --pack-kernel]", file=sys.stderr)
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
    from commet_tpu_torch.core import _cuda, pack, planes, stream
    from commet_tpu_torch.core import filter as tfilter
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

    if mesh_kernels_only:
        log(json.dumps(run_phase_mesh_kernels(device)))
        return 0

    if default_fill_only:
        log(json.dumps(run_phase_default_fill(device,
                                              np.random.default_rng(14)),
                       default=str))
        return 0

    if bulk_build_only:
        fk = run_phase_default_fill_kernels(device, time.perf_counter())
        log(json.dumps({key: fk[key] for key in ("fill_ms", "build",
                                                 "bulk")}))
        return 0

    if pack_kernel_only:
        log(json.dumps(phase_pack_kernel(device, 18)))
        return 0

    if class_counts_only:
        cc = run_phase_class_counts(device)
        log(json.dumps({key: cc[key] for key in ("batch", "large",
                                                 "large_reads")}))
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
        packs = pack.gather_pack.launches
        if launches == 0 or launches_multi == 0 or packs == 0:
            raise AssertionError(f"the main path launched join {launches}, "
                                 f"join_multi {launches_multi} and "
                                 f"gather_pack {packs} times")
        for what, secs in calls:
            log(f"  {what}: {secs:.3f} s")
        log(f"phase main path: commet -k {K} -t {T} on 4 x {SET_READS} "
            f"reads, amortized schedule, S up to {s_max}, matrix_plain rows "
            f"{plain.tolist()}, join launches {launches}, join_multi "
            f"launches {launches_multi}, plane kernel launches "
            f"{stream_planes}, gather_pack launches {packs}, "
            f"max_memory_allocated {peak} B "
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
    chunks = phase_bulk_edges(device, np.random.default_rng(10))
    log(f"phase bulk edges: bulk_histogram, bulk_scatter, bulk_refine "
        f"(level 2 in place) and bulk_apply equal to their plain "
        f"versions and BulkChunk to the per-batch build and "
        f"bulk_build_planes_plain at k in {EDGE_K} on the same reads and a "
        f"batch skewed into plane D's last region in {chunks} chunks (three "
        f"2,000-read batches a chunk, a smaller last one, one with no "
        f"complete window) "
        f"({time.perf_counter() - t0:.3f} s)")
    torch.cuda.empty_cache()
    mk = run_phase_mesh_kernels(device)
    torch.cuda.empty_cache()
    cc = run_phase_class_counts(device)
    torch.cuda.empty_cache()
    gp = run_phase_pack_kernel(device)
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.reset_peak_memory_stats()
        zero_counts(stream, planes)
        t0 = time.perf_counter()
        calls, s_max, plain, peak = phase_main_path(
            "cuda", rng, tmp, PLANE_SET_READS, PLANE_K, "plane cohorts",
            2 * PLANE_K, n_free_fragments=True)
        plane_counts = _plane_launches(planes)
        main_planes = {fn.__name__: fn.launches for fn in _kernel_fns(
            stream, planes, tfilter)}
        if min(plane_counts) == 0 or main_planes["gather_pack"] == 0:
            raise AssertionError(f"the planes main path launched "
                                 f"{_plane_names(planes)} {plane_counts} "
                                 f"and gather_pack "
                                 f"{main_planes['gather_pack']} times")
        for what, secs in calls:
            log(f"  {what}: {secs:.3f} s")
        log(f"phase planes main path: commet -k {PLANE_K} -t {T} on 4 x "
            f"{PLANE_SET_READS} reads, plane cohorts, S up to {s_max}, "
            f"matrix_plain rows {plain.tolist()}, {_plane_names(planes)} "
            f"launches {plane_counts}, join/join_multi "
            f"launches {stream.join_membership.launches}/"
            f"{stream.join_membership_multi.launches}, gather_pack launches "
            f"{main_planes['gather_pack']}, max_memory_allocated "
            f"{peak} B ({time.perf_counter() - t0:.3f} s)")
        torch.cuda.empty_cache()
        zero_counts(stream, planes)
        t0 = time.perf_counter()
        passes, same = phase_compare_reads("cuda", tmp)
        cr_counts = (_build_launches(planes), planes.probe_planes.launches,
                     stream.join_membership.launches)
        build_names = "/".join(fn.__name__ for fn in _build_fns(planes))
        if min(cr_counts) == 0:
            raise AssertionError(f"compare_reads launched {build_names} (the "
                                 f"fewest)/probe_planes/join {cr_counts} "
                                 "times")
        for what, wall, pack, peak, (builds, joins) in passes:
            log(f"  compare_reads pass {what}: {wall:.3f} s, host pack "
                f"{pack:.3f} s of the last search, max_memory_allocated "
                f"{peak} B, {build_names} (the fewest)/join launches "
                f"{builds}/{joins}")
        log(f"phase compare_reads: -k {PLANE_K} -t {T} on sets 1 and 2 of 4 "
            f"x {PLANE_SET_READS} reads with the driver's filters, pass 1 on "
            f"the planes, passes 2 and 3 on sorted indexes; "
            f"{' and '.join(same)} equal to the driver's; {build_names} (the "
            f"fewest)/probe_planes/join launches {cr_counts} "
            f"({time.perf_counter() - t0:.3f} s)")
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        mesh = smoke_mesh(device, MESH_N)
        pair = phase_mesh_pair(device, tmp, PLANE_K, [
            ("dp", {"mesh": mesh, "mesh_mode": "dp"}),
            ("plane", {"mesh": mesh, "mesh_mode": "plane"})])
        mesh_launches = pair["plane"][3]
        # a mesh never takes the bulk build: dp builds batch by batch
        dp_builds = pair["dp"][3].get("build_planes", 0)
        if not pair["dp"][3].get("probe_planes") or not dp_builds or min(
                mesh_launches.get("build_planes_range", 0),
                mesh_launches.get("probe_planes_part_a", 0),
                mesh_launches.get("probe_planes_part", 0)) == 0:
            raise AssertionError(f"mesh launches {pair}")
        log(f"phase 13.3 mesh planes: set2 in set1 of phase 10 (k = "
            f"{PLANE_K}, {PLANE_SET_READS} reads, planes) with mesh_mode dp "
            f"and plane ({MESH_N} word shards of "
            f"{planes.plane_bytes(PLANE_K) // MESH_N} B) on {mesh} equal to "
            f"the single-device call (.bv bytes, {pair['single'][1]}); "
            + _mesh_walls(pair) + f" ({time.perf_counter() - t0:.3f} s)")

    torch.cuda.empty_cache()
    bulk = run_phase_default_fill(device, np.random.default_rng(14))[
        "kernels"]["bulk"]

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
         "replaces": replaces, "launches": main_planes[name] or dp_builds,
         **pk[key], **NO_LIBRARY}
        for name, replaces, key in zip(
            ("build_planes", "probe_planes", "probe_planes_multi"),
            (BUILD_REPLACES, PROBE_REPLACES, PROBE_MULTI_REPLACES),
            ("build", "probe", "multi"))] + [
        {"name": name, "route": "cuda", "source": source,
         "replaces": replaces, "launches": launched, **mk[key],
         **NO_LIBRARY}
        for name, source, replaces, launched, key in (
            ("build_planes_range", PLANES_SOURCE, BUILD_RANGE_REPLACES,
             mesh_launches["build_planes_range"], "build_range"),
            ("probe_planes_part_a", PLANES_SOURCE, PROBE_PART_A_REPLACES,
             mesh_launches["probe_planes_part_a"], "probe_part_a"),
            ("probe_planes_part", PLANES_SOURCE, PROBE_PART_REPLACES,
             mesh_launches["probe_planes_part"], "probe_part"))] + [
        {"name": "class_counts", "route": "cuda", "source": FILTER_SOURCE,
         "replaces": CLASS_COUNTS_REPLACES, "launches": cc["launches"],
         **{key: cc["batch"][key] for key in ("max_abs_err", "ms", "plain_ms",
                                             "bound_ms")},
         **NO_LIBRARY}] + [
        {"name": name, "route": "cuda", "source": PLANES_SOURCE,
         "replaces": replaces, "launches": main_planes[name],
         **bulk["kernels"][key], "bound_by": "bytes"}
        for name, replaces, key in (
            ("bulk_histogram", BULK_HIST_REPLACES, "hist"),
            ("bulk_scatter", BULK_SCATTER_REPLACES, "scatter"),
            ("bulk_refine", BULK_SCATTER_REPLACES, "refine"),
            ("bulk_apply", BULK_APPLY_REPLACES, "apply"))] + [
        {"name": "gather_pack", "route": "cuda", "source": PACK_SOURCE,
         "replaces": PACK_REPLACES, "launches": main_planes["gather_pack"],
         **{key: gp["in_order"][key] for key in ("max_abs_err", "ms",
                                                 "plain_ms", "bound_ms")},
         **NO_LIBRARY}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
