// Dense-plane build and probe, hand-written for Hopper (sm_90a).
//
// Four bit planes of 2^k bits each (A = keya, B = keyb, C = keya ^ keyb,
// D = keya | keyb, reference include/bloom_filter.h:37-43) as one array of
// 4 * plane_words uint32 words; a key's word is key >> 5 and its bit key & 31
// (keys are whole 64-bit values for k <= 36).
//
// Replaces, in commet_tpu/core/kernels.py:
//   - commet_build_planes: K4, build_chunk / build_chunk_packed(_clean) /
//     _build_chunk_impl (kernels.py:670-746), the per-batch build. The
//     TPU builds by sort -> segmented OR -> gather of the existing bits ->
//     scatter-add, because it has no scatter-OR; here every complete forward
//     window does one atomicOr per plane.
//   - commet_bulk_hist, commet_bulk_scatter, commet_bulk_apply: K9, the bulk
//     build (bulk_plane_sorted / bulk_scatter_set / bulk_or_plane,
//     kernels.py:771-827, driven by Engine._build_planes_bulk), which writes
//     each plane word once per chunk of windows. The TPU sorts each plane's
//     (word, mask) stream, ORs runs of equal words and scatter-sets them,
//     because its scatters with gather descriptors are slow. Here a
//     counting sort into plane slices does it without a full sort (below).
//   - commet_probe_planes: K5, search_batch(_fwd/_rc)(_packed) with
//     _membership and greedy_ge (kernels.py:295-451), and with them K2
//     (unpack_codes(_clean), 88-96, 645-653) and K3 (window_keys, 190-260):
//     each window's keys are cut from the packed words in registers, so no
//     [B, L] codes or [B, W] keys exist.
//   - commet_probe_planes_multi: the same probe of one batch against S plane
//     sets in one launch, which replaces what probe_cascade2_multi_*
//     (kernels.py:604-642) serve in the plane cohorts. The cascade (K7)
//     exists because the TPU's gather rate is its wall; its final tags equal
//     the full probe's, which this probe gives in one pass.
// Both probe kernels call one __device__ function (probe_warp), so S = 1 and
// S > 1 cannot drift apart.
// Replaces, in commet_tpu/parallel/sharded.py (K11, planes sharded on the
// word axis, shard d holding words [lo, lo + wl) of each plane as its own
// [4 * wl] array):
//   - commet_build_planes_range: build_search_step's _build (sharded.py:
//     114-134), which sorts, OR-segments and scatter-adds the windows whose
//     word lies in the shard's range; here the build kernel's atomics, each
//     made only where its word lies in the range (a template flag, so the
//     single-set build compiles as before);
//   - _search's _local_membership and the psum of the per-plane hits
//     (sharded.py:91-99,136-158), in two passes over windows packed 32 to
//     a word ([b, 2, ceil(wmax / 32)], bit w % 32 of word w / 32):
//     commet_probe_planes_part_a, pass A: the windows whose plane-A word
//     lies in the range and whose A bit is set; the caller ORs the shards'
//     words (a word lives on one shard), which is exactly "A is set";
//     commet_probe_planes_part, pass B/C/D: given the merged A words, a
//     lane whose window has A set loads its in-range B, C and D words
//     together and vetoes the window where one of those bits is clear;
//     lanes without A load nothing. A member is A & ~(OR of the vetoes).
//     The ranged probe has no greedy skip (the count needs every shard's
//     bits), so its loads set much of its time: plane A first means B, C
//     and D are loaded only where A hits, about a tenth of the windows; the
//     passes write their words with fire-and-forget atomicOr (or_word).
//
// Input batch: codes2 [b, nw2] words, base p at bits 2*(p%16) of word p/16
// (A=0 C=1 G=2 T=3); then either (clean) lengths [b] int32, base p valid iff
// p < lengths[row], or validity words [b, nwv], base p valid iff bit p%32 of
// word p/32. Bases at or past `length` (the batch's padded length) are never
// read. A window is complete when its k bases are all valid: an invalid base
// ends every window that holds it (the reset of search_reads.h:49-63).
//
// In the probes windows, not reads, are the unit of work: window_bits cuts
// window w's k bases out of the packed row (at most four code words and
// three validity words, read through L1: the lanes of a warp read the same
// row) and splits them into the high-bit and low-bit strings xa, xb (bit j
// = base w + j). The forward key is the string reversed (MSB-first, base w
// at bit k-1, as the build's rolling key has it); the reverse-complement
// key is its complement as it stands (bit j = complement of base w + j).
//
// What bounds them, and what the design does about it:
//   - the build: random atomics into a multi-GB array (4 GiB at k = 33),
//     four per complete window, each a sector read and write at L2 and DRAM;
//     their results are unused, so they issue as fire-and-forget reductions,
//     and one thread per read keeps enough of them in flight: on an H100 it
//     takes within 5% of PyTorch's own index_add_ at the same addresses.
//     Planes A, B and C take most of it (plane D's skewed keys mostly hit
//     the L2); a thread per window over a tile of reads in shared memory
//     measured no faster, and loading a word to skip the atomic when its
//     bit is set saved nothing on D and cost time on every plane (PERF.md).
//   - the probe: random 4-byte loads from multi-GB planes that the 50 MB L2
//     cannot hold; a one-thread-per-read loop has one load in flight at a
//     time. Here a warp takes one read and walks its windows 32 at a time:
//     each lane tests one window, so a chunk's 32 plane-A loads go out
//     together; __ballot_sync gives the chunk's A hits, and the greedy
//     count (kernels.py _greedy_count: the next hit is the lowest member at
//     or past `allow`, then allow = hit + k, stopping at t) resolves them
//     lowest first, the candidate's lane loading B, C and D. Windows below
//     `allow` load nothing; the plane-A loads a window-by-window skip would
//     have saved are bounded by one chunk. The reverse strand is read only
//     for slots whose forward count stays below t (search_reads.h:64-83).
//     In the grouped probe one warp serves G slots of one read (G from S,
//     at most kMaxGroup): a chunk's keys are cut once and every slot's
//     loads go out together.
//     Measured on an H100, both probes run at the card's random-gather rate
//     (PERF.md): their time follows the count of plane loads, which is why
//     no load is issued that the greedy count rules out.
//   - the bulk build: a chunk's windows (2^27 window slots at COMMET's
//     default k = 33) against 4 GiB of planes. The per-batch build's random
//     atomics each cost a sector read and write in device memory (22% of
//     their bytes bound). Here a plane is cut into slices of S = 2^14
//     words (64 KiB of shared memory, two apply blocks an SM): a window's
//     bit in plane p is the entry key & (2^19 - 1) of fine bin p * nslices
//     + (key >> 19), and commet_bulk_apply runs a block per fine bin, loads
//     the slice once, ORs the bin's entries in with shared-memory atomics
//     and stores it once. What is left is grouping a chunk's entries by
//     fine bin (65,536 of them at k = 33). One 4-byte store an entry at a
//     scattered place runs at the card's scattered-store rate, a sector
//     touched a store (measured on an H100, PERF.md: 13.6G stores/s in runs
//     of 1, 91G in runs of 8, 258G in runs of 128), so no pass stores
//     entries one by one: the grouping is a two-level partition, each level
//     ranking its entries in shared memory and storing them with
//     consecutive lanes. Level 1 goes into coarse bins, regions of R = 2^22
//     words (16 MiB; the whole plane below k = 27, at least a slice), 64 a
//     plane and 256 bins at k = 33, each entry region-relative (27 bits);
//     level 2 orders each region's entries by its R / S slices, 256 where
//     k >= 27. 256 x 256 balances the two levels' runs at COMMET's default
//     k; 4 MiB regions ORed in with L2 atomics in region order were slower
//     (the L2's atomic rate, not the plane's bytes, bound them), and so
//     were 128 KiB slices.
//       commet_bulk_hist (per batch): a block of 256 reads (a thread a
//     read) rolls their windows once and counts all four planes' coarse
//     bins in shared memory; it writes its row of a [blocks, bins] table,
//     no global atomic.
//       The caller scans the chunk's tables in (bin, batch, block) order:
//     each (batch, block, bin) gets the index of its run in `mid`, so mid
//     holds each coarse bin's entries contiguously, with no atomic at all.
//       commet_bulk_scatter (level 1, per batch): the same blocks over the
//     same reads roll each read once more, 16 positions a tile: a tile's
//     keys stay in registers, its entries (at most 16 x 4 x 256 = 16,384)
//     are counted per coarse bin, scanned and placed in shared memory,
//     then each bin's run is stored at its block's index by consecutive
//     lanes. Runs: a 100 bp read has 68 windows, so a block's 256 reads
//     give 69,632 entries in 5 tiles, about 54 entries (218 B) a (tile,
//     bin) run at 256 bins (a full tile, 64), and a block's run of one
//     region continues tile after tile (about 272 entries).
//       commet_bulk_refine (level 2, per chunk, one launch, in place): a
//     coarse bin's run in mid is cut into tiles of 16,384 entries (plane
//     D's skewed regions, a | b, take many tiles: about 18% of plane D's
//     entries lie in its last region). A block reads its tile once into
//     registers, ranks it by slice in shared memory and writes it back over
//     the same range with consecutive lanes: one read and one contiguous
//     write an entry, no second entry buffer (2.15 GB at a 2^27-slot
//     chunk), no counting launch, no scan of fine counts on the host side
//     and no global cursor. Slice s of a region becomes one run in each of
//     the region's tiles (about 90 runs of about 64 entries at k = 33);
//     the tile's slice starts (spr + 1 values of at most 16,384, uint16)
//     go to a table laid out per region as [slice][tile], so the apply
//     reads a slice's starts at consecutive tiles. An entry's slot comes
//     from a second shared-memory atomic on the scanned cursors, so a
//     block holds only its 16 entries a thread and two blocks share an SM,
//     one's loads and stores overlapping the other's ranking. Measured on
//     an H100 (PERF.md, phase 14's first chunk, in turns): this design
//     1.54-1.58 ms a chunk; keeping the counting atomic's rank in
//     registers (one block an SM) 1.81-1.85, in shared memory 1.62-1.81;
//     aggregating a warp's entries of one slice with __match_any_sync
//     before the atomic 3.7-6.3 (it costs more than the contention it
//     saves: outside plane D few lanes of a warp share one of 256 slices).
//     Level 2 went from 2.63 ms a chunk (two launches) to 1.41.
//       commet_bulk_apply reads each slice's runs tile by tile, each warp
//     taking whole runs, tiles strided by warp, four entries a lane in
//     flight: about 90 runs of 64 entries a slice cost 0.7% against one
//     run (3.90 ms a chunk against 3.87, 77% of its bound).
//     Per chunk: each batch rolled twice, the entries written twice and
//     read twice, the table written and read once, each plane word of a
//     bin that holds entries read and written once.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroup = 8;  // most slots one warp of the grouped probe
                              // serves (its template instances: 1 .. 8)

struct Batch {
  const uint32_t* codes2;  // [b, nw2]
  const uint32_t* aux;     // lengths [b] (clean) or validity words [b, nwv]
  int64_t nw2;
  int64_t nwv;
  int clean;
  int64_t b;
  int length;
};

__device__ __forceinline__ uint64_t low_mask(int k) {
  return k >= 64 ? ~0ull : ((1ull << k) - 1);
}

// Bits 0, 2, 4, .. 62 of v gathered into bits 0 .. 31.
__device__ __forceinline__ uint64_t even_bits(uint64_t v) {
  uint64_t x = v & 0x5555555555555555ull;
  x = (x | (x >> 1)) & 0x3333333333333333ull;
  x = (x | (x >> 2)) & 0x0F0F0F0F0F0F0F0Full;
  x = (x | (x >> 4)) & 0x00FF00FF00FF00FFull;
  x = (x | (x >> 8)) & 0x0000FFFF0000FFFFull;
  return (x | (x >> 16)) & 0x00000000FFFFFFFFull;
}

// Positions [0, end) of read `row` are read: the padded length, `limit`
// and, for a clean batch, the read's length.
__device__ __forceinline__ int row_end(const Batch& bt, int64_t row,
                                       int limit) {
  int end = bt.length < limit ? bt.length : limit;
  if (bt.clean) {
    const int len = reinterpret_cast<const int32_t*>(bt.aux)[row];
    if (len < end) end = len;
  }
  return end;
}

// Window w of read `row` (bases w .. w+k-1): false unless they all lie in
// [0, end) and are valid; else xa / xb hold the bases' high / low code bits,
// bit j for base w + j. Reads only the words that hold those bases.
__device__ __forceinline__ bool window_bits(const Batch& bt, int64_t row,
                                            int end, int w, int k,
                                            uint64_t& xa, uint64_t& xb) {
  if (w < 0 || w + k > end) return false;
  const int last = w + k - 1;
  const uint64_t m = low_mask(k);
  if (!bt.clean) {
    const uint32_t* vd = bt.aux + row * bt.nwv;
    const int q = w >> 5, ql = last >> 5, sh = w & 31;
    const uint64_t lo = (uint64_t)vd[q] |
                        (q + 1 <= ql ? (uint64_t)vd[q + 1] << 32 : 0ull);
    const uint64_t v2 = q + 2 <= ql ? (uint64_t)vd[q + 2] : 0ull;
    const uint64_t v = sh ? ((lo >> sh) | (v2 << (64 - sh))) : lo;
    if ((v & m) != m) return false;
  }
  const uint32_t* c2 = bt.codes2 + row * bt.nw2;
  const int q = w >> 4, ql = last >> 4, sh = 2 * (w & 15);
  uint64_t lo = (uint64_t)c2[q] |
                (q + 1 <= ql ? (uint64_t)c2[q + 1] << 32 : 0ull);
  uint64_t hi = (q + 2 <= ql ? (uint64_t)c2[q + 2] : 0ull) |
                (q + 3 <= ql ? (uint64_t)c2[q + 3] << 32 : 0ull);
  if (sh) {
    lo = (lo >> sh) | (hi << (64 - sh));
    hi >>= sh;
  }
  // lo: bases w .. w+31, hi: bases w+32 ..; k <= 36 needs 4 bases of hi
  xa = (even_bits(lo >> 1) | (even_bits(hi >> 1) << 32)) & m;
  xb = (even_bits(lo) | (even_bits(hi) << 32)) & m;
  return true;
}

// The forward (MSB-first) key of a bit string: base w at bit k-1.
__device__ __forceinline__ uint64_t forward_key(uint64_t x, int k) {
  return __brevll(x) >> (64 - k);
}

__device__ __forceinline__ bool bit_set(const uint32_t* __restrict__ plane,
                                        uint64_t key) {
  return (__ldg(plane + (key >> 5)) >> (key & 31)) & 1u;
}

// One strand of one read against the plane sets pl[0 .. G-1] (slot j counts
// only while bit j of `live` is set), whole warp, windows 0 .. nwin-1 in
// chunks of 32. Per chunk: every slot's plane-A loads go out together (one
// per lane at or past the slot's `allow`), a ballot gives each slot's A
// hits, then the hits are resolved lowest first, all slots at once: the
// candidate's lane loads B, C and D (the greedy count needs membership in
// order, and a member at lane c rules out lanes c+1 .. c+k-1, so their
// loads are never issued). Returns the slots whose count reached t.
template <int G>
__device__ uint32_t strand_warp(const uint32_t* const (&pl)[G], uint32_t live,
                                int64_t pw, const Batch& bt, int64_t row,
                                int end, int nwin, int k, int t,
                                bool reverse) {
  const int lane = threadIdx.x & 31;
  const uint64_t m = low_mask(k);
  int cnt[G], allow[G];
#pragma unroll
  for (int j = 0; j < G; ++j) cnt[j] = allow[j] = 0;
  uint32_t done = 0;
  for (int base = 0; base < nwin && (live & ~done); base += 32) {
    const int w = base + lane;
    uint64_t xa = 0, xb = 0;
    const bool ok = window_bits(bt, row, end, w, k, xa, xb);
    const uint64_t a = reverse ? (~xa & m) : forward_key(xa, k);
    const uint64_t b = reverse ? (~xb & m) : forward_key(xb, k);
    uint32_t hits[G];
#pragma unroll
    for (int j = 0; j < G; ++j)  // every slot's plane-A load, together
      hits[j] = ok && ((live & ~done) >> j & 1u) && w >= allow[j] &&
                bit_set(pl[j], a);
#pragma unroll
    for (int j = 0; j < G; ++j) hits[j] = __ballot_sync(kFull, hits[j]);
    for (;;) {
      int cand[G];
      bool any = false;
#pragma unroll
      for (int j = 0; j < G; ++j) {  // each slot's lowest countable A hit
        const int from = allow[j] - base;
        if (from >= 32 || (done >> j & 1u)) hits[j] = 0;
        else if (from > 0) hits[j] &= kFull << from;
        cand[j] = hits[j] ? __ffs(hits[j]) - 1 : -1;
        any |= cand[j] >= 0;
      }
      if (!any) break;
      bool member[G];
#pragma unroll
      for (int j = 0; j < G; ++j)  // the candidates' B, C, D loads, together
        member[j] = lane == cand[j] && (bit_set(pl[j] + pw, b) &
                                        bit_set(pl[j] + 2 * pw, a ^ b) &
                                        bit_set(pl[j] + 3 * pw, a | b));
#pragma unroll
      for (int j = 0; j < G; ++j) {
        if (cand[j] < 0) continue;
        hits[j] &= ~(1u << cand[j]);
        if (__ballot_sync(kFull, member[j])) {
          allow[j] = base + cand[j] + k;
          if (++cnt[j] >= t) done |= 1u << j;
        }
      }
    }
  }
  return done;
}

// Tags of one read (whole warp) against up to G plane sets: forward strand
// first, the reverse strand only for the slots still below t. out[j *
// out_stride] for slot j < ns.
template <int G>
__device__ void probe_warp(const uint32_t* const (&pl)[G], int ns,
                           int64_t pw, const Batch& bt, int64_t row, int k,
                           int t, int wmax, bool* __restrict__ out,
                           int64_t out_stride) {
  const uint32_t all = ns >= 32 ? kFull : (1u << ns) - 1;
  uint32_t tagged = all;
  if (t > 0) {
    const int end = row_end(bt, row, wmax + k - 1);
    const int nwin = end - k + 1;
    tagged = strand_warp<G>(pl, all, pw, bt, row, end, nwin, k, t, false);
    if (tagged != all)
      tagged |= strand_warp<G>(pl, all & ~tagged, pw, bt, row, end, nwin, k,
                               t, true);
  }
  const int lane = threadIdx.x & 31;
  if (lane < ns) out[lane * out_stride] = (tagged >> lane) & 1u;
}

// Streams one read's bases: code (0..3) and validity of position p, in
// order, loading each packed word once (the build's rolling keys).
struct ReadCursor {
  const uint32_t* c2;
  const uint32_t* vd;
  int end;  // positions [0, end) are read
  uint32_t cw = 0;
  uint32_t vw = 0;

  __device__ ReadCursor(const Batch& bt, int64_t row) {
    c2 = bt.codes2 + row * bt.nw2;
    vd = bt.clean ? nullptr : bt.aux + row * bt.nwv;
    end = row_end(bt, row, bt.length);
  }

  // code of position p (0..3), or -1 when the base is invalid
  __device__ __forceinline__ int code(int p) {
    if ((p & 15) == 0) cw = c2[p >> 4];
    if (vd != nullptr) {
      if ((p & 31) == 0) vw = vd[p >> 5];
      if (!((vw >> (p & 31)) & 1u)) return -1;
    }
    return (int)((cw >> (2 * (p & 15))) & 3u);
  }
};

// One read's forward keys rolled a position at a time from 0 (after p, the
// window ending at p: base p at bit 0, its first base at bit k - 1); a row
// at or past bt.b has no valid position. Every build rolls its keys so.
struct Roller {
  ReadCursor rc;
  uint64_t ka = 0, kb = 0;
  int run = 0;

  __device__ Roller(const Batch& bt, int64_t row)
      : rc(bt, row < bt.b ? row : 0) {
    if (row >= bt.b) rc.end = 0;
  }

  // rolls position p; true when the k bases ending there are all valid
  __device__ __forceinline__ bool step(int p, int k, uint64_t kmask) {
    const int c = p < rc.end ? rc.code(p) : -1;
    if (c < 0) {
      run = 0;
      return false;
    }
    ka = ((ka << 1) | (uint64_t)(c >> 1)) & kmask;
    kb = ((kb << 1) | (uint64_t)(c & 1)) & kmask;
    if (run < k) ++run;
    return run >= k;
  }
};

// Sets a key's bit in a shard holding words [lo, lo + wl) of its plane: no
// atomic for a word outside the range (below lo the difference wraps).
__device__ __forceinline__ void or_in_range(uint32_t* __restrict__ plane,
                                            int64_t lo, int64_t wl,
                                            uint64_t key) {
  const uint64_t rel = (key >> 5) - (uint64_t)lo;
  if (rel < (uint64_t)wl) atomicOr(plane + rel, 1u << (key & 31));
}

// One thread per read rolls its forward keys over the read and issues four
// atomicOr per complete window. Ranged: `planes` is a shard of words [lo, lo
// + pw) of each plane, and only the atomics that land there are made.
template <bool Ranged>
__global__ void build_kernel(uint32_t* __restrict__ planes, int64_t pw,
                             int64_t lo, Batch bt, int k) {
  const uint64_t kmask = low_mask(k);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       row < bt.b; row += stride) {
    Roller r(bt, row);
    for (int p = 0; p < r.rc.end; ++p) {
      if (!r.step(p, k, kmask)) continue;
      const uint64_t ka = r.ka, kb = r.kb, kc = ka ^ kb, kd = ka | kb;
      if constexpr (Ranged) {
        or_in_range(planes, lo, pw, ka);
        or_in_range(planes + pw, lo, pw, kb);
        or_in_range(planes + 2 * pw, lo, pw, kc);
        or_in_range(planes + 3 * pw, lo, pw, kd);
      } else {
        atomicOr(planes + (ka >> 5), 1u << (ka & 31));
        atomicOr(planes + pw + (kb >> 5), 1u << (kb & 31));
        atomicOr(planes + 2 * pw + (kc >> 5), 1u << (kc & 31));
        atomicOr(planes + 3 * pw + (kd >> 5), 1u << (kd & 31));
      }
    }
  }
}

// Warp-uniform grid stride over reads: warp i of the grid takes rows i,
// i + warps, ...
__device__ __forceinline__ int64_t first_row() {
  return ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
}

__device__ __forceinline__ int64_t row_stride() {
  return ((int64_t)gridDim.x * blockDim.x) >> 5;
}

__global__ void probe_kernel(const uint32_t* __restrict__ planes, int64_t pw,
                             Batch bt, int k, int t, int wmax,
                             bool* __restrict__ out) {
  const uint32_t* const pl[1] = {planes};
  for (int64_t row = first_row(); row < bt.b; row += row_stride())
    probe_warp<1>(pl, 1, pw, bt, row, k, t, wmax, out + row, bt.b);
}

// blockIdx.y is the slot group: slots G*y .. G*y + G - 1; out is [S, b].
template <int G>
__global__ void probe_multi_kernel(const int64_t* __restrict__ plane_ptrs,
                                   int64_t s, int64_t pw, Batch bt, int k,
                                   int t, int wmax, bool* __restrict__ out) {
  const int64_t s0 = (int64_t)blockIdx.y * G;
  const int ns = (int)(s - s0 < G ? s - s0 : G);
  const uint32_t* pl[G];
#pragma unroll
  for (int j = 0; j < G; ++j)
    pl[j] = reinterpret_cast<const uint32_t*>(
        j < ns ? plane_ptrs[s0 + j] : plane_ptrs[s0]);
  bool* o = out + s0 * bt.b;
  for (int64_t row = first_row(); row < bt.b; row += row_stride())
    probe_warp<G>(pl, ns, pw, bt, row, k, t, wmax, o + row, bt.b);
}

// A key's word in one plane of a shard, loaded where it lies in [lo, lo +
// wl), else `absent`, beside its bit's mask: the bit is tested only after a
// warp has issued all its loads.
struct ShardBit {
  uint32_t word;
  uint32_t mask;
  __device__ __forceinline__ bool set() const { return (word & mask) != 0; }
};

__device__ __forceinline__ ShardBit load_in_shard(
    const uint32_t* __restrict__ plane, int64_t lo, int64_t wl, uint64_t key,
    uint32_t absent) {
  const uint64_t rel = (key >> 5) - (uint64_t)lo;
  return {rel < (uint64_t)wl ? __ldg(plane + rel) : absent,
          1u << (key & 31)};
}

// Sets bits v of *p: a reduction no lane waits for, made only where v has
// a bit (the caller's words start at 0 and are only ever ORed into). A
// plain read-modify-write by lane 0 puts a round trip to memory on every
// chunk's path, which measured slower on an H100 (PERF.md).
__device__ __forceinline__ void or_word(uint32_t* p, uint32_t v) {
  if (v) atomicOr(p, v);
}

// Pass A: out[(row * 2 + strand) * nwords + w / 32] |= bit w % 32 for each
// complete window w < wmax whose plane-A word lies in the shard and whose A
// bit is set. A warp per read, a lane per window, a chunk of 32 windows at
// a time; lane 0 ORs the chunk's ballots into out, so the shards of one
// device accumulate in one tensor.
__global__ void probe_part_a_kernel(const uint32_t* __restrict__ shard,
                                    int64_t wl, int64_t lo, Batch bt, int k,
                                    int wmax, int nwords,
                                    uint32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const uint64_t m = low_mask(k);
  for (int64_t row = first_row(); row < bt.b; row += row_stride()) {
    const int end = row_end(bt, row, wmax + k - 1);
    uint32_t* o = out + row * 2 * (int64_t)nwords;
    for (int c = 0; c < nwords; ++c) {
      uint64_t xa = 0, xb = 0;
      bool hf = false, hr = false;
      if (window_bits(bt, row, end, c * 32 + lane, k, xa, xb)) {
        hf = load_in_shard(shard, lo, wl, forward_key(xa, k), 0u).set();
        hr = load_in_shard(shard, lo, wl, ~xa & m, 0u).set();
      }
      const uint32_t bf = __ballot_sync(kFull, hf);
      const uint32_t br = __ballot_sync(kFull, hr);
      if (lane == 0) {
        or_word(o + c, bf);
        or_word(o + nwords + c, br);
      }
    }
  }
}

// A window with A set is vetoed when one of its B, C, D words lies in the
// shard with its bit clear; the three loads go out together.
__device__ __forceinline__ bool bcd_vetoed(const uint32_t* __restrict__ sh,
                                           int64_t lo, int64_t wl,
                                           uint64_t a, uint64_t b) {
  const ShardBit x = load_in_shard(sh + wl, lo, wl, b, ~0u);
  const ShardBit y = load_in_shard(sh + 2 * wl, lo, wl, a ^ b, ~0u);
  const ShardBit z = load_in_shard(sh + 3 * wl, lo, wl, a | b, ~0u);
  return !(x.set() && y.set() && z.set());
}

// Pass B/C/D: out |= the vetoes (bcd_vetoed), packed as pass A's, of the
// windows whose bit in ahit (the merged pass-A words) is set. A chunk with
// no A hit on either strand is skipped by the whole warp, and a lane
// without A loads nothing.
__global__ void probe_part_veto_kernel(const uint32_t* __restrict__ shard,
                                       int64_t wl, int64_t lo, Batch bt,
                                       int k, int wmax, int nwords,
                                       const uint32_t* __restrict__ ahit,
                                       uint32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const uint64_t m = low_mask(k);
  for (int64_t row = first_row(); row < bt.b; row += row_stride()) {
    const int end = row_end(bt, row, wmax + k - 1);
    const int64_t at = row * 2 * (int64_t)nwords;
    for (int c = 0; c < nwords; ++c) {
      const uint32_t af = ahit[at + c], ar = ahit[at + nwords + c];
      if ((af | ar) == 0) continue;  // warp-uniform
      const bool cf = (af >> lane) & 1u, cr = (ar >> lane) & 1u;
      bool vf = false, vr = false;
      uint64_t xa = 0, xb = 0;
      if ((cf || cr) && window_bits(bt, row, end, c * 32 + lane, k, xa, xb)) {
        vf = cf && bcd_vetoed(shard, lo, wl, forward_key(xa, k),
                              forward_key(xb, k));
        vr = cr && bcd_vetoed(shard, lo, wl, ~xa & m, ~xb & m);
      }
      const uint32_t bf = __ballot_sync(kFull, vf);
      const uint32_t br = __ballot_sync(kFull, vr);
      if (lane == 0) {
        or_word(out + at + c, bf);
        or_word(out + at + nwords + c, br);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The bulk build (K9). A fine bin is one slice of one plane: bin = plane *
// nslices + (key >> sb), entry = key & (2^sb - 1), bit entry & 31 of word
// entry >> 5 of the slice; sb = 5 + log2(slice words). A coarse bin is one
// region of one plane: bin = plane * nreg + (key >> rb), region entry key &
// (2^rb - 1); a region holds spr = 2^(rb - sb) slices, so fine bin = coarse
// bin * spr + (region entry >> sb).

constexpr int kRowReads = 256;   // reads (a thread each) of a hist / level-1
                                 // block: block j takes rows 256j .. 256j+255
constexpr int kSteps = 16;       // positions a level-1 tile rolls
constexpr int kTile1 = 4 * kSteps * kRowReads;  // entries of a level-1 tile
constexpr int kRefineThreads = 1024;
constexpr int kPer2 = 16;                       // entries a level-2 thread holds
constexpr int kTile2 = kPer2 * kRefineThreads;  // entries of a level-2 tile
constexpr int kMaxSpr = 256;                    // slices a region at most
constexpr int kApplyThreads = 1024;

__device__ __forceinline__ uint64_t plane_key(int p, uint64_t a, uint64_t b) {
  return p == 0 ? a : p == 1 ? b : p == 2 ? (a ^ b) : (a | b);
}

// out[i] = in[0] + .. + in[i - 1] for i <= n (out holds n + 1 words), by
// the whole block (a multiple of 32 threads); scratch: 32 shared words.
// Ends with the block synchronised.
__device__ void block_scan(const uint32_t* in, uint32_t* out, int n,
                           uint32_t* scratch) {
  const int per = (n + blockDim.x - 1) / blockDim.x;
  const int lo = min(n, (int)threadIdx.x * per), hi = min(n, lo + per);
  uint32_t sum = 0;
  for (int i = lo; i < hi; ++i) sum += in[i];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  uint32_t x = sum;  // inclusive over the warp's lanes
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) scratch[warp] = x;
  __syncthreads();
  if (warp == 0) {
    uint32_t w = lane < nw ? scratch[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t y = __shfl_up_sync(kFull, w, d);
      if (lane >= d) w += y;
    }
    if (lane < nw) scratch[lane] = w;  // inclusive over the warps
  }
  __syncthreads();
  uint32_t run = x - sum + (warp ? scratch[warp - 1] : 0);
  for (int i = lo; i < hi; ++i) {
    out[i] = run;
    run += in[i];
  }
  if (threadIdx.x == 0) out[n] = scratch[nw - 1];
  __syncthreads();
}

// A thread per read, block j over rows 256j .. 256j + 255: the block counts
// its windows' entries per coarse bin (all four planes) in shared memory
// (hist: [nbins] uint32) and writes them as row j of table ([blocks, nbins]
// int32). The warp rolls to its longest read.
__global__ void __launch_bounds__(kRowReads)
    bulk_hist_kernel(int32_t* __restrict__ table, int nbins, int nreg,
                     int rb, Batch bt, int k) {
  extern __shared__ uint32_t hist[];
  for (int i = threadIdx.x; i < nbins; i += blockDim.x) hist[i] = 0;
  __syncthreads();
  Roller r(bt, (int64_t)blockIdx.x * kRowReads + threadIdx.x);
  const int wend = __reduce_max_sync(kFull, r.rc.end);
  const uint64_t kmask = low_mask(k);
  for (int p = 0; p < wend; ++p) {
    if (!r.step(p, k, kmask)) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      atomicAdd(hist + q * nreg + (int)(plane_key(q, r.ka, r.kb) >> rb), 1u);
  }
  __syncthreads();
  int32_t* out = table + (int64_t)blockIdx.x * nbins;
  for (int i = threadIdx.x; i < nbins; i += blockDim.x)
    out[i] = (int32_t)hist[i];
}

// Level 1: the histogram's blocks over the same rows, each read rolled once,
// kSteps positions a tile with the keys in registers. Per tile the block
// counts its entries per coarse bin, scans the counts, places each entry
// (region-relative, key & (2^rb - 1)) at its bin's next slot of a staging
// tile in shared memory, and stores the tile: bin c's run at its next index
// in mid, consecutive lanes on consecutive words. Bin c of this block starts
// at starts[c * nrows + row0 + blockIdx.x] (the caller's scan of the
// tables). Store = false only rolls and bins the windows and XORs what it
// would store into one word a warp of `mid` (the decode rate alone).
template <bool Store>
__global__ void __launch_bounds__(kRowReads, 2)
    bulk_scatter_kernel(uint32_t* __restrict__ mid,
                        const int64_t* __restrict__ starts, int64_t nrows,
                        int64_t row0, int nbins, int nreg, int rb, Batch bt,
                        int k) {
  extern __shared__ unsigned long long cursor1[];  // [nbins] mid indices
  uint32_t* stage = reinterpret_cast<uint32_t*>(cursor1 + nbins);  // kTile1
  uint16_t* sbin = reinterpret_cast<uint16_t*>(stage + kTile1);    // kTile1
  uint32_t* cnt = reinterpret_cast<uint32_t*>(sbin + kTile1);      // nbins
  uint32_t* lstart = cnt + nbins;                                  // + 1
  __shared__ uint32_t scratch[32];
  __shared__ int bend;
  const int tid = threadIdx.x;
  Roller r(bt, (int64_t)blockIdx.x * kRowReads + tid);
  if (tid == 0) bend = 0;
  if constexpr (Store) {
    for (int c = tid; c < nbins; c += kRowReads) {
      cursor1[c] = (unsigned long long)starts[c * nrows + row0 + blockIdx.x];
      cnt[c] = 0;
    }
  }
  __syncthreads();
  atomicMax(&bend, r.rc.end);
  __syncthreads();
  const int end = bend;
  const uint64_t kmask = low_mask(k), rmask = low_mask(rb);
  uint32_t sink = 0;
  for (int p0 = 0; p0 < end; p0 += kSteps) {
    uint64_t ka[kSteps], kb[kSteps];
    uint32_t ok = 0;
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      if (p0 + s < end && r.step(p0 + s, k, kmask)) ok |= 1u << s;
      ka[s] = r.ka;
      kb[s] = r.kb;
    }
    if constexpr (!Store) {
#pragma unroll
      for (int s = 0; s < kSteps; ++s)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const uint64_t key = plane_key(q, ka[s], kb[s]);
          if (ok >> s & 1u)
            sink ^= (uint32_t)(q * nreg + (int)(key >> rb)) ^
                    (uint32_t)(key & rmask);
        }
    } else {
      if (!__syncthreads_or(ok)) continue;  // a tile without a window
#pragma unroll
      for (int s = 0; s < kSteps; ++s)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (ok >> s & 1u)
            atomicAdd(cnt + q * nreg +
                          (int)(plane_key(q, ka[s], kb[s]) >> rb), 1u);
      __syncthreads();
      block_scan(cnt, lstart, nbins, scratch);
      for (int c = tid; c < nbins; c += kRowReads) cnt[c] = lstart[c];
      __syncthreads();
#pragma unroll
      for (int s = 0; s < kSteps; ++s)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const uint64_t key = plane_key(q, ka[s], kb[s]);
          const int c = q * nreg + (int)(key >> rb);
          if (ok >> s & 1u) {
            const uint32_t at = atomicAdd(cnt + c, 1u);
            stage[at] = (uint32_t)(key & rmask);
            sbin[at] = (uint16_t)c;
          }
        }
      __syncthreads();
      const int n = (int)lstart[nbins];
      for (int i = tid; i < n; i += kRowReads) {
        const int c = sbin[i];
        mid[cursor1[c] + (i - lstart[c])] = stage[i];
      }
      __syncthreads();
      for (int c = tid; c < nbins; c += kRowReads) {
        cursor1[c] += lstart[c + 1] - lstart[c];
        cnt[c] = 0;
      }
      __syncthreads();
    }
  }
  if constexpr (!Store) {
    sink = __reduce_xor_sync(kFull, sink);
    if ((tid & 31) == 0) atomicXor(mid + (blockIdx.x * kRowReads + tid) / 32,
                                   sink);
  }
}

// Level 2, a block per tile, in place: tile t is entries [lo, lo + kTile2)
// of coarse bin c's run mid[cstart[c] .. cstart[c + 1]), c the bin with
// tprefix[c] <= t < tprefix[c + 1] (tiles of a bin: the caller's
// ceil(count / kTile2), scanned), lo = cstart[c] + (t - tprefix[c]) *
// kTile2; blocks past the last tile exit. The block reads its tile once
// into registers (kPer2 entries a thread), counts them per slice in shared
// memory (cnt: [spr]), scans the counts, places each entry at its slice's
// next slot of a staging tile (dynamic shared memory, kTile2 words) and
// writes the staged tile back over the same range, consecutive lanes on
// consecutive words: the tile sorted by slice, each entry unchanged. No
// block reads or writes another's range, and a block has read all of its
// tile before it writes any of it. Its row of slice starts, spr + 1 values
// of at most kTile2, goes to table[(spr + 1) * tprefix[c] + s * nt + (t -
// tprefix[c])] (a region's rows as [slice][tile], nt its tiles), and each
// slice's count is added to fine[c * spr + s] (one atomic a (tile, slice)).
// An entry's slot comes from a second atomic pass on the scanned cursors,
// so only the entries stay in registers (two blocks an SM).
__global__ void __launch_bounds__(kRefineThreads, 2)
    bulk_refine_kernel(uint32_t* __restrict__ mid,
                       const int64_t* __restrict__ cstart,
                       const int64_t* __restrict__ tprefix, int nbins,
                       int spr, int sb, uint16_t* __restrict__ table,
                       unsigned long long* __restrict__ fine) {
  extern __shared__ uint32_t stage[];  // [kTile2]
  __shared__ uint32_t cnt[kMaxSpr], lstart[kMaxSpr + 1], scratch[32];
  __shared__ int bin;
  const int64_t t = blockIdx.x;
  if (t >= tprefix[nbins]) return;  // block-uniform
  const int tid = threadIdx.x;
  if (tid == 0) {  // the greatest c with tprefix[c] <= t
    int lo = 0, hi = nbins;
    while (hi - lo > 1) {
      const int m = (lo + hi) / 2;
      if (tprefix[m] <= t) lo = m; else hi = m;
    }
    bin = lo;
  }
  for (int s = tid; s < spr; s += kRefineThreads) cnt[s] = 0;
  __syncthreads();
  const int c = bin;
  const int64_t t0 = tprefix[c], nt = tprefix[c + 1] - t0;
  const int64_t lo = cstart[c] + (t - t0) * kTile2;
  const int64_t rest = cstart[c + 1] - lo;
  const int n = (int)(rest < kTile2 ? rest : kTile2);
  uint32_t* tile = mid + lo;
  uint32_t v[kPer2];
#pragma unroll
  for (int j = 0; j < kPer2; ++j) {
    const int i = tid + j * kRefineThreads;
    v[j] = i < n ? tile[i] : 0u;
  }
#pragma unroll
  for (int j = 0; j < kPer2; ++j)
    if (tid + j * kRefineThreads < n) atomicAdd(cnt + (v[j] >> sb), 1u);
  __syncthreads();
  block_scan(cnt, lstart, spr, scratch);
  uint16_t* row = table + (spr + 1) * t0 + (t - t0);
  for (int s = tid; s <= spr; s += kRefineThreads)
    row[s * nt] = (uint16_t)lstart[s];
  unsigned long long* f = fine + (int64_t)c * spr;
  for (int s = tid; s < spr; s += kRefineThreads)
    if (cnt[s]) atomicAdd(f + s, (unsigned long long)cnt[s]);
  __syncthreads();
  for (int s = tid; s < spr; s += kRefineThreads) cnt[s] = lstart[s];
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kPer2; ++j)
    if (tid + j * kRefineThreads < n)
      stage[atomicAdd(cnt + (v[j] >> sb), 1u)] = v[j];
  __syncthreads();
  for (int i = tid; i < n; i += kRefineThreads) tile[i] = stage[i];
}

// A block per fine bin, the last bin first: bin = plane * nslices + j holds
// words [j * sw, (j + 1) * sw) of its plane, slice s = bin % spr of coarse
// bin c = bin / spr. A bin whose fine count is 0 touches nothing. Else the
// slice is loaded into shared memory once; each warp takes whole runs, the
// region's tiles strided by warp: tile t's run of slice s is mid[cstart[c]
// + t * kTile2 + start[s][t] .. + start[s + 1][t]) (level 2's table, its
// two rows read at consecutive tiles by consecutive warps), four entries a
// lane in flight, each ORed in (entry & (2^sb - 1)) with a shared-memory
// atomic; then the slice is stored once.
__global__ void __launch_bounds__(kApplyThreads)
    bulk_apply_kernel(uint32_t* __restrict__ planes, int64_t pw,
                      int64_t nslices, int64_t sw,
                      const uint32_t* __restrict__ mid,
                      const uint16_t* __restrict__ table,
                      const unsigned long long* __restrict__ fine,
                      const int64_t* __restrict__ cstart,
                      const int64_t* __restrict__ tprefix, int spr, int sb) {
  extern __shared__ uint4 slice4[];
  uint32_t* slice = reinterpret_cast<uint32_t*>(slice4);
  const int64_t bin = (int64_t)gridDim.x - 1 - blockIdx.x;
  if (fine[bin] == 0) return;
  uint32_t* words = planes + (bin / nslices) * pw + (bin % nslices) * sw;
  const bool vec = sw % 4 == 0;  // then words is 16-byte aligned
  if (vec) {
    const uint4* src = reinterpret_cast<const uint4*>(words);
#pragma unroll 8
    for (int64_t i = threadIdx.x; i < sw / 4; i += blockDim.x)
      slice4[i] = src[i];
  } else {
    for (int64_t i = threadIdx.x; i < sw; i += blockDim.x) slice[i] = words[i];
  }
  __syncthreads();
  const int64_t c = bin / spr;
  const int s = (int)(bin - c * spr);
  const int64_t t0 = tprefix[c], nt = tprefix[c + 1] - t0;
  const uint16_t* row = table + (spr + 1) * t0 + s * nt;  // + nt: s + 1
  const uint32_t* base = mid + cstart[c];
  const uint32_t emask = (1u << sb) - 1u;  // sb <= 19
  const int lane = threadIdx.x & 31;
  for (int64_t t = threadIdx.x >> 5; t < nt; t += kApplyThreads / 32) {
    const int a = row[t], b = row[nt + t];
    const uint32_t* run = base + t * kTile2;
    for (int e = a + lane; e < b; e += 128) {
      uint32_t x[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        x[q] = e + 32 * q < b ? __ldcs(run + e + 32 * q) : 0u;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (e + 32 * q < b) {
          const uint32_t w = x[q] & emask;
          atomicOr(slice + (w >> 5), 1u << (w & 31));
        }
    }
  }
  __syncthreads();
  if (vec) {
    uint4* dst = reinterpret_cast<uint4*>(words);
#pragma unroll 8
    for (int64_t i = threadIdx.x; i < sw / 4; i += blockDim.x)
      dst[i] = slice4[i];
  } else {
    for (int64_t i = threadIdx.x; i < sw; i += blockDim.x) words[i] = slice[i];
  }
}

unsigned grid_for(int64_t units, int per_block) {
  int64_t blocks = (units + per_block - 1) / per_block;
  if (blocks > (int64_t)1 << 20) blocks = (int64_t)1 << 20;  // grid-stride
  return (unsigned)blocks;
}

Batch make_batch(const void* codes2, int64_t nw2, const void* aux,
                 int64_t nwv, int clean, int64_t b, int length) {
  Batch bt;
  bt.codes2 = (const uint32_t*)codes2;
  bt.aux = (const uint32_t*)aux;
  bt.nw2 = nw2;
  bt.nwv = nwv;
  bt.clean = clean;
  bt.b = b;
  bt.length = length;
  return bt;
}

}  // namespace

// planes: [4 * plane_words] words, updated in place. codes2 / aux / clean /
// b / length: the batch (see above).
extern "C" int commet_build_planes(void* planes, int64_t plane_words,
                                   const void* codes2, int64_t nw2,
                                   const void* aux, int64_t nwv, int clean,
                                   int64_t b, int length, int k,
                                   void* stream) {
  if (b <= 0) return 0;
  build_kernel<false>
      <<<grid_for(b, kThreads), kThreads, 0, (cudaStream_t)stream>>>(
          (uint32_t*)planes, plane_words, 0,
          make_batch(codes2, nw2, aux, nwv, clean, b, length), k);
  return (int)cudaGetLastError();
}

// shard: [4 * wl] words, words [lo, lo + wl) of each plane, updated in
// place; the batch as above.
extern "C" int commet_build_planes_range(void* shard, int64_t wl, int64_t lo,
                                         const void* codes2, int64_t nw2,
                                         const void* aux, int64_t nwv,
                                         int clean, int64_t b, int length,
                                         int k, void* stream) {
  if (b <= 0) return 0;
  build_kernel<true>
      <<<grid_for(b, kThreads), kThreads, 0, (cudaStream_t)stream>>>(
          (uint32_t*)shard, wl, lo,
          make_batch(codes2, nw2, aux, nwv, clean, b, length), k);
  return (int)cudaGetLastError();
}

// Pass A of one shard; out: [b, 2, ceil(wmax / 32)] uint32 words, ORed into.
extern "C" int commet_probe_planes_part_a(const void* shard, int64_t wl,
                                          int64_t lo, const void* codes2,
                                          int64_t nw2, const void* aux,
                                          int64_t nwv, int clean, int64_t b,
                                          int length, int k, int wmax,
                                          void* out, void* stream) {
  if (b <= 0 || wmax <= 0) return 0;
  probe_part_a_kernel<<<grid_for(b, kWarps), kThreads, 0,
                        (cudaStream_t)stream>>>(
      (const uint32_t*)shard, wl, lo,
      make_batch(codes2, nw2, aux, nwv, clean, b, length), k, wmax,
      (wmax + 31) / 32, (uint32_t*)out);
  return (int)cudaGetLastError();
}

// Pass B/C/D of one shard given the merged pass-A words ahit; out: vetoes
// packed as pass A's, ORed into.
extern "C" int commet_probe_planes_part(const void* shard, int64_t wl,
                                        int64_t lo, const void* codes2,
                                        int64_t nw2, const void* aux,
                                        int64_t nwv, int clean, int64_t b,
                                        int length, int k, int wmax,
                                        const void* ahit, void* out,
                                        void* stream) {
  if (b <= 0 || wmax <= 0) return 0;
  probe_part_veto_kernel<<<grid_for(b, kWarps), kThreads, 0,
                           (cudaStream_t)stream>>>(
      (const uint32_t*)shard, wl, lo,
      make_batch(codes2, nw2, aux, nwv, clean, b, length), k, wmax,
      (wmax + 31) / 32, (const uint32_t*)ahit, (uint32_t*)out);
  return (int)cudaGetLastError();
}

// out: [b] bool tags.
extern "C" int commet_probe_planes(const void* planes, int64_t plane_words,
                                   const void* codes2, int64_t nw2,
                                   const void* aux, int64_t nwv, int clean,
                                   int64_t b, int length, int k, int t,
                                   int wmax, void* out, void* stream) {
  if (b <= 0) return 0;
  probe_kernel<<<grid_for(b, kWarps), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)planes, plane_words,
      make_batch(codes2, nw2, aux, nwv, clean, b, length), k, t, wmax,
      (bool*)out);
  return (int)cudaGetLastError();
}

// plane_ptrs: [s] device int64 addresses of the slots' plane sets (each
// 4 * plane_words words); out: [s, b] bool tags.
extern "C" int commet_probe_planes_multi(const void* plane_ptrs, int64_t s,
                                         int64_t plane_words,
                                         const void* codes2, int64_t nw2,
                                         const void* aux, int64_t nwv,
                                         int clean, int64_t b, int length,
                                         int k, int t, int wmax, void* out,
                                         void* stream) {
  if (b <= 0 || s <= 0) return 0;
  const int64_t groups = (s + kMaxGroup - 1) / kMaxGroup;
  if (groups > 65535) return (int)cudaErrorInvalidValue;  // gridDim.y limit
  // the fewest slots a warp that keep the groups at `groups`, so a warp
  // carries no slot it does not probe (S = 3: one group of 3)
  const int g = (int)((s + groups - 1) / groups);
  const dim3 grid(grid_for(b, kWarps), (unsigned)groups);
  const Batch bt = make_batch(codes2, nw2, aux, nwv, clean, b, length);
  const int64_t* ptrs = (const int64_t*)plane_ptrs;
  cudaStream_t st = (cudaStream_t)stream;
  switch (g) {
#define COMMET_MULTI_CASE(G)                                               \
  case G:                                                                  \
    probe_multi_kernel<G><<<grid, kThreads, 0, st>>>(                      \
        ptrs, s, plane_words, bt, k, t, wmax, (bool*)out);                 \
    break;
    COMMET_MULTI_CASE(1)
    COMMET_MULTI_CASE(2)
    COMMET_MULTI_CASE(3)
    COMMET_MULTI_CASE(4)
    COMMET_MULTI_CASE(5)
    COMMET_MULTI_CASE(6)
    COMMET_MULTI_CASE(7)
    COMMET_MULTI_CASE(8)
#undef COMMET_MULTI_CASE
  }
  return (int)cudaGetLastError();
}

// Dynamic shared memory above the default 48 KB needs the opt-in.
template <class K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// The blocks of a histogram or level-1 launch: one a 256 reads, no stride
// (the tables' rows are these blocks).
unsigned row_blocks(int64_t b) {
  return (unsigned)((b + kRowReads - 1) / kRowReads);
}

// Dynamic shared memory of a level-1 block: cursors, staging tile, its bins,
// counts and starts.
int scatter_smem(int nbins) {
  return nbins * 8 + kTile1 * 6 + (2 * nbins + 1) * 4;
}

// Writes a batch's per-block coarse-bin counts: table [ceil(b / 256),
// nbins] int32, nbins = 4 * nreg.
extern "C" int commet_bulk_hist(void* table, int nbins, int rb,
                                const void* codes2, int64_t nw2,
                                const void* aux, int64_t nwv, int clean,
                                int64_t b, int length, int k, void* stream) {
  if (b <= 0) return 0;
  const int smem = nbins * (int)sizeof(uint32_t);
  bulk_hist_kernel<<<row_blocks(b), kRowReads, smem,
                     (cudaStream_t)stream>>>(
      (int32_t*)table, nbins, nbins / 4, rb,
      make_batch(codes2, nw2, aux, nwv, clean, b, length), k);
  return (int)cudaGetLastError();
}

// Level 1 of a batch whose blocks are rows row0 .. of starts ([nbins,
// nrows] int64, each (bin, row)'s first index in mid): writes the batch's
// region-relative entries into mid.
extern "C" int commet_bulk_scatter(void* mid, const void* starts,
                                   int64_t nrows, int64_t row0, int nbins,
                                   int rb, const void* codes2, int64_t nw2,
                                   const void* aux, int64_t nwv, int clean,
                                   int64_t b, int length, int k,
                                   void* stream) {
  if (b <= 0) return 0;
  const int smem = scatter_smem(nbins);
  cudaError_t err = allow_smem(bulk_scatter_kernel<true>, smem);
  if (err != cudaSuccess) return (int)err;
  bulk_scatter_kernel<true><<<row_blocks(b), kRowReads, smem,
                              (cudaStream_t)stream>>>(
      (uint32_t*)mid, (const int64_t*)starts, nrows, row0, nbins, nbins / 4,
      rb, make_batch(codes2, nw2, aux, nwv, clean, b, length), k);
  return (int)cudaGetLastError();
}

// Level 2 of a chunk, in place: mid holds coarse bin c's entries at
// [cstart[c], cstart[c + 1]) ([nbins + 1] int64), tprefix ([nbins + 1]
// int64) its tiles' scan, ntiles >= tprefix[nbins] blocks. Sorts each tile
// by slice, writes its slice starts into table (uint16, (spr + 1) *
// tprefix[nbins] values) and adds each slice's entries to fine ([nbins *
// spr] uint64).
extern "C" int commet_bulk_refine(void* mid, const void* cstart,
                                  const void* tprefix, int64_t ntiles,
                                  int nbins, int spr, int sb, void* table,
                                  void* fine, void* stream) {
  if (ntiles <= 0) return 0;
  if (ntiles > INT32_MAX || spr > kMaxSpr) return (int)cudaErrorInvalidValue;
  const int smem = kTile2 * (int)sizeof(uint32_t);
  cudaError_t err = allow_smem(bulk_refine_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  bulk_refine_kernel<<<(unsigned)ntiles, kRefineThreads, smem,
                       (cudaStream_t)stream>>>(
      (uint32_t*)mid, (const int64_t*)cstart, (const int64_t*)tprefix, nbins,
      spr, sb, (uint16_t*)table, (unsigned long long*)fine);
  return (int)cudaGetLastError();
}

// ORs every fine bin's entries into planes ([4 * pw] words, updated in
// place): bin i = c * spr + s, its runs in mid at the tiles of coarse bin c
// (cstart, tprefix as level 2's), their starts in table (level 2's); fine
// ([4 * nslices] uint64) its entries; sw words a slice (at most the opt-in
// shared memory).
extern "C" int commet_bulk_apply(void* planes, int64_t pw, int64_t nslices,
                                 int64_t sw, const void* mid,
                                 const void* table, const void* fine,
                                 const void* cstart, const void* tprefix,
                                 int spr, int sb, void* stream) {
  const int smem = (int)(sw * 4);
  cudaError_t err = allow_smem(bulk_apply_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  bulk_apply_kernel<<<(unsigned)(4 * nslices), kApplyThreads, smem,
                      (cudaStream_t)stream>>>(
      (uint32_t*)planes, pw, nslices, sw, (const uint32_t*)mid,
      (const uint16_t*)table, (const unsigned long long*)fine,
      (const int64_t*)cstart, (const int64_t*)tprefix, spr, sb);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Measurement only (chip_smoke.py's bulk build phase; no wrapper, on no
// path of the program).

// The level-1 roll alone: every window's four coarse bins and entries of the
// batch computed and XORed into out ([ceil(b / 32)] uint32, one word a
// warp), nothing staged or stored: the decode rate.
extern "C" int commet_bulk_decode(void* out, int nbins, int rb,
                                  const void* codes2, int64_t nw2,
                                  const void* aux, int64_t nwv, int clean,
                                  int64_t b, int length, int k,
                                  void* stream) {
  if (b <= 0) return 0;
  bulk_scatter_kernel<false><<<row_blocks(b), kRowReads, 0,
                               (cudaStream_t)stream>>>(
      (uint32_t*)out, nullptr, 0, 0, nbins, nbins / 4, rb,
      make_batch(codes2, nw2, aux, nwv, clean, b, length), k);
  return (int)cudaGetLastError();
}

namespace {

__device__ __forceinline__ uint64_t mix64(uint64_t x) {
  x ^= x >> 33;
  x *= 0xff51afd7ed558ccdull;
  x ^= x >> 33;
  x *= 0xc4ceb9fe1a85ec53ull;
  return x ^ (x >> 33);
}

// n 4-byte stores as runs of 2^run_bits consecutive words, run r at a
// pseudo-random start in the first half of out (words: a power of two); a
// thread a store, consecutive threads on consecutive words of a run. Shifts
// and masks only, so the stores, not the address arithmetic, bound it.
__global__ void store_runs_kernel(uint32_t* __restrict__ out, int64_t words,
                                  int64_t n, int run_bits) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const uint64_t half = (uint64_t)words / 2 - 1;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    out[(mix64((uint64_t)i >> run_bits) & half) +
        (i & ((1 << run_bits) - 1))] = (uint32_t)i;
}

}  // namespace

// The store rate by run length: out [words] uint32, words a power of two
// of at least 2^(run_bits + 1).
extern "C" int commet_store_runs(void* out, int64_t words, int64_t n,
                                 int run_bits, void* stream) {
  if (n <= 0 || run_bits < 0 || words < (int64_t)2 << run_bits ||
      (words & (words - 1)))
    return (int)cudaErrorInvalidValue;
  store_runs_kernel<<<grid_for(n, 256), 256, 0, (cudaStream_t)stream>>>(
      (uint32_t*)out, words, n, run_bits);
  return (int)cudaGetLastError();
}
