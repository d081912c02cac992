// Dense-plane build and probe, hand-written for Hopper (sm_90a).
//
// Four bit planes of 2^k bits each (A = keya, B = keyb, C = keya ^ keyb,
// D = keya | keyb, reference include/bloom_filter.h:37-43) as one array of
// 4 * plane_words uint32 words; a key's word is key >> 5 and its bit key & 31
// (keys are whole 64-bit values for k <= 36).
//
// Replaces, in commet_tpu/core/kernels.py:
//   - commet_build_planes: K4, build_chunk / build_chunk_packed(_clean) /
//     _build_chunk_impl (kernels.py:670-746), and K9's bulk build
//     (bulk_plane_sorted / bulk_scatter_set / bulk_or_plane, 768-827). The
//     TPU builds by sort -> segmented OR -> gather of the existing bits ->
//     scatter-add, because it has no scatter-OR; here every complete forward
//     window does one atomicOr per plane.
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
    ReadCursor rc(bt, row);
    uint64_t ka = 0, kb = 0;
    int run = 0;
    for (int p = 0; p < rc.end; ++p) {
      const int c = rc.code(p);
      if (c < 0) {
        run = 0;
        continue;
      }
      ka = ((ka << 1) | (uint64_t)(c >> 1)) & kmask;
      kb = ((kb << 1) | (uint64_t)(c & 1)) & kmask;
      if (run < k) ++run;
      if (run < k) continue;
      const uint64_t kc = ka ^ kb, kd = ka | kb;
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
