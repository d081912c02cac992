// Sorted-join membership verdicts for the stream probe, hand-written for
// Hopper (sm_90a): a tile join.
//
// Replaces the TPU kernel commet_tpu/core/stream.py:_join_kernel, through
// both of its single-chip entries: join_membership (one index; exported here
// as commet_join) and _membership_stream_multi, which joins one sorted query
// stream against S indexes (exported as commet_join_multi, out [S, M]). The
// TPU kernel streams a banded 2*ki x 128 window of the keya-sorted index past
// each chunk of sorted queries in VMEM; the window, the scalar-prefetched
// window starts, pick_chunk and the signed-bias view all exist for the TPU's
// tiling and have no counterpart here. Its multi-index caller packs 15
// two-bit verdicts per uint32 for a second sort (the unsort); here the
// verdicts stay int8 and the caller scatters them back through the sort
// permutation.
//
// What it computes, per query pair (qa, qb):
//   CONF   (2) the exact pair (keya, keyb) is in the index;
//   CAND   (1) keya is in the index but the pair is not;
//   NONMEM (0) keya is not in the index.
// Every query is bracketed by a search of the whole index, so RESIDUAL (3)
// never occurs: strictly more decided than the TPU kernel, and the verdict
// sandwich treats CAND and RESIDUAL alike, so the final tags are unchanged.
//
// The index holds int64 keys (k <= 36 fits whole), sorted lexicographically
// by (keya, keyb), valid entries in [0, mi). Keys are non-negative, below
// 2^36, and every compare is a signed 64-bit compare, so the greatest k = 36
// key orders like any other.
//
// What bounds it: bytes, and before that the latency of dependent loads. A
// query by itself walks a binary search of log2(mi) levels (26 at 64M
// entries), each an 8-byte load whose address hangs on the one before. But
// the queries arrive sorted (the caller's sort), so a tile of consecutive
// queries needs one short contiguous piece of the keya column. The design
// turns the chains into streamed loads:
//   1. A block owns a tile of consecutive queries, up to kPer a thread,
//      loaded coalesced into registers (warp w, lane l holds queries
//      j * kThreads + 32 w + l: 32 neighbours a load). A block reduction
//      gives the tile's least and greatest keya; it does not assume sorted
//      queries, so any order is right, and it masks the ragged last tile.
//   2. The block brackets the tile's index range once: L = lower bound of
//      the least keya (warp 0), R = upper bound of the greatest (warp 1),
//      past that key's whole equal-keya run, so no run of the tile is cut.
//      Each is a 32-ary search: every lane probes one of 32 splitters a
//      step, so 26 dependent levels become about 6 steps of loads in flight
//      together. Two full-depth searches a tile, not one a query.
//   3. Where R - L is below the launch's capacity the block copies
//      ika[L, R) into shared memory with cp.async, 16 bytes a copy from an
//      address aligned down to 16 bytes, the first and last pair masked by
//      element (a column may start 8 bytes off a 16-byte boundary). Every
//      thread then bisects the staged piece for its queries' lower bounds
//      and run ends in one loop whose trip count is the same for every
//      query (a branchless bisection from the piece's length), 2 * kPer
//      independent shared loads a level. The keyb column is read from
//      device memory only inside the run [lo, hi) of a query whose keya is
//      present.
//   4. Where the range does not fit (unsorted queries, a long low-complexity
//      run) the threads search [L, R) in device memory: classic bisections,
//      then a gallop to each run's end. This is a branch of the design,
//      taken by the whole block from R - L before any barrier inside it:
//      same verdicts.
//   5. Every loop over device memory runs a thread's kPer searches in step,
//      each load at the address the search needs or, where it needs none,
//      at the column's first entry: no branch stands between the kPer loads
//      of a step, so they are in flight together (a branch a search
//      serialized them: measured 0.41 against 0.36 ms).
//   6. The grouped kernel keeps its tile in registers and walks G slots,
//      bracketing and staging each slot's range in turn in the same shared
//      memory, so the queries are read once per G slots. The host takes
//      G = S where the tiles alone fill the card, and fewer slots a block
//      (more blocks along grid.y) where they do not.
//
// The numbers (an H100; PERF.md has the measurements): kThreads = 256 and
// kPer = 4, so a tile holds up to kTile = 1,024 queries; kCap = 8,192 entries
// (64 KB of dynamic shared memory) lets three blocks share an SM and leaves
// its L1 room for the keyb loads; 9,216 and 12,288 entries measured slower,
// as did 2 or 8 queries a thread and 128 or 512 threads. At the main path's
// density (a 65,536-read batch, 9M queries, against 64M pairs: 7.4 entries a
// query) a full tile spans about 7,600 entries and fits. The caller sizes
// each launch from its density (stream.py: join_launch_geometry): a shorter
// tile where a full one would not fit; and for a dense index (15 entries a
// query: staging would copy four times the sectors the queries need, and
// measured slower than no staging) a launch with no shared memory at all,
// which keeps the SM's whole L1 for the search in device memory, every query
// from the root of the index: the bracket there costs more than the cached
// upper levels it saves.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int8_t kNonmem = 0;
constexpr int8_t kCand = 1;
constexpr int8_t kConf = 2;

constexpr int kThreads = 256;
constexpr int kPer = 4;                  // queries a thread
constexpr int kTile = kThreads * kPer;   // T: queries a block
constexpr int kCap = 8192;               // C: index entries a block stages
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 3;
constexpr int64_t kWide = (int64_t)1 << 20;  // entries: see bisect_device
constexpr unsigned kFull = 0xffffffffu;

// The first entry of ika[0, mi) that is >= key (kUpper false) or > key
// (kUpper true), found by one warp: 32 splitters a step cut the range in
// 33, each lane loads one. Every lane returns the same position.
template <bool kUpper>
__device__ __forceinline__ int64_t warp_bound(const int64_t* __restrict__ ika,
                                              int64_t mi, int64_t key,
                                              int lane) {
  int64_t lo = 0;
  int64_t n = mi;  // the answer lies in [lo, lo + n]
  while (n > 0) {
    const int64_t step = n / 33 + 1;
    const int64_t off = (int64_t)(lane + 1) * step - 1;  // this lane's splitter
    bool below = false;
    if (off < n) {
      const int64_t v = __ldg(ika + lo + off);
      below = kUpper ? (v <= key) : (v < key);
    }
    // the index is sorted: the lanes that say "below" are a prefix
    const int cnt = __popc(__ballot_sync(kFull, below));
    // splitter cnt, where a lane holds one, is known not to be below
    const bool capped = cnt < 32 && (int64_t)(cnt + 1) * step - 1 < n;
    lo += cnt * step;
    n = capped ? step - 1 : n - cnt * step;
  }
  return lo;
}

__device__ __forceinline__ int64_t warp_min(int64_t v) {
  for (int o = 16; o > 0; o >>= 1) {
    const int64_t w = __shfl_xor_sync(kFull, v, o);
    v = w < v ? w : v;
  }
  return v;
}

__device__ __forceinline__ int64_t warp_max(int64_t v) {
  for (int o = 16; o > 0; o >>= 1) {
    const int64_t w = __shfl_xor_sync(kFull, v, o);
    v = w > v ? w : v;
  }
  return v;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

// Lower and upper bound (the start and the end of the equal-key run) of each
// of the thread's kPer keys in the staged keys[0, n), by a branchless
// bisection: the trip count hangs on n alone, so the 2 * kPer searches run
// in one loop with their shared-memory loads in flight together.
__device__ __forceinline__ void bisect_staged(const int64_t* keys, int n,
                                              const int64_t (&a)[kPer],
                                              int (&lo)[kPer],
                                              int (&hi)[kPer]) {
#pragma unroll
  for (int j = 0; j < kPer; ++j) lo[j] = hi[j] = 0;
  int len = n;
  while (len > 1) {
    const int half = len >> 1;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      lo[j] += keys[lo[j] + half - 1] < a[j] ? half : 0;
      hi[j] += keys[hi[j] + half - 1] <= a[j] ? half : 0;
    }
    len -= half;
  }
  if (len == 1) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      lo[j] += keys[lo[j]] < a[j] ? 1 : 0;
      hi[j] += keys[hi[j]] <= a[j] ? 1 : 0;
    }
  }
}

// The entry at idx where the thread needs it, else the column's first entry
// (valid wherever mi > 0, and hot in the cache): a step's kPer loads then
// carry no branch and are in flight together.
__device__ __forceinline__ int64_t load_if(const int64_t* __restrict__ keys,
                                           bool need, int64_t idx) {
  return __ldg(keys + (need ? idx : 0));
}

// Lower bounds of the kPer keys by the classic bisection of ika[lo0, lo0 +
// cnt0), the kPer searches in step. With kPrune, a probe outside [left,
// right) costs no load: the keys lie between the entries there, so its
// outcome is known.
template <bool kPrune>
__device__ __forceinline__ void descend(const int64_t* __restrict__ ika,
                                        int64_t lo0, int64_t cnt0,
                                        int64_t left, int64_t right,
                                        const int64_t (&a)[kPer],
                                        int64_t (&lo)[kPer]) {
  int64_t cnt[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    lo[j] = lo0;
    cnt[j] = cnt0;
  }
  bool any = cnt0 > 0;
  while (any) {
    any = false;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int64_t half = cnt[j] >> 1;
      const int64_t mid = lo[j] + half;
      const bool go = cnt[j] > 0;
      const bool need = go && (!kPrune || (mid >= left && mid < right));
      const int64_t v = load_if(ika, need, mid);
      const bool up = go && ((kPrune && mid < left) || (need && v < a[j]));
      lo[j] += up ? half + 1 : 0;
      cnt[j] = !go ? 0 : up ? cnt[j] - half - 1 : half;
      any |= cnt[j] > 0;
    }
  }
}

// Lower bounds in ika[0, mi) of the kPer keys, all known to lie in [left,
// right], searched in device memory. A narrow range is bisected as it is:
// it stays in the caches while its tile works on it. A wide one (unsorted
// queries) is searched along the one implicit tree over [0, mi), whose
// probed positions are the same for every tile, so that its upper levels
// stay in the L2 across the launch (each tile bisecting its own wide range
// would walk a tree of its own); the descent starts at the deepest node
// that holds [left, right].
__device__ __forceinline__ void bisect_device(const int64_t* __restrict__ ika,
                                              int64_t mi, int64_t left,
                                              int64_t right,
                                              const int64_t (&a)[kPer],
                                              int64_t (&lo)[kPer]) {
  if (right - left < kWide || right - left == mi) {
    descend<false>(ika, left, right - left, left, right, a, lo);
    return;
  }
  int64_t lo0 = 0;
  int64_t cnt0 = mi;
  while (cnt0 > 0) {
    const int64_t half = cnt0 >> 1;
    const int64_t mid = lo0 + half;
    if (mid < left) {
      lo0 = mid + 1;
      cnt0 -= half + 1;
    } else if (mid >= right) {
      cnt0 = half;
    } else {
      break;
    }
  }
  descend<true>(ika, lo0, cnt0, left, right, a, lo);
}

// The ends of the equal-key runs that start at keys[lo[j]] for the queries
// with present[j] (the runs lie inside keys[0, n), n > 0), into hi[j];
// hi[j] = lo[j] for the others. A gallop from each run's start, then a
// bisection, the kPer queries in step with their loads in flight together.
__device__ __forceinline__ void run_ends(const int64_t* __restrict__ keys,
                                         int64_t n, const int64_t (&a)[kPer],
                                         const int64_t (&lo)[kPer],
                                         const bool (&present)[kPer],
                                         int64_t (&hi)[kPer]) {
  int64_t last[kPer];  // known member of the run
  int64_t cnt[kPer];
  bool live[kPer];
  bool any = false;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    last[j] = lo[j];
    hi[j] = lo[j];
    cnt[j] = 0;
    live[j] = present[j];
    any |= live[j];
  }
  for (int64_t step = 1; any; step <<= 1) {
    any = false;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int64_t probe = last[j] + step;
      const bool need = live[j] && probe < n;
      const bool on = load_if(keys, need, probe) == a[j] && need;
      if (live[j] && !on) {  // the run ends in (last, min(probe, n)]
        hi[j] = last[j] + 1;
        cnt[j] = (probe < n ? probe : n) - hi[j];
      }
      last[j] = on ? probe : last[j];
      live[j] = on;
      any |= on;
    }
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) any |= cnt[j] > 0;
  while (any) {
    any = false;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int64_t half = cnt[j] >> 1;
      const bool go = cnt[j] > 0;
      const int64_t v = load_if(keys, go, hi[j] + half);
      const bool right = go && v == a[j];
      hi[j] += right ? half + 1 : 0;
      cnt[j] = !go ? 0 : right ? cnt[j] - half - 1 : half;
      any |= cnt[j] > 0;
    }
  }
}

// One tile against one index: the verdicts of the thread's kPer queries
// (a, b), whose least and greatest keya over the block are amin and amax.
// `stage` is the block's kCap-entry staging buffer; bounds[2] is scratch.
// Every thread of the block calls it (it holds barriers); it ends with one,
// so the shared memory is free again on return.
__device__ __forceinline__ void join_tile(const int64_t* __restrict__ ika,
                                          const int64_t* __restrict__ ikb,
                                          int64_t mi, const int64_t (&a)[kPer],
                                          const int64_t (&b)[kPer],
                                          int64_t amin, int64_t amax,
                                          int64_t* stage, int cap,
                                          int64_t* bounds,
                                          int8_t (&verdict)[kPer]) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  if (mi == 0) {  // an empty slot (its columns may be null): block-uniform
#pragma unroll
    for (int j = 0; j < kPer; ++j) verdict[j] = kNonmem;
    return;
  }
  if (cap == 0) {  // launch-uniform: no bracket, the range is the index
    if (tid == 0) {
      bounds[0] = 0;
      bounds[1] = mi;
    }
  } else if (warp == 0) {
    const int64_t pos = warp_bound<false>(ika, mi, amin, lane);
    if (lane == 0) bounds[0] = pos;
  } else if (warp == 1) {
    const int64_t pos = warp_bound<true>(ika, mi, amax, lane);
    if (lane == 0) bounds[1] = pos;
  }
  __syncthreads();
  const int64_t left = bounds[0];   // L
  const int64_t right = bounds[1];  // R: every run of the tile ends by here
  const int64_t n = right - left;
  int64_t lo[kPer];  // positions in ika of each query's run [lo, hi)
  int64_t hi[kPer];
  if (n < cap) {  // block-uniform: stage ika[L, R) and search it there
    // stage[0] holds the entry at g0, the 16-byte aligned address at or
    // just below ika + L (g0 may be -1 or hold an entry outside [L, R):
    // such entries are neither copied nor read)
    const int64_t odd = (int64_t)((reinterpret_cast<uintptr_t>(ika) >> 3) & 1);
    const int64_t g0 = left - ((left + odd) & 1);
    const int head = (int)(left - g0);
    const int pairs = ((int)(right - g0) + 1) >> 1;
    const uint32_t dst0 =
        static_cast<uint32_t>(__cvta_generic_to_shared(stage));
    for (int p = tid; p < pairs; p += kThreads) {
      const int64_t g = g0 + 2 * (int64_t)p;
      const uint32_t dst = dst0 + 16u * (uint32_t)p;
      if (g >= left && g + 1 < right) {
        cp_async16(dst, ika + g);
      } else {
        if (g >= left && g < right) cp_async8(dst, ika + g);
        if (g + 1 >= left && g + 1 < right) cp_async8(dst + 8, ika + g + 1);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    int slo[kPer];
    int shi[kPer];
    bisect_staged(stage + head, (int)n, a, slo, shi);
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      lo[j] = left + slo[j];
      hi[j] = left + shi[j];
    }
  } else {  // search ika[L, R) in device memory
    bisect_device(ika, mi, left, right, a, lo);
    bool present[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const bool need = lo[j] < right;
      present[j] = load_if(ika, need, lo[j]) == a[j] && need;
    }
    run_ends(ika, right, a, lo, present, hi);
  }
  // lower bound of keyb inside each present query's run [lo, hi), the kPer
  // bisections in step
  int64_t p[kPer];
  int64_t cnt[kPer];
  bool any = false;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    p[j] = lo[j];
    cnt[j] = hi[j] - lo[j];
    any |= cnt[j] > 0;
  }
  while (any) {
    any = false;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int64_t half = cnt[j] >> 1;
      const bool go = cnt[j] > 0;
      const int64_t v = load_if(ikb, go, p[j] + half);
      const bool right = go && v < b[j];
      p[j] += right ? half + 1 : 0;
      cnt[j] = !go ? 0 : right ? cnt[j] - half - 1 : half;
      any |= cnt[j] > 0;
    }
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const bool need = p[j] < hi[j];
    const int64_t v = load_if(ikb, need, p[j]);
    verdict[j] = hi[j] == lo[j]      ? kNonmem
                 : (need && v == b[j]) ? kConf
                                       : kCand;
  }
  __syncthreads();  // stage and bounds are free for the next slot or tile
}

// The tile's queries into registers (absent ones as key 0, masked at the
// store) and its least and greatest keya into keys[0], keys[1].
__device__ __forceinline__ void load_tile(const int64_t* __restrict__ qa,
                                          const int64_t* __restrict__ qb,
                                          int64_t base, int tile, int64_t m,
                                          int64_t (&a)[kPer],
                                          int64_t (&b)[kPer], int64_t* red,
                                          int64_t* keys) {
  const int tid = threadIdx.x;
  int64_t mn = INT64_MAX;
  int64_t mx = INT64_MIN;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int64_t i = base + j * kThreads + tid;
    a[j] = b[j] = 0;
    if (j * kThreads + tid < tile && i < m) {
      a[j] = qa[i];
      b[j] = qb[i];
      mn = a[j] < mn ? a[j] : mn;
      mx = a[j] > mx ? a[j] : mx;
    }
  }
  mn = warp_min(mn);
  mx = warp_max(mx);
  if ((tid & 31) == 0) {
    red[tid >> 5] = mn;
    red[kWarps + (tid >> 5)] = mx;
  }
  __syncthreads();
  if (tid < 32) {
    mn = warp_min(tid < kWarps ? red[tid] : INT64_MAX);
    mx = warp_max(tid < kWarps ? red[kWarps + tid] : INT64_MIN);
    if (tid == 0) {
      keys[0] = mn;
      keys[1] = mx;
    }
  }
  __syncthreads();
}

__device__ __forceinline__ void store_tile(int8_t* __restrict__ out,
                                           int64_t base, int tile, int64_t m,
                                           const int8_t (&verdict)[kPer]) {
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int64_t i = base + j * kThreads + threadIdx.x;
    if (j * kThreads + threadIdx.x < tile && i < m) out[i] = verdict[j];
  }
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    join_kernel(const int64_t* __restrict__ ika,
                const int64_t* __restrict__ ikb, int64_t mi,
                const int64_t* __restrict__ qa,
                const int64_t* __restrict__ qb, int64_t m, int tile,
                int cap, int8_t* __restrict__ out) {
  extern __shared__ __align__(16) int64_t stage[];
  __shared__ int64_t red[2 * kWarps];
  __shared__ int64_t keys[2];
  __shared__ int64_t bounds[2];
  const int64_t tiles = (m + tile - 1) / tile;
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int64_t base = t * tile;
    int64_t a[kPer];
    int64_t b[kPer];
    int8_t verdict[kPer];
    load_tile(qa, qb, base, tile, m, a, b, red, keys);
    join_tile(ika, ikb, mi, a, b, keys[0], keys[1], stage, cap, bounds,
              verdict);
    store_tile(out, base, tile, m, verdict);
  }
}

// One launch joins the queries against S indexes, out [S, m]: a block keeps
// its tile and walks the `group` slots from blockIdx.y * group on.
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    join_multi_kernel(const int64_t* __restrict__ ika_ptrs,
                      const int64_t* __restrict__ ikb_ptrs,
                      const int64_t* __restrict__ mis, int s, int group,
                      const int64_t* __restrict__ qa,
                      const int64_t* __restrict__ qb, int64_t m, int tile,
                      int cap, int8_t* __restrict__ out) {
  extern __shared__ __align__(16) int64_t stage[];
  __shared__ int64_t red[2 * kWarps];
  __shared__ int64_t keys[2];
  __shared__ int64_t bounds[2];
  const int slot0 = blockIdx.y * group;
  const int slot1 = slot0 + group < s ? slot0 + group : s;
  const int64_t tiles = (m + tile - 1) / tile;
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int64_t base = t * tile;
    int64_t a[kPer];
    int64_t b[kPer];
    int8_t verdict[kPer];
    load_tile(qa, qb, base, tile, m, a, b, red, keys);
    for (int slot = slot0; slot < slot1; ++slot) {
      join_tile(reinterpret_cast<const int64_t*>(ika_ptrs[slot]),
                reinterpret_cast<const int64_t*>(ikb_ptrs[slot]), mis[slot],
                a, b, keys[0], keys[1], stage, cap, bounds, verdict);
      store_tile(out + (int64_t)slot * m, base, tile, m, verdict);
    }
  }
}

// Blocks along x: a tile each, with a grid-stride loop past 2^20 tiles (m up
// to 2^31 queries is 2^21 tiles of 1,024).
unsigned tile_blocks(int64_t m, int tile) {
  int64_t blocks = (m + tile - 1) / tile;
  if (blocks > (int64_t)1 << 20) blocks = (int64_t)1 << 20;
  return (unsigned)blocks;
}

// Slots a block walks: all S where the tiles alone give every SM its blocks,
// fewer (more blocks along y) for a short query stream.
int slots_per_block(int64_t tiles, int s) {
  int device = 0;
  int sms = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess)
    sms = 132;
  const int64_t want = (int64_t)sms * kBlocksPerSm;
  int64_t rows = (want + tiles - 1) / tiles;  // blocks along y that fill it
  if (rows > s) rows = s;
  return (int)((s + rows - 1) / rows);
}

// Dynamic shared memory above 48 KB must be allowed for a kernel first.
template <typename Kernel>
cudaError_t allow_stage(Kernel kernel) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kCap * 8);
}

}  // namespace

// tile: the consecutive queries a block owns, 1 <= tile <= kTile; cap: the
// index entries it may stage, 0 <= cap <= kCap, 0 for a launch that neither
// brackets nor stages. The caller chooses both from the launch's density
// (stream.py: join_launch_geometry). The launch asks for cap * 8 bytes of
// dynamic shared memory, so one that stages nothing leaves the SM's whole
// L1 to the search in device memory.
extern "C" int commet_join(const void* ika, const void* ikb, int64_t mi,
                           const void* qa, const void* qb, int64_t m,
                           int tile, int cap, void* out, void* stream) {
  if (m <= 0) return 0;
  if (tile < 1 || tile > kTile || cap < 0 || cap > kCap)
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = allow_stage(join_kernel);
  if (err != cudaSuccess) return (int)err;
  join_kernel<<<tile_blocks(m, tile), kThreads, (size_t)cap * 8,
                (cudaStream_t)stream>>>(
      (const int64_t*)ika, (const int64_t*)ikb, mi, (const int64_t*)qa,
      (const int64_t*)qb, m, tile, cap, (int8_t*)out);
  return (int)cudaGetLastError();
}

// ika_ptrs / ikb_ptrs: [s] device int64 arrays of the slots' index column
// addresses; mis: [s] device int64 valid lengths; out: [s, m] int8.
extern "C" int commet_join_multi(const void* ika_ptrs, const void* ikb_ptrs,
                                 const void* mis, int64_t s, const void* qa,
                                 const void* qb, int64_t m, int tile, int cap,
                                 void* out, void* stream) {
  if (m <= 0 || s <= 0) return 0;
  if (s > 65535) return (int)cudaErrorInvalidValue;  // gridDim.y limit
  if (tile < 1 || tile > kTile || cap < 0 || cap > kCap)
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = allow_stage(join_multi_kernel);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = tile_blocks(m, tile);
  const int group = slots_per_block(blocks, (int)s);
  const dim3 grid(blocks, (unsigned)((s + group - 1) / group));
  join_multi_kernel<<<grid, kThreads, (size_t)cap * 8,
                      (cudaStream_t)stream>>>(
      (const int64_t*)ika_ptrs, (const int64_t*)ikb_ptrs,
      (const int64_t*)mis, (int)s, group, (const int64_t*)qa,
      (const int64_t*)qb, m, tile, cap, (int8_t*)out);
  return (int)cudaGetLastError();
}
