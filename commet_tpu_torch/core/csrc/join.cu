// Sorted-join membership verdicts for the stream probe, hand-written for
// Hopper (sm_90a).
//
// Replaces the TPU kernel commet_tpu/core/stream.py:_join_kernel, through
// both of its single-chip entries: join_membership (one index; exported here
// as commet_join) and _membership_stream_multi, which joins one sorted query
// stream against S indexes (exported as commet_join_multi: one launch per
// group of slots, blockIdx.y the slot, out [S, M]). The TPU kernel streams
// a banded 2*ki x 128 window of the keya-sorted index past each chunk of
// sorted queries in VMEM; the window, the scalar-prefetched window starts,
// pick_chunk and the signed-bias view all exist for the TPU's tiling and
// have no counterpart here. Its multi-index caller packs 15 two-bit
// verdicts per uint32 for a second sort (the unsort); here the verdicts
// stay int8 and the caller scatters them back through the sort permutation.
//
// What it computes, per query pair (qa, qb):
//   CONF   (2) the exact pair (keya, keyb) is in the index;
//   CAND   (1) keya is in the index but the pair is not;
//   NONMEM (0) keya is not in the index.
// Every query is bracketed by a global search, so RESIDUAL (3) never occurs:
// strictly more decided than the TPU kernel, and the verdict sandwich treats
// CAND and RESIDUAL alike, so the final tags are unchanged.
//
// The index holds int64 keys (k <= 36 fits whole), sorted lexicographically
// by (keya, keyb), valid entries in [0, mi).
//
// What bounds it: dependent loads from a multi-GB index. Each query walks a
// binary search of ~log2(mi) levels (26 at 64M entries), each level one
// 8-byte load whose address depends on the previous one; compute is a few
// compares per level. The design keeps those loads cheap rather than
// removing them:
//   - one thread per query, with the queries sorted by keya (the caller's
//     sort), so neighbouring threads of a warp walk the same search path and
//     share cache lines, and the upper levels of the implicit search tree stay
//     resident in the 50 MB L2 across the whole launch;
//   - the keyb search runs only inside the equal-keya run, found by galloping
//     from its start (runs are a few entries long), so it costs O(log run)
//     loads instead of a second full-depth search;
//   - loads go through the read-only path (__ldg).
// Later work: a splitter table in shared memory for the top levels, or a
// cooperative merge of each block's sorted query range against its index
// range, would turn the dependent loads into streamed ones.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int8_t kNonmem = 0;
constexpr int8_t kCand = 1;
constexpr int8_t kConf = 2;

// The verdict of one query pair (a, b) against one index (ika, ikb, mi).
// Shared by the single-index and the grouped kernel so the two cannot drift.
__device__ __forceinline__ int8_t join_one(const int64_t* __restrict__ ika,
                                           const int64_t* __restrict__ ikb,
                                           int64_t mi, int64_t a, int64_t b) {
  // lower bound of keya over [0, mi)
  int64_t lo = 0;
  int64_t n = mi;
  while (n > 0) {
    const int64_t half = n >> 1;
    if (__ldg(ika + lo + half) < a) {
      lo += half + 1;
      n -= half + 1;
    } else {
      n = half;
    }
  }
  if (lo == mi || __ldg(ika + lo) != a) return kNonmem;
  // end of the equal-keya run: gallop from its start, then bisect
  int64_t step = 1;
  int64_t last_eq = lo;  // known member of the run
  while (last_eq + step < mi && __ldg(ika + last_eq + step) == a) {
    last_eq += step;
    step <<= 1;
  }
  int64_t hi = last_eq + step < mi ? last_eq + step : mi;  // ika[hi] != a
  int64_t l2 = last_eq + 1;
  n = hi - l2;
  while (n > 0) {
    const int64_t half = n >> 1;
    if (__ldg(ika + l2 + half) == a) {
      l2 += half + 1;
      n -= half + 1;
    } else {
      n = half;
    }
  }
  hi = l2;  // first entry past the run
  // lower bound of keyb inside the run [lo, hi)
  n = hi - lo;
  while (n > 0) {
    const int64_t half = n >> 1;
    if (__ldg(ikb + lo + half) < b) {
      lo += half + 1;
      n -= half + 1;
    } else {
      n = half;
    }
  }
  return (lo < hi && __ldg(ikb + lo) == b) ? kConf : kCand;
}

__global__ void join_kernel(const int64_t* __restrict__ ika,
                            const int64_t* __restrict__ ikb, int64_t mi,
                            const int64_t* __restrict__ qa,
                            const int64_t* __restrict__ qb, int64_t m,
                            int8_t* __restrict__ out) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < m;
       i += stride) {
    out[i] = join_one(ika, ikb, mi, qa[i], qb[i]);
  }
}

// One launch joins the sorted queries against S indexes: blockIdx.y is the
// slot, out is [S, m]. Blocks are scheduled x-fastest, so the blocks of one
// slot run together and that slot's upper search levels stay in L2.
__global__ void join_multi_kernel(const int64_t* __restrict__ ika_ptrs,
                                  const int64_t* __restrict__ ikb_ptrs,
                                  const int64_t* __restrict__ mis,
                                  const int64_t* __restrict__ qa,
                                  const int64_t* __restrict__ qb, int64_t m,
                                  int8_t* __restrict__ out) {
  const int s = blockIdx.y;
  const int64_t* ika = reinterpret_cast<const int64_t*>(ika_ptrs[s]);
  const int64_t* ikb = reinterpret_cast<const int64_t*>(ikb_ptrs[s]);
  const int64_t mi = mis[s];
  int8_t* o = out + (int64_t)s * m;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < m;
       i += stride) {
    o[i] = join_one(ika, ikb, mi, qa[i], qb[i]);
  }
}

constexpr int kThreads = 256;

unsigned query_blocks(int64_t m) {
  int64_t blocks = (m + kThreads - 1) / kThreads;
  if (blocks > (int64_t)1 << 20) blocks = (int64_t)1 << 20;  // grid-stride
  return (unsigned)blocks;
}

}  // namespace

extern "C" int commet_join(const void* ika, const void* ikb, int64_t mi,
                           const void* qa, const void* qb, int64_t m,
                           void* out, void* stream) {
  if (m <= 0) return 0;
  join_kernel<<<query_blocks(m), kThreads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)ika, (const int64_t*)ikb, mi, (const int64_t*)qa,
      (const int64_t*)qb, m, (int8_t*)out);
  return (int)cudaGetLastError();
}

// ika_ptrs / ikb_ptrs: [s] device int64 arrays of the slots' index column
// addresses; mis: [s] device int64 valid lengths; out: [s, m] int8.
extern "C" int commet_join_multi(const void* ika_ptrs, const void* ikb_ptrs,
                                 const void* mis, int64_t s, const void* qa,
                                 const void* qb, int64_t m, void* out,
                                 void* stream) {
  if (m <= 0 || s <= 0) return 0;
  if (s > 65535) return (int)cudaErrorInvalidValue;  // gridDim.y limit
  const dim3 grid(query_blocks(m), (unsigned)s);
  join_multi_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)ika_ptrs, (const int64_t*)ikb_ptrs,
      (const int64_t*)mis, (const int64_t*)qa, (const int64_t*)qb, m,
      (int8_t*)out);
  return (int)cudaGetLastError();
}
