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
//     the 2-bit codes are unpacked and the forward and reverse-complement
//     keys rolled in registers, so no [B, L] codes or [B, W] keys exist.
//   - commet_probe_planes_multi: the same probe of one batch against S plane
//     sets in one launch (blockIdx.y the slot), which replaces what
//     probe_cascade2_multi_* (kernels.py:604-642) serve in the plane cohorts.
//     The cascade (K7) exists because the TPU's gather rate is its wall; its
//     final tags equal the full probe's, which this probe gives in one pass.
// Both probe kernels call one __device__ function, so S = 1 and S > 1
// cannot drift apart.
//
// Input batch: codes2 [b, nw2] words, base p at bits 2*(p%16) of word p/16
// (A=0 C=1 G=2 T=3); then either (clean) lengths [b] int32, base p valid iff
// p < lengths[row], or validity words [b, nwv], base p valid iff bit p%32 of
// word p/32. Bases at or past `length` (the batch's padded length) are never
// read. An invalid base resets the window (search_reads.h:49-63).
//
// What bounds them:
//   - the build: random atomics into a multi-GB array (4 GiB at k = 33), four
//     per k-mer; the atomics' results are unused, so they issue as
//     fire-and-forget reductions at L2 and the thread never waits on them.
//     One thread per read rolls its windows in registers and issues them.
//   - the probe: dependent random 4-byte loads per window from multi-GB
//     planes that the 50 MB L2 cannot hold. One thread per read; plane A is
//     tested first and B, C and D (three independent loads) only when A's
//     bit is set, so a window that misses costs one load; greedy skipping
//     (a hit at window i makes the next countable window i + k) and the
//     early exit at t hits skip the loads of windows that cannot count; the
//     reverse strand is read only when the forward count stays below t
//     (search_reads.h:64-83).
// Later work: a warp per read with __ballot_sync over 32 windows, a pre-test
// of the bit before the atomic, read-only-path and sector tricks.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

struct Batch {
  const uint32_t* codes2;  // [b, nw2]
  const uint32_t* aux;     // lengths [b] (clean) or validity words [b, nwv]
  int64_t nw2;
  int64_t nwv;
  int clean;
  int64_t b;
  int length;
};

// Streams one read's bases: code (0..3) and validity of position p, in
// order, loading each packed word once.
struct ReadCursor {
  const uint32_t* c2;
  const uint32_t* vd;
  int end;  // positions [0, end) are read
  uint32_t cw = 0;
  uint32_t vw = 0;

  __device__ ReadCursor(const Batch& bt, int64_t row, int limit) {
    c2 = bt.codes2 + row * bt.nw2;
    vd = nullptr;
    end = bt.length < limit ? bt.length : limit;
    if (bt.clean) {
      const int len = reinterpret_cast<const int32_t*>(bt.aux)[row];
      if (len < end) end = len;
    } else {
      vd = bt.aux + row * bt.nwv;
    }
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

__device__ __forceinline__ bool bit_set(const uint32_t* __restrict__ plane,
                                        uint64_t key) {
  return (plane[key >> 5] >> (key & 31)) & 1u;
}

// All four plane bits of the window pair (a, b).
__device__ __forceinline__ bool member(const uint32_t* __restrict__ planes,
                                       int64_t pw, uint64_t a, uint64_t b) {
  if (!bit_set(planes, a)) return false;
  const bool hb = bit_set(planes + pw, b);
  const bool hc = bit_set(planes + 2 * pw, a ^ b);
  const bool hd = bit_set(planes + 3 * pw, a | b);
  return hb && hc && hd;
}

// Greedy non-overlapping member count of one strand of one read, capped at
// t: windows 0 .. wmax-1, a hit at window i makes i + k the next countable
// window (kernels.py _greedy_count).
template <bool kReverse>
__device__ int strand_count(const uint32_t* __restrict__ planes, int64_t pw,
                            const Batch& bt, int64_t row, int k, int t,
                            int wmax) {
  const uint64_t kmask = (k >= 64) ? ~0ull : ((1ull << k) - 1);
  ReadCursor rc(bt, row, wmax + k - 1);
  uint64_t ka = 0, kb = 0;
  int run = 0, cnt = 0, allow = 0;
  for (int p = 0; p < rc.end; ++p) {
    const int c = rc.code(p);
    if (c < 0) {
      run = 0;
      continue;
    }
    const uint64_t abit = (uint64_t)(c >> 1), bbit = (uint64_t)(c & 1);
    if (kReverse) {
      // complement base enters at bit k-1; bit 0 ends up holding the
      // complement of the window's first base
      ka = (ka >> 1) | ((abit ^ 1ull) << (k - 1));
      kb = (kb >> 1) | ((bbit ^ 1ull) << (k - 1));
    } else {
      ka = ((ka << 1) | abit) & kmask;
      kb = ((kb << 1) | bbit) & kmask;
    }
    if (run < k) ++run;
    const int w = p - k + 1;  // window index (ends at p)
    if (run < k || w < allow) continue;
    if (member(planes, pw, ka, kb)) {
      if (++cnt >= t) return cnt;
      allow = w + k;
    }
  }
  return cnt;
}

// Tag of one read: forward strand first, the reverse strand only when the
// forward count stays below t (search_reads.h:64-83).
__device__ __forceinline__ bool probe_read(const uint32_t* __restrict__ planes,
                                           int64_t pw, const Batch& bt,
                                           int64_t row, int k, int t,
                                           int wmax) {
  if (t <= 0) return true;
  if (strand_count<false>(planes, pw, bt, row, k, t, wmax) >= t) return true;
  return strand_count<true>(planes, pw, bt, row, k, t, wmax) >= t;
}

__global__ void build_kernel(uint32_t* __restrict__ planes, int64_t pw,
                             Batch bt, int k) {
  const uint64_t kmask = (k >= 64) ? ~0ull : ((1ull << k) - 1);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       row < bt.b; row += stride) {
    ReadCursor rc(bt, row, bt.length);
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
      atomicOr(planes + (ka >> 5), 1u << (ka & 31));
      atomicOr(planes + pw + (kb >> 5), 1u << (kb & 31));
      atomicOr(planes + 2 * pw + (kc >> 5), 1u << (kc & 31));
      atomicOr(planes + 3 * pw + (kd >> 5), 1u << (kd & 31));
    }
  }
}

__global__ void probe_kernel(const uint32_t* __restrict__ planes, int64_t pw,
                             Batch bt, int k, int t, int wmax,
                             bool* __restrict__ out) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       row < bt.b; row += stride) {
    out[row] = probe_read(planes, pw, bt, row, k, t, wmax);
  }
}

// blockIdx.y is the slot; out is [S, b]. Blocks are scheduled x-fastest, so
// the blocks of one slot run together.
__global__ void probe_multi_kernel(const int64_t* __restrict__ plane_ptrs,
                                   int64_t pw, Batch bt, int k, int t,
                                   int wmax, bool* __restrict__ out) {
  const int s = blockIdx.y;
  const uint32_t* planes = reinterpret_cast<const uint32_t*>(plane_ptrs[s]);
  bool* o = out + (int64_t)s * bt.b;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       row < bt.b; row += stride) {
    o[row] = probe_read(planes, pw, bt, row, k, t, wmax);
  }
}

constexpr int kThreads = 256;

unsigned read_blocks(int64_t b) {
  int64_t blocks = (b + kThreads - 1) / kThreads;
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
  build_kernel<<<read_blocks(b), kThreads, 0, (cudaStream_t)stream>>>(
      (uint32_t*)planes, plane_words,
      make_batch(codes2, nw2, aux, nwv, clean, b, length), k);
  return (int)cudaGetLastError();
}

// out: [b] bool tags.
extern "C" int commet_probe_planes(const void* planes, int64_t plane_words,
                                   const void* codes2, int64_t nw2,
                                   const void* aux, int64_t nwv, int clean,
                                   int64_t b, int length, int k, int t,
                                   int wmax, void* out, void* stream) {
  if (b <= 0) return 0;
  probe_kernel<<<read_blocks(b), kThreads, 0, (cudaStream_t)stream>>>(
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
  if (s > 65535) return (int)cudaErrorInvalidValue;  // gridDim.y limit
  const dim3 grid(read_blocks(b), (unsigned)s);
  probe_multi_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)plane_ptrs, plane_words,
      make_batch(codes2, nw2, aux, nwv, clean, b, length), k, t, wmax,
      (bool*)out);
  return (int)cudaGetLastError();
}
