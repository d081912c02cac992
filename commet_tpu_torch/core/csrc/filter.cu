// Per-read symbol-class counts for the read filter, hand-written for Hopper
// (sm_90a).
//
// Replaces K10, commet_tpu/core/kernels.py class_counts_packed
// (kernels.py:830-846, behind core/filter.py filter_batch_device): per read
// the counts of A, C, G and T among its valid positions below the batch's
// padded length, and "other" = the read's length less their sum (an N is
// invalid in the validity words, as padding is). The float32-exact Shannon
// epilogue stays on the host.
//
// Input batch: codes2 [b, nw2] words, base p at bits 2*(p%16) of word p/16
// (A=0 C=1 G=2 T=3); valid [b, nwv] words, base p valid iff bit p%32 of word
// p/32; lengths [b] int32. Output: [b, 5] int32.
//
// What bounds it: one pass over the packed batch (2 bits and 1 validity bit
// a base) and 20 bytes written a read; the arithmetic is a few bit
// operations a word, so the bytes bound it (at 4M reads of 128 positions,
// 288 MB). The design keeps every lane loading and every store coalesced:
// - a read takes a group of G lanes, G the power of two at or above its
//   count of 64-base quads (ceil(nw / 4), nw the code words below the
//   length; at most 32), so a warp holds 32 / G reads: 16 reads of two lanes
//   at 128 positions. A lane loads a quad's 4 code words with one 16-byte
//   load and its 2 validity words with one 8-byte load where the rows'
//   widths and the pointers allow it (else word by word), and loops over
//   quads when a read has more than 32;
// - per code word the lane counts the 4 classes with 4 popcounts: of the
//   valid positions (validity bits spread to the codes' low bits), of the
//   low code bits, of the high ones and of both (T); C, G and A follow;
// - counts meet inside the group in log2(G) shuffle steps;
// - a block's [reads, 5] outputs are staged in shared memory and written
//   as one contiguous run by all its threads.
// The block strides over the batch (a grid-stride loop), 8 warps of 32 / G
// reads an iteration.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kLow = 0x55555555u;

// Bits 0 .. 15 of v moved to bits 0, 2, 4, .. 30.
__device__ __forceinline__ uint32_t spread16(uint32_t v) {
  uint32_t x = v & 0xFFFFu;
  x = (x | (x << 8)) & 0x00FF00FFu;
  x = (x | (x << 4)) & 0x0F0F0F0Fu;
  x = (x | (x << 2)) & 0x33333333u;
  return (x | (x << 1)) & kLow;
}

// Adds the class counts of code word w, whose first position is p0, to
// cnt: its 16 validity bits are v16, positions at or past length do not
// count.
__device__ __forceinline__ void count_word(uint32_t w, uint32_t v16, int p0,
                                           int length, int cnt[4]) {
  const int rem = length - p0;
  if (rem <= 0) return;
  if (rem < 16) v16 &= (1u << rem) - 1;
  const uint32_t lanes = spread16(v16);
  const uint32_t lo = w & lanes, hi = (w >> 1) & lanes;
  const int t = __popc(lo & hi);
  const int c = __popc(lo) - t, g = __popc(hi) - t;
  cnt[0] += __popc(lanes) - t - c - g;
  cnt[1] += c;
  cnt[2] += g;
  cnt[3] += t;
}

// kVec: codes2 rows are 16-byte aligned whole quads (nw2 % 4 == 0) and
// valid rows 8-byte aligned pairs (nwv % 2 == 0), so a quad is one 16-byte
// load and its validity one 8-byte load.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    class_counts_kernel(const uint32_t* __restrict__ codes2, int64_t nw2,
                        const uint32_t* __restrict__ valid, int64_t nwv,
                        const int32_t* __restrict__ lengths, int64_t b,
                        int length, int log2g, int32_t* __restrict__ out) {
  __shared__ int32_t staged[kThreads * 5];  // at most 256 reads a block
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = 1 << log2g, sub = lane & (g - 1);
  const int per_warp = 32 >> log2g, per_block = kWarps * per_warp;
  const int nw = (length + 15) / 16;  // code words holding [0, length)
  const int nq = (nw + 3) / 4;        // quads of 4 words (64 positions)
  const int slot = warp * per_warp + (lane >> log2g);
  for (int64_t base = (int64_t)blockIdx.x * per_block; base < b;
       base += (int64_t)gridDim.x * per_block) {
    const int64_t row = base + slot;
    int cnt[4] = {0, 0, 0, 0};
    if (row < b) {
      const uint32_t* c2 = codes2 + row * nw2;
      const uint32_t* vd = valid + row * nwv;
      for (int q = sub; q < nq; q += g) {
        uint32_t w[4], v[2];
        if (kVec) {
          const uint4 w4 = reinterpret_cast<const uint4*>(c2)[q];
          const uint2 v2 = reinterpret_cast<const uint2*>(vd)[q];
          w[0] = w4.x; w[1] = w4.y; w[2] = w4.z; w[3] = w4.w;
          v[0] = v2.x; v[1] = v2.y;
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            w[j] = 4 * q + j < nw ? c2[4 * q + j] : 0;
#pragma unroll
          for (int j = 0; j < 2; ++j)
            v[j] = 2 * q + j < nwv && 32 * (2 * q + j) < length
                       ? vd[2 * q + j] : 0;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
          count_word(w[j], v[j >> 1] >> (16 * (j & 1)), 64 * q + 16 * j,
                     length, cnt);
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      for (int off = g >> 1; off > 0; off >>= 1)
        cnt[c] += __shfl_xor_sync(kFull, cnt[c], off);
    if (sub == 0 && row < b) {
      int32_t* o = staged + slot * 5;
      o[0] = cnt[0];
      o[1] = cnt[1];
      o[2] = cnt[2];
      o[3] = cnt[3];
      o[4] = lengths[row] - (cnt[0] + cnt[1] + cnt[2] + cnt[3]);
    }
    __syncthreads();
    const int64_t rows = b - base < per_block ? b - base : per_block;
    int32_t* dst = out + base * 5;
    for (int i = threadIdx.x; i < rows * 5; i += kThreads) dst[i] = staged[i];
    __syncthreads();
  }
}

unsigned grid_for(int64_t units, int per_block) {
  int64_t blocks = (units + per_block - 1) / per_block;
  if (blocks > (int64_t)1 << 20) blocks = (int64_t)1 << 20;  // grid-stride
  return (unsigned)blocks;
}

}  // namespace

// codes2 [b, nw2], valid [b, nwv] words, lengths [b] int32; out [b, 5] int32.
extern "C" int commet_class_counts(const void* codes2, int64_t nw2,
                                   const void* valid, int64_t nwv,
                                   const void* lengths, int64_t b, int length,
                                   void* out, void* stream) {
  if (b <= 0) return 0;
  const int nq = ((length + 15) / 16 + 3) / 4;
  int log2g = 0;
  while (log2g < 5 && (1 << log2g) < nq) ++log2g;
  const bool vec = nw2 % 4 == 0 && nwv % 2 == 0 &&
                   (uintptr_t)codes2 % 16 == 0 && (uintptr_t)valid % 8 == 0;
  const unsigned grid = grid_for(b, kWarps * (32 >> log2g));
  cudaStream_t s = (cudaStream_t)stream;
  const uint32_t* c2 = (const uint32_t*)codes2;
  const uint32_t* vd = (const uint32_t*)valid;
  const int32_t* ln = (const int32_t*)lengths;
  if (vec)
    class_counts_kernel<true><<<grid, kThreads, 0, s>>>(
        c2, nw2, vd, nwv, ln, b, length, log2g, (int32_t*)out);
  else
    class_counts_kernel<false><<<grid, kThreads, 0, s>>>(
        c2, nw2, vd, nwv, ln, b, length, log2g, (int32_t*)out);
  return (int)cudaGetLastError();
}
