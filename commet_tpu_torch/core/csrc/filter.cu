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
// operations a word. A warp takes one read and its lanes take consecutive
// code words, so a warp's loads are one coalesced row; per word and code c
// the lanes equal to c are found with an XOR against c's pattern and a
// lane-AND, the word's 16 validity bits are spread to the lanes' low bits,
// and __popc counts; the lanes' counts meet by shuffles.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// Bits 0 .. 15 of v moved to bits 0, 2, 4, .. 30.
__device__ __forceinline__ uint32_t spread16(uint32_t v) {
  uint32_t x = v & 0xFFFFu;
  x = (x | (x << 8)) & 0x00FF00FFu;
  x = (x | (x << 4)) & 0x0F0F0F0Fu;
  x = (x | (x << 2)) & 0x33333333u;
  return (x | (x << 1)) & 0x55555555u;
}

__global__ void class_counts_kernel(const uint32_t* __restrict__ codes2,
                                    int64_t nw2,
                                    const uint32_t* __restrict__ valid,
                                    int64_t nwv,
                                    const int32_t* __restrict__ lengths,
                                    int64_t b, int length,
                                    int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int nw = (length + 15) / 16;  // code words holding [0, length)
  const int64_t warps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  for (int64_t row = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
       row < b; row += warps) {
    const uint32_t* c2 = codes2 + row * nw2;
    const uint32_t* vd = valid + row * nwv;
    int cnt[4] = {0, 0, 0, 0};
    for (int j = lane; j < nw; j += 32) {
      uint32_t v16 = (vd[j >> 1] >> (16 * (j & 1))) & 0xFFFFu;
      const int rem = length - 16 * j;  // positions of this word below length
      if (rem < 16) v16 &= (1u << rem) - 1;
      const uint32_t lanes = spread16(v16);
      const uint32_t w = c2[j];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const uint32_t x = w ^ (0x55555555u * (uint32_t)c);
        cnt[c] += __popc(~(x | (x >> 1)) & lanes);
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        cnt[c] += __shfl_xor_sync(kFull, cnt[c], off);
    if (lane == 0) {
      int32_t* o = out + row * 5;
      o[0] = cnt[0];
      o[1] = cnt[1];
      o[2] = cnt[2];
      o[3] = cnt[3];
      o[4] = lengths[row] - (cnt[0] + cnt[1] + cnt[2] + cnt[3]);
    }
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
  class_counts_kernel<<<grid_for(b, kWarps), kThreads, 0,
                        (cudaStream_t)stream>>>(
      (const uint32_t*)codes2, nw2, (const uint32_t*)valid, nwv,
      (const int32_t*)lengths, b, length, (int32_t*)out);
  return (int)cudaGetLastError();
}
