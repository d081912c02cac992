// Gather and 2-bit pack of one read batch on the card, hand-written for
// Hopper (sm_90a).
//
// Replaces no TPU kernel: commet_tpu packs every batch on the host
// (commet_tpu/engine/engine.py, EncodedSet.gather_packed through the native
// cio_gather_packed) and uploads it, as the port's host route still does
// (engine/engine.py, _host_batch). On the card a set's one-byte codes are
// uploaded once per engine call and each batch is gathered and packed here,
// so the host no longer sets one base at a time for every batch.
//
// Input: codes, every read's one-byte codes (A=0 C=1 G=2 T=3, 4 = invalid)
// back to back, its start 4-byte aligned and its length a multiple of 4;
// offsets [reads] int64, each read's first byte in codes; lengths [reads]
// int32; ids [n] int64, the reads of the batch. Output, as cio_gather_packed
// writes it (commet_tpu_torch/native/src/commet_io.cpp): codes2 [n, nw2]
// words, base p at bits 2*(p%16) of word p/16, 0 where invalid or past the
// read; valid [n, nwv] words, bit p%32 of word p/32 set where base p is
// valid; lens [n] int32, each read's length cut to lpad.
//
// What bounds it: at the main path's shapes (65,536 reads of 100 bp, lpad
// 128) the batch is 6.6 MB of codes read and 3.4 MB of words written, about
// 3 us at 3.35 TB/s, so a launch costs more than the bytes. The design keeps
// every thread's work independent and the stores coalesced:
// - one thread a 32-base word of a read (item = read * nwv + word), so a
//   warp covers whole reads and its valid stores are one contiguous run,
//   its codes2 stores two;
// - a thread loads the (at most 9) aligned 4-byte words that hold its 32
//   bytes, never one past the word that holds the read's last base, and
//   funnel-shifts them into place: no byte loads, no read outside codes;
// - the 32 validity bits and the two code bits of each base are set in
//   registers, and the code bits interleaved into two codes2 words by
//   spreading each 16-bit half.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// Bits 0 .. 15 of v moved to bits 0, 2, 4, .. 30.
__device__ __forceinline__ uint32_t spread16(uint32_t v) {
  uint32_t x = v & 0xFFFFu;
  x = (x | (x << 8)) & 0x00FF00FFu;
  x = (x | (x << 4)) & 0x0F0F0F0Fu;
  x = (x | (x << 2)) & 0x33333333u;
  return (x | (x << 1)) & 0x55555555u;
}

__global__ void __launch_bounds__(kThreads)
    gather_pack_kernel(const uint8_t* __restrict__ codes,
                       const int64_t* __restrict__ offsets,
                       const int32_t* __restrict__ lengths,
                       const int64_t* __restrict__ ids, int64_t n, int lpad,
                       int nw2, int nwv, uint32_t* __restrict__ codes2,
                       uint32_t* __restrict__ valid,
                       int32_t* __restrict__ lens) {
  const int64_t items = n * nwv;
  for (int64_t item = (int64_t)blockIdx.x * kThreads + threadIdx.x;
       item < items; item += (int64_t)gridDim.x * kThreads) {
    const int64_t r = item / nwv;
    const int w = (int)(item - r * nwv);
    const int64_t id = ids[r];
    const int len = min(lengths[id], lpad);
    if (w == 0) lens[r] = len;
    const int m = min(len - 32 * w, 32);  // bases of this word in the read
    uint32_t vd = 0, lo = 0, hi = 0;      // valid, code bit 0, code bit 1
    if (m > 0) {
      const uint8_t* src = codes + offsets[id] + 32 * w;
      const int head = (int)((uintptr_t)src & 3);
      const uint32_t* at = (const uint32_t*)(src - head);
      const int nld = (head + m + 3) >> 2;  // words holding bytes [0, m)
      uint32_t raw[9];
#pragma unroll
      for (int j = 0; j < 9; ++j) raw[j] = j < nld ? __ldg(at + j) : 0u;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint32_t x = __funnelshift_r(raw[j], raw[j + 1], 8 * head);
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int p = 4 * j + b;
          const uint32_t c = (x >> (8 * b)) & 0xFFu;
          const uint32_t ok = (c < 4u) & (p < m);
          vd |= ok << p;
          lo |= (c & ok) << p;
          hi |= ((c >> 1) & ok) << p;
        }
      }
    }
    valid[r * nwv + w] = vd;
    uint32_t* c2 = codes2 + r * nw2 + 2 * w;
    c2[0] = spread16(lo) | (spread16(hi) << 1);
    if (2 * w + 1 < nw2) c2[1] = spread16(lo >> 16) | (spread16(hi >> 16) << 1);
  }
}

}  // namespace

// codes uint8 (4-byte aligned, a multiple of 4 long), offsets [reads] int64,
// lengths [reads] int32, ids [n] int64; codes2 [n, ceil(lpad/16)] and valid
// [n, ceil(lpad/32)] words, lens [n] int32.
extern "C" int commet_gather_pack(const void* codes, const void* offsets,
                                  const void* lengths, const void* ids,
                                  int64_t n, int lpad, void* codes2,
                                  void* valid, void* lens, void* stream) {
  if (n <= 0) return 0;
  const int nw2 = (lpad + 15) / 16, nwv = (lpad + 31) / 32;
  int64_t blocks = (n * nwv + kThreads - 1) / kThreads;
  if (blocks > (int64_t)1 << 20) blocks = (int64_t)1 << 20;  // grid-stride
  gather_pack_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)codes, (const int64_t*)offsets,
      (const int32_t*)lengths, (const int64_t*)ids, n, lpad, nw2, nwv,
      (uint32_t*)codes2, (uint32_t*)valid, (int32_t*)lens);
  return (int)cudaGetLastError();
}
