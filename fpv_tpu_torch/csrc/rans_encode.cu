// K1: block-interleaved rANS encoder for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel fpv_tpu/ops/rans_pallas.py::_encode_kernel
// (launcher encode_pallas, pallas_call at rans_pallas.py:880).  Same stream
// layout, bit for bit (fpv_tpu_torch/ops/rans_layout.py): each 1024-lane
// block walks its chunks' symbols in reverse, segment by segment (SEG_LEN =
// 512 steps), carrying the 31-bit state across segments; per step the
// emitted 16-bit words are appended in row-major lane order.
//
// What bounds it on this card: the per-step dependency chain, not bytes.
// Each step is a table lookup, a u32 division, a CTA-wide exclusive scan of
// the 1-bit emit flag and a barrier; the symbol stream is read once (1 B per
// symbol, coalesced) and words are written once (<= 2 B per symbol).  A
// batch has few rANS blocks (8 per 32 Mpx plane at 4096-symbol chunks), so
// few SMs are busy and each runs one long sequential walk.
//
// What the design does about it: one 1024-thread CTA per rANS block, thread
// id = lane, so the lane-parallel state update is one thread's scalar code
// and the whole step costs one __syncthreads.  The encode table (<= 512
// u32) lives in shared memory.  The renorm rank is a warp ballot + popc,
// then a 32-entry scan of the per-warp counts done with shuffles; the
// per-warp counts are double-buffered so one barrier per step suffices.  In
// ctx16 mode the context (prev*2 + (left != right)) is read from the
// previous step's symbols in global memory (L1-resident, coalesced).  Each
// (block, segment) writes into its own worst-case region; the host wrapper
// compacts the regions with one masked gather.  None of the TPU machinery
// (MXU prefix sums, binary-search packing, reciprocal division, nsub
// sub-blocks, VMEM window) is needed.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 1024;
constexpr int kSegLen = 512;
constexpr uint32_t kRansL = 1u << 15;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kLanes) rans_encode_kernel(
    const uint8_t* __restrict__ syms,   // [nblocks, K, 1024] symbols/nibbles
    const int32_t* __restrict__ lens,   // [nblocks, 1024]
    const uint32_t* __restrict__ fc,    // [nidx] (f-1) | cum << prob_bits
    int nidx, int chunk_len, int prob_bits, int ctx_mode,
    uint32_t* __restrict__ states,      // [nblocks, 1024]
    uint16_t* __restrict__ words,       // [nblocks*nseg, kseg*1024]
    int32_t* __restrict__ counts)       // [nblocks*nseg]
{
  __shared__ uint32_t tab[512];
  __shared__ int wcnt[2][32];
  const int lane = threadIdx.x;
  const int warp = lane >> 5;
  const int wl = lane & 31;
  const int64_t m = blockIdx.x;
  for (int i = lane; i < nidx; i += kLanes) tab[i] = fc[i];
  __syncthreads();

  const int k = chunk_len;
  const int kseg = k < kSegLen ? k : kSegLen;
  const int nseg = k / kseg;
  const int len = lens[m * kLanes + lane];
  const uint32_t fmask = (1u << prob_bits) - 1;
  const int renorm_shift = 31 - prob_bits;
  const uint32_t idx_max = (uint32_t)nidx - 1;
  const uint8_t* blk = syms + m * (int64_t)k * kLanes;
  const unsigned below = (1u << wl) - 1;

  uint32_t x = kRansL;
  int buf = 0;
  for (int g = nseg - 1; g >= 0; --g) {
    uint16_t* region = words + (m * nseg + g) * (int64_t)kseg * kLanes;
    int ptr = 0;
    const int jlo = g * kseg;
    for (int j = jlo + kseg - 1; j >= jlo; --j) {
      const bool active = j < len;
      uint32_t idx = blk[(int64_t)j * kLanes + lane];
      if (ctx_mode) {
        uint32_t ctx = 0;
        if (j > 0) {
          const uint8_t* p = blk + (int64_t)(j - 1) * kLanes;
          const uint32_t a = p[lane];
          const uint32_t al = p[(lane + kLanes - 1) & (kLanes - 1)];
          const uint32_t ar = p[(lane + 1) & (kLanes - 1)];
          ctx = a * 2 + (al != ar ? 1u : 0u);
        }
        idx = ctx * 16 + idx;
      }
      const uint32_t e = tab[idx < idx_max ? idx : idx_max];
      const uint32_t f = (e & fmask) + 1;
      const uint32_t cum = e >> prob_bits;
      const bool emit = active && x >= (f << renorm_shift);

      const unsigned ball = __ballot_sync(kFull, emit);
      if (wl == 0) wcnt[buf][warp] = __popc(ball);
      __syncthreads();
      const int v = wcnt[buf][wl];
      int incl = v;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(kFull, incl, o);
        if (wl >= o) incl += t;
      }
      const int total = __shfl_sync(kFull, incl, 31);
      const int wbase = __shfl_sync(kFull, incl - v, warp);
      if (emit) {
        region[ptr + wbase + __popc(ball & below)] = (uint16_t)(x & 0xFFFFu);
      }
      ptr += total;
      if (active) {
        const uint32_t x2 = emit ? (x >> 16) : x;
        const uint32_t q = x2 / f;
        x = (q << prob_bits) + (x2 - q * f) + cum;
      }
      buf ^= 1;
    }
    if (lane == 0) counts[m * nseg + g] = ptr;
  }
  states[m * kLanes + lane] = x;
}

}  // namespace

extern "C" int fpvt_rans_encode(
    const void* syms, const void* lens, const void* fc, int nidx,
    int nblocks, int chunk_len, int prob_bits, int ctx_mode,
    void* states, void* words, void* counts, void* stream) {
  if (nblocks > 0) {
    rans_encode_kernel<<<nblocks, kLanes, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)syms, (const int32_t*)lens, (const uint32_t*)fc,
        nidx, chunk_len, prob_bits, ctx_mode, (uint32_t*)states,
        (uint16_t*)words, (int32_t*)counts);
  }
  return (int)cudaGetLastError();
}
