// K2: block-interleaved rANS decoder for Hopper (sm_90a), fused tables.
//
// Replaces the Pallas TPU kernel fpv_tpu/ops/rans_pallas.py::_decode_kernel
// with fused_tab=True (launcher decode_pallas, pallas_call at
// rans_pallas.py:999).  Per step: slot = x & (scale-1); one packed table
// entry (order-0: sym 8 | f-1 12 | off 12 bits; ctx16: index ctx*128+slot,
// sym 4 | f-1 7 | off 7 bits); x' = f*(x >> pb) + off; every lane whose x'
// falls below 2^15 pulls one 16-bit word at its exclusive row-major rank
// among the renormalising lanes, reading each (block, segment) region
// backward from its count.  ok = final x == 2^15 with every segment's
// pointer back at 0, or a lane of length 0.
//
// What bounds it on this card: the per-step dependency chain (lookup ->
// state update -> CTA-wide rank -> word read -> next state), not bytes: the
// payload is read once (~1 B per symbol) and symbols are written once.  Few
// rANS blocks per launch (8 per 32 Mpx plane at 4096-symbol chunks) keep
// most SMs idle.
//
// What the design does about it: one 1024-thread CTA per rANS block,
// thread id = lane.  The 4096-entry fused table (16 KB) lives in shared
// memory, so the lookup is one shared load.  The rank is a warp ballot +
// popc plus a shuffle scan of the 32 per-warp counts; counts and (ctx16)
// the previous step's symbols are double-buffered in shared memory so each
// step needs one barrier.  Words are read from the tight payload at the
// per-(block, segment) start offsets the wrapper passes, so no padded
// window copy is made (the TPU's _expand_payload / 16-row window and its
// select trees are gone).  Out-of-range positions (corrupt input) are
// clamped like the numpy oracle and reported through ok.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 1024;
constexpr int kSegLen = 512;
constexpr int kTable = 4096;
constexpr uint32_t kRansL = 1u << 15;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kLanes) rans_decode_kernel(
    const int32_t* __restrict__ counts,   // [nblocks*nseg] words per group
    const int64_t* __restrict__ starts,   // [nblocks*nseg] group offsets
    const uint32_t* __restrict__ states,  // [nblocks, 1024]
    const int32_t* __restrict__ lens,     // [nblocks, 1024]
    const uint32_t* __restrict__ table,   // [4096] fused entries
    const uint16_t* __restrict__ payload, int64_t total_words,
    int chunk_len, int prob_bits, int ctx_mode,
    uint8_t* __restrict__ out,            // [nblocks, K, 1024]
    int32_t* __restrict__ ok)             // [nblocks, 1024]
{
  __shared__ uint32_t tab[kTable];
  __shared__ int wcnt[2][32];
  __shared__ uint8_t prevs[2][kLanes];
  const int lane = threadIdx.x;
  const int warp = lane >> 5;
  const int wl = lane & 31;
  const int64_t m = blockIdx.x;
  for (int i = lane; i < kTable; i += kLanes) tab[i] = table[i];
  prevs[0][lane] = 0;
  __syncthreads();

  const int k = chunk_len;
  const int kseg = k < kSegLen ? k : kSegLen;
  const int nseg = k / kseg;
  const int sym_bits = ctx_mode ? 4 : 8;
  const uint32_t sym_mask = (1u << sym_bits) - 1;
  const uint32_t fmask = (1u << prob_bits) - 1;
  const int len = lens[m * kLanes + lane];
  const unsigned below = (1u << wl) - 1;
  uint8_t* blk = out + m * (int64_t)k * kLanes;

  uint32_t x = states[m * kLanes + lane];
  bool seg_ok = true;
  int ptr = 0;
  int64_t base = 0;
  int buf = 0;
  for (int j = 0; j < k; ++j) {
    if (j % kseg == 0) {
      const int64_t grp = m * nseg + j / kseg;
      if (j) seg_ok = seg_ok && ptr == 0;
      ptr = counts[grp];
      base = starts[grp];
    }
    const bool active = j < len;
    uint32_t idx = x & fmask;
    if (ctx_mode) {
      const uint32_t a = prevs[buf][lane];
      const uint32_t al = prevs[buf][(lane + kLanes - 1) & (kLanes - 1)];
      const uint32_t ar = prevs[buf][(lane + 1) & (kLanes - 1)];
      idx += (a * 2 + (al != ar ? 1u : 0u)) << prob_bits;
    }
    const uint32_t e = tab[idx];
    const uint32_t sym = e & sym_mask;
    const uint32_t f = ((e >> sym_bits) & fmask) + 1;
    const uint32_t off = e >> (sym_bits + prob_bits);
    uint32_t xn = f * (x >> prob_bits) + off;
    const bool renorm = active && xn < kRansL;

    const unsigned ball = __ballot_sync(kFull, renorm);
    if (wl == 0) wcnt[buf][warp] = __popc(ball);
    if (ctx_mode) prevs[buf ^ 1][lane] = active ? (uint8_t)sym : 0;
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
    if (renorm) {
      int64_t pos = base + (ptr - total) + wbase + __popc(ball & below);
      pos = pos < 0 ? 0 : pos;
      pos = pos > total_words - 1 ? total_words - 1 : pos;
      const uint32_t w = total_words > 0 ? payload[pos] : 0u;
      xn = (xn << 16) | w;
    }
    if (active) x = xn;
    ptr -= total;
    blk[(int64_t)j * kLanes + lane] = active ? (uint8_t)sym : 0;
    buf ^= 1;
  }
  seg_ok = seg_ok && ptr == 0;
  ok[m * kLanes + lane] = ((x == kRansL && seg_ok) || len == 0) ? 1 : 0;
}

}  // namespace

extern "C" int fpvt_rans_decode(
    const void* counts, const void* starts, const void* states,
    const void* lens, const void* table, const void* payload,
    long long total_words, int nblocks, int chunk_len, int prob_bits,
    int ctx_mode, void* out, void* ok, void* stream) {
  if (nblocks > 0) {
    rans_decode_kernel<<<nblocks, kLanes, 0, (cudaStream_t)stream>>>(
        (const int32_t*)counts, (const int64_t*)starts,
        (const uint32_t*)states, (const int32_t*)lens,
        (const uint32_t*)table, (const uint16_t*)payload,
        (int64_t)total_words, chunk_len, prob_bits, ctx_mode,
        (uint8_t*)out, (int32_t*)ok);
  }
  return (int)cudaGetLastError();
}
