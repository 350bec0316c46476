// K2: block-interleaved rANS decoder for Hopper (sm_90a), fused tables.
//
// Replaces the Pallas TPU kernel fpv_tpu/ops/rans_pallas.py::_decode_kernel
// with fused_tab=True (launcher decode_pallas, pallas_call at
// rans_pallas.py:999), and the JAX package's host engine for narrow
// streams (fpv_tpu/ops/rans_numpy.py decode_blocks / decode_blocks_ctx,
// blocks of 8..512 lanes).  Per step: slot = x & (scale-1); one packed
// table entry (order-0: sym 8 | f-1 12 | off 12 bits; ctx16: index
// ctx*128+slot, sym 4 | f-1 7 | off 7 bits); x' = f*(x >> pb) + off; every
// lane whose x' falls below 2^15 pulls one 16-bit word at its exclusive
// lane-order rank among the renormalising lanes, reading each (block,
// segment) region backward from its count.  ok = final x == 2^15 with
// every segment's pointer back at 0, or a lane of length 0.
//
// What bounds it on this card: the per-step dependency chain (lookup ->
// state update -> block-wide rank -> word read -> next state), not bytes:
// the payload is read once (~1 B per symbol) and symbols are written once.
// Few rANS blocks per launch (8 per 32 Mpx plane at 4096-symbol chunks; one
// for a narrow stream, 1-2 for a random-access frame) keep most SMs idle.
//
// What the design does about it: one CTA of `lanes` threads per rANS
// block, thread id = lane.  The 4096-entry fused table (16 KB) lives in
// shared memory, so the lookup is one shared load.  Above 32 lanes the
// rank is a warp ballot + popc plus a shuffle scan of the per-warp counts;
// counts and (ctx16) the previous step's symbols are double-buffered in
// shared memory so each step needs one barrier.  At 32 lanes or fewer the
// block is one (partial) warp: the ballot over the member mask gives rank
// and total, the ctx16 neighbours come from shuffles within `lanes`, and
// no barrier is needed.  Words are read from the payload at the
// per-(block, segment) start offsets the wrapper passes, so no padded
// window copy is made (the TPU's _expand_payload / 16-row window and its
// select trees are gone), and a random-access decode passes only its
// blocks' slice.  Out-of-range positions (corrupt input) are clamped like
// the numpy oracle and reported through ok.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLanes = 1024;
constexpr int kSegLen = 512;
constexpr int kTable = 4096;
constexpr uint32_t kRansL = 1u << 15;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kMaxLanes) rans_decode_kernel(
    const int32_t* __restrict__ counts,   // [nblocks*nseg] words per group
    const int64_t* __restrict__ starts,   // [nblocks*nseg] group offsets
    const uint32_t* __restrict__ states,  // [nblocks, lanes]
    const int32_t* __restrict__ lens,     // [nblocks, lanes]
    const uint32_t* __restrict__ table,   // [4096] fused entries
    const uint16_t* __restrict__ payload, int64_t total_words,
    int chunk_len, int prob_bits, int ctx_mode,
    uint8_t* __restrict__ out,            // [nblocks, K, lanes]
    int32_t* __restrict__ ok)             // [nblocks, lanes]
{
  __shared__ uint32_t tab[kTable];
  __shared__ int wcnt[2][32];
  __shared__ uint8_t prevs[2][kMaxLanes];
  const int lanes = blockDim.x;
  const int lane = threadIdx.x;
  const int warp = lane >> 5;
  const int wl = lane & 31;
  const int nwarps = (lanes + 31) >> 5;
  // ballot members: the whole warp, or the low `lanes` bits of a partial one
  const unsigned members = lanes >= 32 ? kFull : (1u << lanes) - 1u;
  const int64_t m = blockIdx.x;
  for (int i = lane; i < kTable; i += lanes) tab[i] = table[i];
  prevs[0][lane] = 0;
  __syncthreads();

  const int k = chunk_len;
  const int kseg = k < kSegLen ? k : kSegLen;
  const int nseg = k / kseg;
  const int sym_bits = ctx_mode ? 4 : 8;
  const uint32_t sym_mask = (1u << sym_bits) - 1;
  const uint32_t fmask = (1u << prob_bits) - 1;
  const int len = lens[m * lanes + lane];
  const unsigned below = (1u << wl) - 1;
  const int left = (lane + lanes - 1) & (lanes - 1);
  const int right = (lane + 1) & (lanes - 1);
  uint8_t* blk = out + m * (int64_t)k * lanes;

  uint32_t x = states[m * lanes + lane];
  uint32_t prev = 0;  // this lane's previous-step symbol (0 when inactive)
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
      uint32_t al, ar;
      if (nwarps == 1) {
        al = __shfl_sync(members, prev, left, lanes);
        ar = __shfl_sync(members, prev, right, lanes);
      } else {
        al = prevs[buf][left];
        ar = prevs[buf][right];
      }
      idx += (prev * 2 + (al != ar ? 1u : 0u)) << prob_bits;
    }
    const uint32_t e = tab[idx];
    const uint32_t sym = e & sym_mask;
    const uint32_t f = ((e >> sym_bits) & fmask) + 1;
    const uint32_t off = e >> (sym_bits + prob_bits);
    uint32_t xn = f * (x >> prob_bits) + off;
    const bool renorm = active && xn < kRansL;
    prev = active ? sym : 0u;

    const unsigned ball = __ballot_sync(members, renorm);
    int before, total;
    if (nwarps == 1) {
      before = __popc(ball & below);
      total = __popc(ball);
    } else {
      if (wl == 0) wcnt[buf][warp] = __popc(ball);
      if (ctx_mode) prevs[buf ^ 1][lane] = (uint8_t)prev;
      __syncthreads();
      const int v = wl < nwarps ? wcnt[buf][wl] : 0;
      int incl = v;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(kFull, incl, o);
        if (wl >= o) incl += t;
      }
      total = __shfl_sync(kFull, incl, 31);
      before = __shfl_sync(kFull, incl - v, warp) + __popc(ball & below);
    }
    if (renorm) {
      int64_t pos = base + (ptr - total) + before;
      pos = pos < 0 ? 0 : pos;
      pos = pos > total_words - 1 ? total_words - 1 : pos;
      const uint32_t w = total_words > 0 ? payload[pos] : 0u;
      xn = (xn << 16) | w;
    }
    if (active) x = xn;
    ptr -= total;
    blk[(int64_t)j * lanes + lane] = (uint8_t)prev;
    buf ^= 1;
  }
  seg_ok = seg_ok && ptr == 0;
  ok[m * lanes + lane] = ((x == kRansL && seg_ok) || len == 0) ? 1 : 0;
}

}  // namespace

extern "C" int fpvt_rans_decode(
    const void* counts, const void* starts, const void* states,
    const void* lens, const void* table, const void* payload,
    long long total_words, int nblocks, int lanes, int chunk_len,
    int prob_bits, int ctx_mode, void* out, void* ok, void* stream) {
  if (nblocks > 0) {
    rans_decode_kernel<<<nblocks, lanes, 0, (cudaStream_t)stream>>>(
        (const int32_t*)counts, (const int64_t*)starts,
        (const uint32_t*)states, (const int32_t*)lens,
        (const uint32_t*)table, (const uint16_t*)payload,
        (int64_t)total_words, chunk_len, prob_bits, ctx_mode,
        (uint8_t*)out, (int32_t*)ok);
  }
  return (int)cudaGetLastError();
}
