// K1: block-interleaved rANS encoder for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel fpv_tpu/ops/rans_pallas.py::_encode_kernel
// (launcher encode_pallas, pallas_call at rans_pallas.py:880), and the JAX
// package's host engine for narrow streams (fpv_tpu/ops/rans_numpy.py
// encode_blocks, which codes blocks of 8..512 lanes).  Same stream layout,
// bit for bit (fpv_tpu_torch/ops/rans_layout.py): each block of `lanes`
// lanes walks its chunks' symbols in reverse, segment by segment (SEG_LEN =
// 512 steps), carrying the 31-bit state across segments; per step the
// emitted 16-bit words are appended in lane order.
//
// What bounds it on this card: the per-step dependency chain, not bytes.
// Each step is a table lookup, a u32 division, a block-wide exclusive scan
// of the 1-bit emit flag and (above 32 lanes) a barrier; the symbol stream
// is read once (1 B per symbol, coalesced) and words are written once
// (<= 2 B per symbol).  A batch has few rANS blocks (8 per 32 Mpx plane at
// 4096-symbol chunks; a narrow stream has one), so few SMs are busy
// and each runs one long sequential walk.
//
// What the design does about it: one CTA of `lanes` threads per rANS
// block, thread id = lane, so the lane-parallel state update is one
// thread's scalar code.  The encode table (<= 512 u32) lives in shared
// memory.  The renorm rank is a warp ballot + popc; above 32 lanes a scan
// of the per-warp counts done with shuffles follows, with the counts
// double-buffered so one barrier per step suffices.  At 32 lanes or fewer
// the block is one (partial) warp: the ballot over the member mask gives
// the rank and the total, and no barrier is needed.  Each step's symbols
// (and in ctx16 mode the previous step's, whose prev*2 + (left != right)
// with neighbours wrapping within `lanes` is the context) are loaded one
// step ahead, so the loads leave the step chain.  Each (block, segment)
// writes into its own worst-case region; the host wrapper compacts the
// regions with one masked gather.  None of the TPU machinery (MXU prefix
// sums, binary-search packing, reciprocal division, nsub sub-blocks, VMEM
// window) is needed.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLanes = 1024;
constexpr int kSegLen = 512;
constexpr uint32_t kRansL = 1u << 15;
constexpr unsigned kFull = 0xffffffffu;

// One step's symbols as lane `lane` needs them: its own, and (ctx16) its
// two neighbours, wrapping within the block's lanes; zeros before step 0.
struct Row {
  uint32_t a, l, r;
};

__device__ __forceinline__ Row load_row(const uint8_t* blk, int j, int lane,
                                        int lanes, bool ctx_mode) {
  Row row{0u, 0u, 0u};
  if (j >= 0) {
    const uint8_t* p = blk + (int64_t)j * lanes;
    row.a = p[lane];
    if (ctx_mode) {
      row.l = p[(lane + lanes - 1) & (lanes - 1)];
      row.r = p[(lane + 1) & (lanes - 1)];
    }
  }
  return row;
}

__global__ void __launch_bounds__(kMaxLanes) rans_encode_kernel(
    const uint8_t* __restrict__ syms,   // [nblocks, K, lanes] symbols/nibbles
    const int32_t* __restrict__ lens,   // [nblocks, lanes]
    const uint32_t* __restrict__ fc,    // [nidx] (f-1) | cum << prob_bits
    int nidx, int chunk_len, int prob_bits, int ctx_mode,
    uint32_t* __restrict__ states,      // [nblocks, lanes]
    uint16_t* __restrict__ words,       // [nblocks*nseg, kseg*lanes]
    int32_t* __restrict__ counts)       // [nblocks*nseg]
{
  __shared__ uint32_t tab[512];
  __shared__ int wcnt[2][32];
  const int lanes = blockDim.x;
  const int lane = threadIdx.x;
  const int warp = lane >> 5;
  const int wl = lane & 31;
  const int nwarps = (lanes + 31) >> 5;
  // ballot members: the whole warp, or the low `lanes` bits of a partial one
  const unsigned members = lanes >= 32 ? kFull : (1u << lanes) - 1u;
  const int64_t m = blockIdx.x;
  for (int i = lane; i < nidx; i += lanes) tab[i] = fc[i];
  __syncthreads();

  const int k = chunk_len;
  const int kseg = k < kSegLen ? k : kSegLen;
  const int nseg = k / kseg;
  const int len = lens[m * lanes + lane];
  const uint32_t fmask = (1u << prob_bits) - 1;
  const int renorm_shift = 31 - prob_bits;
  const uint32_t idx_max = (uint32_t)nidx - 1;
  const uint8_t* blk = syms + m * (int64_t)k * lanes;
  const unsigned below = (1u << wl) - 1;
  const bool ctx = ctx_mode != 0;

  uint32_t x = kRansL;
  int buf = 0;
  Row cur = load_row(blk, k - 1, lane, lanes, ctx);   // step j's symbols
  Row prv = load_row(blk, k - 2, lane, lanes, ctx);   // step j-1's
  for (int g = nseg - 1; g >= 0; --g) {
    uint16_t* region = words + (m * nseg + g) * (int64_t)kseg * lanes;
    int ptr = 0;
    const int jlo = g * kseg;
    for (int j = jlo + kseg - 1; j >= jlo; --j) {
      const Row nxt = load_row(blk, j - 2, lane, lanes, ctx);
      const bool active = j < len;
      uint32_t idx = cur.a;
      if (ctx) idx += (prv.a * 2 + (prv.l != prv.r ? 1u : 0u)) * 16;
      const uint32_t e = tab[idx < idx_max ? idx : idx_max];
      const uint32_t f = (e & fmask) + 1;
      const uint32_t cum = e >> prob_bits;
      const bool emit = active && x >= (f << renorm_shift);

      const unsigned ball = __ballot_sync(members, emit);
      int before, total;
      if (nwarps == 1) {
        before = __popc(ball & below);
        total = __popc(ball);
      } else {
        if (wl == 0) wcnt[buf][warp] = __popc(ball);
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
      if (emit) region[ptr + before] = (uint16_t)(x & 0xFFFFu);
      ptr += total;
      if (active) {
        const uint32_t x2 = emit ? (x >> 16) : x;
        const uint32_t q = x2 / f;
        x = (q << prob_bits) + (x2 - q * f) + cum;
      }
      buf ^= 1;
      cur = prv;
      prv = nxt;
    }
    if (lane == 0) counts[m * nseg + g] = ptr;
  }
  states[m * lanes + lane] = x;
}

}  // namespace

extern "C" int fpvt_rans_encode(
    const void* syms, const void* lens, const void* fc, int nidx,
    int nblocks, int lanes, int chunk_len, int prob_bits, int ctx_mode,
    void* states, void* words, void* counts, void* stream) {
  if (nblocks > 0) {
    rans_encode_kernel<<<nblocks, lanes, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)syms, (const int32_t*)lens, (const uint32_t*)fc,
        nidx, chunk_len, prob_bits, ctx_mode, (uint32_t*)states,
        (uint16_t*)words, (int32_t*)counts);
  }
  return (int)cudaGetLastError();
}
