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
// The rank couples every lane of a block at every step (a lane's read
// position depends on all lanes' renorm flags), and the wire format fixes
// the block, so one CTA per rANS block with one barrier per step stays.
//
// What the design does about it:
// * The word read leaves global memory.  Within a segment the reads move
//   backward through the payload in contiguous runs of at most `lanes`
//   words per step, so the CTA stages the payload ahead of the chain in a
//   shared ring of 8 chunks of max(lanes, 128) words (16 KB at 1024
//   lanes) with cp.async, (kAhead + 1) * lanes words ahead of the read
//   pointer.  A copy is waited on kAhead + 1 steps after it starts, at the
//   step's existing barrier, so the read in the chain is a shared load.
//   Positions outside the staged chunks (a segment's first kAhead + 1
//   steps, or corrupt counts and states) are read from global memory at
//   the same clamped position the plain version reads.  Which chunks may
//   be read is known before the barrier.
// * The rank is a warp ballot + popc plus two redux.sync sums of the
//   per-warp counts (no shuffle scan); in ctx16 mode the neighbours come
//   from shuffles, and only warp-edge lanes read shared memory.  At 32
//   lanes or fewer the block is one (partial) warp and needs no barrier.
//   The step is specialised at compile time for each coding and for
//   narrow or wide blocks (positions are 32-bit, the precisions fixed).
// * One launch decodes several planes (an array of descriptors, one CTA
//   per block of each), so a batch's high and low planes, a frame's
//   covering blocks of both, or the delta section's two planes run side
//   by side.  The 4096-entry fused table (16 KB) lives in shared memory.

// The step (decode_narrow, decode_wide and what they use) lives in
// rans_decode_step.cuh, which rans_decode_variants.cu shares: this file
// instantiates it for K2 alone (variant Production).

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "rans_decode_step.cuh"

namespace {

__global__ void __launch_bounds__(kMaxLanes) rans_decode_kernel(
    const __grid_constant__ DecDescs descs, int ndesc) {
  __shared__ __align__(16) uint32_t tab[kTable];
  __shared__ int wcnt[2][32];
  __shared__ uint8_t prevs[2][kMaxLanes];
  __shared__ __align__(16) uint16_t ring[kRingChunks * kMaxLanes];
  int di = 0;
  while (di + 1 < ndesc && descs.d[di + 1].cta0 <= (long long)blockIdx.x) {
    ++di;
  }
  const DecDesc& d = descs.d[di];
  // 16-byte loads, many in flight: a narrow block has only 8-32 threads
  const uint4* table = (const uint4*)d.table;
#pragma unroll 8
  for (int i = threadIdx.x; i < kTable / 4; i += blockDim.x) {
    reinterpret_cast<uint4*>(tab)[i] = __ldg(table + i);
  }
  for (int i = threadIdx.x; i < kMaxLanes; i += blockDim.x) prevs[0][i] = 0;
  __syncthreads();
  const int lanes = (int)d.lanes;
  const int t = threadIdx.x;
  if (t >= lanes) return;
  if (lanes <= 32) {
    if (d.ctx_mode) decode_narrow<true>(d, t, tab, ring);
    else decode_narrow<false>(d, t, tab, ring);
  } else {
    if (d.ctx_mode) decode_wide<true>(d, t, tab, wcnt, prevs, ring);
    else decode_wide<false>(d, t, tab, wcnt, prevs, ring);
  }
}

}  // namespace

extern "C" int fpvt_rans_decode(const void* descs, int ndesc, int nctas,
                                int threads, void* stream) {
  if (ndesc < 1 || ndesc > kMaxPlanes) return (int)cudaErrorInvalidValue;
  DecDescs p;
  memcpy(p.d, descs, ndesc * sizeof(DecDesc));
  if (nctas > 0) {
    rans_decode_kernel<<<nctas, threads, 0, (cudaStream_t)stream>>>(p,
                                                                    ndesc);
  }
  return (int)cudaGetLastError();
}
