// K2's measurement variants for Hopper (sm_90a): latency replicas and
// launch variants of the rANS decoder, for ops/rans_bound.py.
//
// Replaces the variants of the Pallas TPU kernel
// fpv_tpu/ops/rans_pallas.py::_decode_kernel (launcher decode_pallas,
// pallas_call at rans_pallas.py:999) that only rans_bound reaches:
// stub_tables (:531-537), stub_window (:574-582), stub_class (:544-554),
// fused_tab=False (:559-571), prob_bits other than 12 (:698) and nsub
// (:946, :975-998).  slim_carry (:617-622) has no variant: K2's order-0
// step writes each symbol out and no later step reads it, so K2 already is
// the slim carry.
//
// Each variant is rans_decode_step.cuh's decode_wide instantiated with one
// flag of its Variant set, so a replica differs from K2 only in the part
// its flag names.  Only wide blocks (64 lanes or more) and only the
// combinations the reports use are instantiated (the list in
// fpvt_rans_decode_variant below; ops/rans_cuda.py VARIANTS), with every
// flag off as the control: K2's step in this kernel's frame (dynamic
// shared memory, one coding, wide blocks only).
//
// What bounds it, and the design: as K2 (rans_decode.cu).  The variants
// keep every table, ring and count in dynamic shared memory, sized per
// variant: three table copies (48 KB) or eight rings (128 KB) do not fit
// the 48 KB of static shared memory, so each kernel's limit is raised with
// cudaFuncSetAttribute before its first launch.  __launch_bounds__(1024)
// holds every variant to 64 registers a thread, so each launches at 1024
// lanes; nsub 4 and 8 spill (the ptxas report in <library>.log says how
// much), and the reports' times say what that costs.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "rans_decode_step.cuh"

namespace {

// Table words a variant keeps in shared memory (none for the stubs).
template <bool kCtx, class V>
__host__ __device__ constexpr int table_words() {
  if (V::kStubTables) return 0;
  if (V::kTwoTable) return kTwoTableWords;
  const int fused = kCtx ? kTable : 1 << V::kProbBits;
  return V::kClasses > 0 ? fused * V::kClasses : fused;
}

// Dynamic shared memory: the table, then per chain its per-warp counts
// [2][32], its ctx16 neighbours [2][kMaxLanes] and its ring.
template <bool kCtx, class V>
__host__ __device__ constexpr int smem_bytes() {
  return table_words<kCtx, V>() * 4 +
         V::kNsub * (2 * 32 * 4 + 2 * kMaxLanes +
                     kRingChunks * kMaxLanes * 2);
}

template <bool kCtx, class V>
__global__ void __launch_bounds__(kMaxLanes) rans_decode_variant_kernel(
    const __grid_constant__ DecDescs descs, int ndesc) {
  constexpr int kN = V::kNsub;
  constexpr int kWords = table_words<kCtx, V>();
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* tab = reinterpret_cast<uint32_t*>(smem);
  int(*wcnt)[32] = reinterpret_cast<int(*)[32]>(smem + kWords * 4);
  uint8_t(*prevs)[kMaxLanes] = reinterpret_cast<uint8_t(*)[kMaxLanes]>(
      smem + kWords * 4 + kN * 2 * 32 * 4);
  uint16_t* ring = reinterpret_cast<uint16_t*>(
      smem + kWords * 4 + kN * (2 * 32 * 4 + 2 * kMaxLanes));
  int di = 0;
  while (di + 1 < ndesc && descs.d[di + 1].cta0 <= (long long)blockIdx.x) {
    ++di;
  }
  const DecDesc& d = descs.d[di];
  const uint4* table = (const uint4*)d.table;
#pragma unroll 8
  for (int i = threadIdx.x; i < kWords / 4; i += blockDim.x) {
    reinterpret_cast<uint4*>(tab)[i] = __ldg(table + i);
  }
  for (int i = threadIdx.x; i < kN * kMaxLanes; i += blockDim.x) {
    prevs[2 * (i / kMaxLanes)][i % kMaxLanes] = 0;
  }
  __syncthreads();
  const int t = threadIdx.x;
  if (t >= (int)d.lanes) return;
  decode_wide<kCtx, V>(d, t, tab, wcnt, prevs, ring);
}

template <bool kCtx, class V>
int launch(const DecDescs& p, int ndesc, int nctas, int threads,
           cudaStream_t stream) {
  constexpr int bytes = smem_bytes<kCtx, V>();
  // once per kernel and card (idempotent, so a race between host threads
  // is benign)
  static unsigned long long raised = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const unsigned long long bit = 1ull << (dev & 63);
  if (!(raised & bit)) {
    e = cudaFuncSetAttribute(rans_decode_variant_kernel<kCtx, V>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
    if (e != cudaSuccess) return (int)e;
    raised |= bit;
  }
  if (nctas > 0) {
    rans_decode_variant_kernel<kCtx, V>
        <<<nctas, threads, bytes, stream>>>(p, ndesc);
  }
  return (int)cudaGetLastError();
}

// Variant<StubTables, StubWindow, Classes, ProbBits, TwoTable, Nsub>
using StubT = Variant<true, false, 0, 12, false, 1>;
using StubTW = Variant<true, true, 0, 12, false, 1>;
using Cls2 = Variant<false, false, 2, 12, false, 1>;
using Cls3 = Variant<false, false, 3, 12, false, 1>;
using Pb11 = Variant<false, false, 0, 11, false, 1>;
using Pb10 = Variant<false, false, 0, 10, false, 1>;
using Two = Variant<false, false, 0, 12, true, 1>;
using Nsub2 = Variant<false, false, 0, 12, false, 2>;
using Nsub4 = Variant<false, false, 0, 12, false, 4>;
using Nsub8 = Variant<false, false, 0, 12, false, 8>;

}  // namespace

// One launch of a variant on ndesc planes of one coding (ctx): nctas CTAs
// of `threads` threads (a CTA per nsub blocks).  Returns
// cudaErrorInvalidValue for a combination that is not instantiated.
extern "C" int fpvt_rans_decode_variant(const void* descs, int ndesc,
                                        int nctas, int threads,
                                        int stub_tables, int stub_window,
                                        int classes, int prob_bits,
                                        int two_table, int nsub, int ctx,
                                        void* stream) {
  if (ndesc < 1 || ndesc > kMaxPlanes) return (int)cudaErrorInvalidValue;
  DecDescs p;
  memcpy(p.d, descs, ndesc * sizeof(DecDesc));
  cudaStream_t s = (cudaStream_t)stream;
  // ctx16's precision is fixed (7); prob_bits varies order-0 only
  const bool plain = !stub_tables && !stub_window && !classes &&
                     (ctx || prob_bits == 12) && !two_table;
  if (ctx) {
    if (!stub_tables && !stub_window) {
      if (classes == 2 && !two_table && nsub == 1)
        return launch<true, Cls2>(p, ndesc, nctas, threads, s);
      if (classes == 3 && !two_table && nsub == 1)
        return launch<true, Cls3>(p, ndesc, nctas, threads, s);
      if (!classes && two_table && nsub == 1)
        return launch<true, Two>(p, ndesc, nctas, threads, s);
    }
    if (plain && nsub == 1) return launch<true, Production>(p, ndesc, nctas,
                                                            threads, s);
    if (plain && nsub == 2) return launch<true, Nsub2>(p, ndesc, nctas,
                                                       threads, s);
    if (plain && nsub == 4) return launch<true, Nsub4>(p, ndesc, nctas,
                                                       threads, s);
    if (plain && nsub == 8) return launch<true, Nsub8>(p, ndesc, nctas,
                                                       threads, s);
    return (int)cudaErrorInvalidValue;
  }
  if (nsub == 1 && stub_tables && !classes && prob_bits == 12 && !two_table)
    return stub_window ? launch<false, StubTW>(p, ndesc, nctas, threads, s)
                       : launch<false, StubT>(p, ndesc, nctas, threads, s);
  if (nsub == 1 && !stub_tables && !stub_window) {
    if (classes == 2 && prob_bits == 12 && !two_table)
      return launch<false, Cls2>(p, ndesc, nctas, threads, s);
    if (classes == 3 && prob_bits == 12 && !two_table)
      return launch<false, Cls3>(p, ndesc, nctas, threads, s);
    if (!classes && prob_bits == 11 && !two_table)
      return launch<false, Pb11>(p, ndesc, nctas, threads, s);
    if (!classes && prob_bits == 10 && !two_table)
      return launch<false, Pb10>(p, ndesc, nctas, threads, s);
    if (!classes && prob_bits == 12 && two_table)
      return launch<false, Two>(p, ndesc, nctas, threads, s);
  }
  if (plain && nsub == 1) return launch<false, Production>(p, ndesc, nctas,
                                                           threads, s);
  if (plain && nsub == 2) return launch<false, Nsub2>(p, ndesc, nctas,
                                                      threads, s);
  if (plain && nsub == 4) return launch<false, Nsub4>(p, ndesc, nctas,
                                                      threads, s);
  if (plain && nsub == 8) return launch<false, Nsub8>(p, ndesc, nctas,
                                                      threads, s);
  return (int)cudaErrorInvalidValue;
}
