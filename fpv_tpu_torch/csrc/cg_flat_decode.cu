// K4: flat clamped-gradient (CG) inverse of the FPV1 profile, for Hopper
// (sm_90a).
//
// Not a TPU kernel: the JAX package runs this scan on the host
// (fpv_tpu/models/predictors.py:103 cg_decode, native/fpv_native.cc:173).
// Input res [B, R, X] u8, output out of the same shape.  Per frame, over
// the flat index i < R*X: out[i] = res[i] for i <= X; otherwise
// out[i] = res[i] + CG(out[i-X], out[i-1], out[i-X-1]) mod 256 with
// CG(n, w, nw) = clamp(n + w - nw, min(n, w), max(n, w))
// (fusion_power_video.cc:247-252, 326-333).  A column-0 pixel's west
// neighbour is the previous row's last pixel, so a frame is ONE chain of
// R*X - X - 1 dependent steps; if R < 2 the output is a copy.
//
// What bounds it on this card: that chain.  The bytes (1 in, 1 out per
// pixel) take 0.6 us per 1024^2 frame at 3.35 TB/s; the chain takes R*X
// times the latency of one step.
//
// What the design does about it (the simple design; a parallel one is an
// open question in PERF.md):
//   * one 32-thread CTA per frame, so a batch's frames walk in parallel on
//     separate SMs; the CTA's threads copy the verbatim head (i <= X), then
//     lane 0 walks the chain alone;
//   * w is the previous output, kept in a register, and nw the previous
//     step's n, so a step reads one new byte of out, out[i-X], from the
//     finished row above, and one byte of res; neither is on the chain;
//   * the chain is the median form of CG, med3(n, w, w + (n - nw)), whose
//     n - nw is off the chain: max, min, max, add, mask = 5 dependent
//     integer operations a step;
//   * for X >= 64 the walk runs in blocks of 32 steps, and the 64 bytes a
//     block needs (32 of res, 32 of the row above) are loaded while the
//     previous block computes, so their latency is off the chain; a block
//     ahead never reads outputs of the block in flight, since
//     i + 63 - X < i.  Narrower frames (and the tail) step one pixel at a
//     time.
// Offsets are int64, so a frame of 65536 x 65536 has no size cliff.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;
constexpr int kBlock = 32;  // steps per prefetched block

__device__ __forceinline__ uint32_t step(uint32_t r, uint32_t n, uint32_t w,
                                         uint32_t nw) {
  // clamp(n + w - nw, min, max) == med3(n, w, n + w - nw) in exact ints
  const int lo = min((int)n, (int)w);
  const int hi = max((int)n, (int)w);
  const int g = (int)w + ((int)n - (int)nw);
  return (r + (uint32_t)max(lo, min(hi, g))) & 0xFFu;
}

__global__ void __launch_bounds__(kThreads)
    cg_flat_decode_kernel(const uint8_t* __restrict__ res,
                          uint8_t* __restrict__ out, long long size,
                          long long x) {
  const long long base = (long long)blockIdx.x * size;
  const uint8_t* r = res + base;
  uint8_t* o = out + base;
  const long long head = size < x + 1 ? size : x + 1;
  for (long long j = threadIdx.x; j < head; j += kThreads) o[j] = r[j];
  __syncthreads();
  if (threadIdx.x != 0 || head == size) return;

  uint32_t w = o[x];
  uint32_t nw = o[0];
  long long i = x + 1;
  if (x >= 2 * kBlock) {
    const long long nblk = (size - i) / kBlock;
    uint32_t rn[kBlock], nn[kBlock];
    if (nblk > 0) {
#pragma unroll
      for (int k = 0; k < kBlock; ++k) {
        rn[k] = r[i + k];
        nn[k] = o[i + k - x];
      }
    }
    for (long long blk = 0; blk < nblk; ++blk, i += kBlock) {
      uint32_t rc[kBlock], nc[kBlock];
#pragma unroll
      for (int k = 0; k < kBlock; ++k) {
        rc[k] = rn[k];
        nc[k] = nn[k];
      }
      if (blk + 1 < nblk) {
#pragma unroll
        for (int k = 0; k < kBlock; ++k) {
          rn[k] = r[i + kBlock + k];
          nn[k] = o[i + kBlock + k - x];
        }
      }
#pragma unroll
      for (int k = 0; k < kBlock; ++k) {
        const uint32_t v = step(rc[k], nc[k], w, nw);
        o[i + k] = (uint8_t)v;
        nw = nc[k];
        w = v;
      }
    }
  }
  for (; i < size; ++i) {
    const uint32_t n = o[i - x];
    w = step(r[i], n, w, nw);
    o[i] = (uint8_t)w;
    nw = n;
  }
}

}  // namespace

// res, out: [b, rows, x] u8, contiguous, on the card.
extern "C" int fpv1_cg_flat_decode(const void* res, void* out, int b,
                                   int rows, int x, void* stream) {
  if (b > 0 && rows > 0 && x > 0) {
    cg_flat_decode_kernel<<<b, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)res, (uint8_t*)out, (long long)rows * x,
        (long long)x);
  }
  return (int)cudaGetLastError();
}
