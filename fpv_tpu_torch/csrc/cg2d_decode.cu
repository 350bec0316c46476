// K3: CG2D wavefront inverse for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel fpv_tpu/ops/predict.py::
// _cg2d_wavefront_kernel (launcher _cg2d_decode_pallas, pallas_call at
// predict.py:231).  Inverse of cg2d_encode: row 0 is stored verbatim,
// column 0 is north-predicted, every other pixel is
// res + ClampedGradient(n, w, nw) mod 256.  Pixel (y, x) depends on
// (y-1, x), (y, x-1) and (y-1, x-1), so anti-diagonal d = y + x only
// depends on diagonals d-1 and d-2: H+W-1 dependent steps per frame.
//
// What bounds it on this card: the H+W-1 barrier-separated steps, not
// bytes (each pixel reads 4 bytes and writes 1, mostly from L1/L2).  One
// frame's wavefront is at most min(H, W) pixels wide, so a batch of B
// frames offers B CTAs of parallel work.
//
// What the design does about it: one CTA per frame walks the diagonals
// with one __syncthreads() per diagonal; threads stride over the
// diagonal's valid rows only, and read n / w / nw back from the output
// already written (global memory is coherent within the CTA across the
// barrier).  No scratch is sized by H or B, so tall frames (H = 65536) and
// large batches have no size cliff -- the TPU kernel's skewed
// B x ceil(H/128) scratch and its barrel-shift skew are gone.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint8_t clamped_gradient(uint8_t n, uint8_t w,
                                                    uint8_t nw) {
  const uint8_t lo = n < w ? n : w;
  const uint8_t hi = n < w ? w : n;
  const uint8_t g = (uint8_t)(n + w - nw);
  const uint8_t c = nw < lo ? hi : g;
  return nw > hi ? lo : c;
}

__global__ void cg2d_decode_kernel(const uint8_t* __restrict__ res,
                                   uint8_t* out, int h, int w) {
  const int64_t frame = (int64_t)h * w;
  const uint8_t* r = res + blockIdx.x * frame;
  uint8_t* o = out + blockIdx.x * frame;
  const int ndiag = h + w - 1;
  for (int d = 0; d < ndiag; ++d) {
    const int ylo = d - (w - 1) > 0 ? d - (w - 1) : 0;
    const int yhi = d < h - 1 ? d : h - 1;
    for (int y = ylo + (int)threadIdx.x; y <= yhi; y += blockDim.x) {
      const int x = d - y;
      const int64_t i = (int64_t)y * w + x;
      uint8_t pred = 0;
      if (y > 0) {
        const uint8_t n = o[i - w];
        pred = x == 0 ? n : clamped_gradient(n, o[i - 1], o[i - w - 1]);
      }
      o[i] = (uint8_t)(r[i] + pred);
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int fpvt_cg2d_decode(const void* res, void* out, int b, int h,
                                int w, void* stream) {
  if (b > 0 && h > 0 && w > 0) {
    int wide = h < w ? h : w;
    int threads = ((wide + 31) / 32) * 32;
    threads = threads > 1024 ? 1024 : threads;
    cg2d_decode_kernel<<<b, threads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)res, (uint8_t*)out, h, w);
  }
  return (int)cudaGetLastError();
}
