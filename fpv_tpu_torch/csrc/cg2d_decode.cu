// K3: CG2D wavefront inverse for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel fpv_tpu/ops/predict.py::
// _cg2d_wavefront_kernel (predict.py:135; launcher _cg2d_decode_pallas,
// pallas_call at predict.py:231).  Inverse of cg2d_encode: row 0 is stored
// verbatim, column 0 is north-predicted, every other pixel is
// res + ClampedGradient(n, w, nw) mod 256.  Pixel (y, x) depends on
// (y-1, x), (y, x-1) and (y-1, x-1): a frame of H rows takes at least
// H+W-1 dependent steps.
//
// What bounds it on this card: those dependent steps, not bytes (1 B in and
// 1 B out per pixel).  A step is one shuffle, about 10 u8 operations, one
// shared hand-off between warps and one block-wide barrier, so a frame
// costs (H+W-1) x the latency of that chain.
//
// What the design does about it: one CTA per frame, one thread per row of
// a row group of T = min(round_up(H, 32), 1024) rows; the CTA walks the
// groups in order (one group for H <= 1024: the H+W-1 minimum).  At step t
// thread i computes pixel (y, x = t - i), and its neighbours never come
// from memory:
//   w   the thread's own previous output (a register);
//   n   thread i-1's previous output: one __shfl_up_sync; lane 0 of warp j
//       takes lane 31 of warp j-1's from a double-buffered shared slot
//       (written at step t-1 in parity (t-1)&1, read at step t while step
//       t's writer fills the other parity), and thread 0 of a group after
//       the first reads the previous group's last row, finished before the
//       group's closing barrier;
//   nw  the previous step's n (a register).
// Memory stays off the chain and out of the step: a row's bytes move 16 at
// a time in aligned 16-byte chunks (one L1 request per warp every 16 steps
// instead of a 32-line request per step).  Each thread loads the chunk of
// its residual row 16 steps before its first use into a register ring,
// funnel-shifts the step block's 16 bytes out of two chunks (the offset is
// fixed per row, so every byte index in the unrolled block is static),
// packs its 16 outputs into four words and stores the aligned chunk they
// complete after the block; a chunk the row covers only in part (its first
// and last) is stored byte by byte.  Rows past H (a partial last group)
// and steps outside a row run along, so every shuffle is full-mask and
// every thread takes every barrier; a warp with no pixel in a block of 16
// steps takes only the barriers, so a step issues the work of the warps
// on the wavefront, not of all 32.  No scratch is sized by H, W or B and
// offsets are int64, so tall frames (H = 65536) and wide ones have no size
// cliff.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kMaxThreads = 1024;
constexpr int kBlock = 16;  // steps per block: one 16-byte chunk per row

__device__ __forceinline__ uint32_t clamped_gradient(uint32_t n, uint32_t w,
                                                     uint32_t nw) {
  const uint32_t lo = min(n, w);
  const uint32_t hi = max(n, w);
  const uint32_t g = (n + w - nw) & 0xFFu;
  const uint32_t c = nw < lo ? hi : g;
  return nw > hi ? lo : c;
}

// bytes [k, k + 16) of the 32 bytes c[0..7], k in 0..15
__device__ __forceinline__ void window(const uint32_t (&c)[8], int k,
                                       uint32_t (&out)[4]) {
  const int q = k >> 2;
  const int sh = (k & 3) * 8;
  uint32_t s[5];
#pragma unroll
  for (int j = 0; j < 5; ++j) {
    const uint32_t a = q & 1 ? c[j + 1] : c[j];
    const uint32_t b = q & 1 ? c[j + 3] : c[j + 2];
    s[j] = q & 2 ? b : a;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) out[j] = __funnelshift_r(s[j], s[j + 1], sh);
}

__device__ __forceinline__ uint32_t byte_of(const uint32_t (&v)[4], int s) {
  return (v[s >> 2] >> (8 * (s & 3))) & 0xFFu;
}

// One row read 16 bytes per step block: chunk b+1 is resident and chunk b+2
// in flight while block b runs.  ``x`` is the row position of the next
// chunk to load; a chunk that misses the row [0, w), or a row that is not
// read at all (``live`` false), loads zeros.
struct RowReader {
  const uint8_t* row;
  int x;  // row position of the next chunk's first byte
  int k;  // offset of the block's window in its first chunk
  int w;
  bool live;
  bool coherent;  // a row of ``out``: read through L2, not L1's copy
  uint32_t c[8];

  __device__ __forceinline__ void load(uint32_t* dst) {
    uint4 v = make_uint4(0, 0, 0, 0);
    if (live && x > -kBlock && x < w) {
      const uint4* p = reinterpret_cast<const uint4*>(row + x);
      v = coherent ? __ldcg(p) : __ldg(p);
    }
    dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
    x += kBlock;
  }

  // row bytes from x0 (may be < 0) on, 16 per next_block()
  __device__ __forceinline__ void start(const uint8_t* r, int x0, int width,
                                        bool is_live, bool is_out) {
    k = (int)(((uintptr_t)r + (intptr_t)x0) & 15);
    row = r;
    x = x0 - k;
    w = width;
    live = is_live;
    coherent = is_out;
    load(c);
    load(c + 4);
  }

  // the next block's 16 bytes; refills the ring 16 steps ahead
  __device__ __forceinline__ void next_block(uint32_t (&out)[4]) {
    window(c, k, out);
#pragma unroll
    for (int j = 0; j < 4; ++j) c[j] = c[j + 4];
    load(c + 4);
  }
};

// Store the aligned chunk starting at row position xs whose bytes are
// [16 - k, 32 - k) of prev ++ cur (k == 0: cur): whole where the row
// covers it, else byte by byte.
__device__ __forceinline__ void store_chunk(uint8_t* row, int xs, int k,
                                            int w, const uint32_t (&prev)[4],
                                            const uint32_t (&cur)[4]) {
  if (xs <= -kBlock || xs >= w) return;
  uint32_t v[4];
  if (k == 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = cur[j];
  } else {
    const uint32_t c[8] = {prev[0], prev[1], prev[2], prev[3],
                           cur[0],  cur[1],  cur[2],  cur[3]};
    window(c, kBlock - k, v);
  }
  if (xs >= 0 && xs + kBlock <= w) {
    *reinterpret_cast<uint4*>(row + xs) = make_uint4(v[0], v[1], v[2], v[3]);
    return;
  }
#pragma unroll
  for (int j = 0; j < kBlock; ++j) {
    if (xs + j >= 0 && xs + j < w) row[xs + j] = (uint8_t)byte_of(v, j);
  }
}

__global__ void __launch_bounds__(kMaxThreads)
    cg2d_decode_kernel(const uint8_t* __restrict__ res, uint8_t* out, int h,
                       int w) {
  __shared__ uint32_t edge[2][kMaxThreads / 32];
  const int i = threadIdx.x;
  const int lane = i & 31;
  const int warp = i >> 5;
  const int from = (warp + 31) & 31;  // the warp whose lane 31 feeds lane 0
  const int64_t frame = (int64_t)h * w;
  const uint8_t* rf = res + blockIdx.x * frame;
  uint8_t* of = out + blockIdx.x * frame;

  for (int y0 = 0; y0 < h; y0 += blockDim.x) {
    const int y = y0 + i;
    const bool live = y < h;
    const int rows = min((int)blockDim.x, h - y0);
    const int nblk = (rows + w - 1 + kBlock - 1) / kBlock;
    const int64_t off = (int64_t)(live ? y : y0) * w;
    uint8_t* orow = of + off;
    const int ko = (int)(((uintptr_t)orow - (uintptr_t)i) & 15);
    // row y's residuals from x = -i on; thread 0's north row from x = 0
    // (zeros for row 0, which is stored verbatim: pred = n = 0)
    RowReader rr, north;
    rr.start(rf + off, -i, w, live, false);
    north.start(of + off - w, 0, w, i == 0 && y0 > 0, true);
    const bool top = y == 0;
    uint32_t wv = 0, nw = 0;
    uint32_t prev[4] = {0, 0, 0, 0};
    for (int b = 0; b < nblk; ++b) {
      uint32_t r[4], nb[4], ow[4] = {0, 0, 0, 0};
      rr.next_block(r);
      north.next_block(nb);
      const int xb = b * kBlock - i;
      // A warp with no pixel in this block (its rows not started, or done:
      // about half the warps of a square frame's steps, all but ~3 of a
      // 64-wide one's) only keeps the barriers.  Nothing it skips is read:
      // a lane's first pixel (x = 0) takes only n, whose writer was busy.
      const int xw = b * kBlock - warp * 32;  // lane 0's first x
      const bool busy = xw + kBlock > 0 && xw - 31 < w;
#pragma unroll
      for (int s = 0; s < kBlock; ++s) {
        if (busy) {
          uint32_t n = __shfl_up_sync(kFull, wv, 1);
          if (lane == 0) n = warp ? edge[(s + 1) & 1][from] : byte_of(nb, s);
          const uint32_t cg = clamped_gradient(n, wv, nw);
          const uint32_t pred = (xb + s == 0 || top) ? n : cg;
          const uint32_t v = (byte_of(r, s) + pred) & 0xFFu;
          nw = n;
          wv = v;
          if (lane == 31) edge[s & 1][warp] = v;
          ow[s >> 2] |= v << (8 * (s & 3));
        }
        __syncthreads();
      }
      if (live) store_chunk(orow, xb - ko, ko, w, prev, ow);
#pragma unroll
      for (int j = 0; j < 4; ++j) prev[j] = ow[j];
    }
    // the chunk the last block began (its tail is past the row for ko == 0)
    const uint32_t none[4] = {0, 0, 0, 0};
    if (live && ko) store_chunk(orow, nblk * kBlock - i - ko, ko, w, prev,
                                none);
    __syncthreads();  // the group's last row is the next group's north row
  }
}

}  // namespace

extern "C" int fpvt_cg2d_decode(const void* res, void* out, int b, int h,
                                int w, void* stream) {
  if (b > 0 && h > 0 && w > 0) {
    int threads = ((h + 31) / 32) * 32;
    threads = threads > kMaxThreads ? kMaxThreads : threads;
    cg2d_decode_kernel<<<b, threads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)res, (uint8_t*)out, h, w);
  }
  return (int)cudaGetLastError();
}
