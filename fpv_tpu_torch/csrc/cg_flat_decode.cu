// K4: flat clamped-gradient (CG) inverse of the FPV1 profile, for Hopper
// (sm_90a), as a row-wise scan of byte maps.
//
// Not a TPU kernel: the JAX package runs this scan on the host
// (fpv_tpu/models/predictors.py:103 cg_decode, native/fpv_native.cc:173).
// Input res [B, R, X] u8, output out of the same shape.  Per frame, over
// the flat index i < R*X: out[i] = res[i] for i <= X; otherwise
// out[i] = res[i] + CG(out[i-X], out[i-1], out[i-X-1]) mod 256 with
// CG(n, w, nw) = clamp(n + w - nw, min(n, w), max(n, w))
// (fusion_power_video.cc:247-252, 326-333).  A column-0 pixel's west
// neighbour is the previous row's last pixel, so a frame is ONE chain of
// R*X - X - 1 steps; if R < 2 the output is a copy.
//
// What bounds it on this card: not bytes (1 in, 1 out per pixel: 0.6 us a
// 1024^2 frame at 3.35 TB/s) but the dependent depth.  Walked pixel by
// pixel (the serial walk below) a 1024^2 frame is 1M dependent steps,
// about 24 ms.  The scan cuts a row's depth to 2L + X/L steps and pays in
// parallel work, 256 map evaluations per pixel on the SM's DPX min/max
// unit, which then bounds a wide frame (one SM per frame); the per-row
// depth bounds a narrow one.
//
// The scan.  The chain is cut into chunks of X pixels: chunk c is the flat
// range [X+1 + c*X, X+1 + (c+1)*X) (the last one X-1 long).  A pixel's n and
// nw are out[i-X] and out[i-X-1], both in the previous chunk or the one
// before, so given the finished chunk above, pixel j of a chunk is a map of
// one byte, its west value w:
//   f_j(w) = (r_j + med3(n_j, w, w + d_j)) & 255,  d_j = n_j - nw_j,
// and med3(n, w, w + d) = d >= 0 ? max(w, min(w + d, n)) : min(w, max(w + d,
// n)) equals CG for every (n, w, nw).  A pixel with d < 0 is stepped on the
// reflected value 255 - w (CG commutes with the reflection, which turns d
// into -d), so every pixel's map has one form (struct Pixel).  Maps of one
// byte compose, so per tile of a chunk (up to kTile pixels; a wider chunk
// goes through in tiles whose end values chain through phase B), with
// segments of L = ceil(sqrt(min(X, kTile))) pixels rounded up to a
// multiple of 4 (S <= 32 of them):
//   prep  each thread packs one pixel's constants into shared memory; n and
//         nw come from the previous chunk, kept in shared memory (two
//         buffers of X bytes); the last segment is padded with pixels that
//         map every value to itself;
//   A     a quarter warp builds one segment's composed map as a table of 256
//         bytes: each of its 8 lanes steps 32 start values, two to a
//         register as 16-bit lanes, 3 operations a register and pixel
//         (two DPX add-min/add-max, __viaddmin_s16x2 / __viaddmax_s16x2,
//         and one mask-and-flip); one shared load of a step's constants
//         serves the warp's 4 segments;
//   B     thread 0 walks the S tables from the tile's start value: each
//         segment's start value (S dependent shared loads);
//   C     lane s of warp 0 walks segment s from its start value, with plain
//         32-bit adds, min and max on the value held in both 16-bit lanes
//         (off the DPX unit's long latency), 4 pixels loaded while 4 step;
//   out   the tile's bytes go from phase C's staging words to the chunk
//         buffer and to global memory, off the chain.
// A CTA barrier ends each phase.  At X = 1024 a row is L + S + L = 96 steps
// deep.  Residuals are loaded one tile ahead into a register.
//
// Frames on the SMs.  A frame is one chain, so it runs on one CTA, or on a
// cluster of 8 CTAs (ranks) when the card's SMs hold 8 for every frame of
// the launch (a delta frame, one decode_frame, a batch of up to 16) and the
// frame is kClusterMinX columns or wider.  Rank k then scans segments
// [k S/8, (k+1) S/8) of each tile, and only two things cross to other
// SMs, through distributed shared memory, each before a cluster barrier:
//   * rank k's segments composed into one map of 256 bytes, which phase B
//     of the later ranks walks in place of rank k's tables (phase B runs
//     in every rank: through the earlier ranks' maps, its own tables, and
//     the later ranks' maps to the tile's end value);
//   * the last byte of rank k's pixels, the nw of the next rank's first
//     pixel (or of the next tile's or chunk's).
// Phase A's work per SM drops 8-fold; the two cluster barriers a tile
// cost more than that saves when the split is only 2-fold (a batch of 63
// frames), which therefore stays at one CTA a frame.
//
// Frames narrower than kScanMinX keep the serial walk: one 32-thread CTA
// per frame, lane 0 walks the chain (at 16 and 32 columns it is faster
// than the scan, whose per-row barriers and table lookups then cost more
// than the few steps they save).  Offsets are int64, so a frame of
// 65536 x 65536 has no size cliff; a chunk of up to 65536 pixels and its
// predecessor fit in shared memory (2 x 64 KiB).

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kTile = 1024;     // pixels of a chunk scanned at once
constexpr int kMaxSeg = 32;     // segments of a tile (phase C: a lane each)
constexpr int kScanMinX = 64;   // narrower frames take the serial walk
constexpr int kSerialThreads = 32;
constexpr int kSerialBlock = 32;  // serial walk: steps per prefetched block
constexpr uint32_t kLanes = 0x00FF00FFu;
constexpr int kStageStride = kMaxSeg + 1;  // stage's words: no bank conflicts
constexpr int kPxStride = kMaxSeg + 1;     // px's rows: no bank conflicts
constexpr int kMaxRanks = 8;  // CTAs of a frame's cluster (the portable most)
constexpr int kClusterMinX = 1024;  // narrower frames: one CTA a frame

// One pixel's map in one form: a state s (the west value w directly, or
// 255 - w for a pixel with d < 0) steps to
//   s' = max(s + R, min(s + DR, NR)) & 255
// with R = r, DR = d + r, NR = n + r directly, and R = 256 - r,
// DR = 256 - r - d, NR = 511 - n - r reflected (s' is then 255 - out),
// then s = s' ^ flip, flip = 255 when the next pixel of the segment is in
// the other form (the segment's last pixel returns to the direct one).
// Every value stays in [0, 766] and every constant is >= 0, so two states
// share a register as 16-bit lanes that never carry into each other.
struct __align__(16) Pixel {
  uint32_t r2, dr2, nr2;  // R, DR, NR in both 16-bit lanes
  uint32_t flip;          // 0 or 0x00FF00FF
};

__device__ __forceinline__ uint32_t dup16(int v) {
  return ((uint32_t)v & 0xFFFFu) * 0x10001u;
}

// s' of one pixel on two packed states (before the flip)
__device__ __forceinline__ uint32_t map2(const Pixel& p, uint32_t v) {
  return __viaddmax_s16x2(v, p.r2, __viaddmin_s16x2(v, p.dr2, p.nr2)) &
         kLanes;
}

// s' of one pixel on a state held in both 16-bit lanes (v * 0x10001): the
// lanes never carry into each other, so plain 32-bit adds, min and max
// order v * 0x10001 as v.  ``one`` is 1, a kernel argument: the adds are
// then multiply-adds that the compiler cannot fuse with the min and max
// into DPX operations, whose long latency would sit on phase C's chain.
__device__ __forceinline__ uint32_t map1(const Pixel& p, uint32_t v,
                                         uint32_t one) {
  return max(v * one + p.r2, min(v * one + p.dr2, p.nr2)) & kLanes;
}

// Phase A for one segment on a group of G lanes: each lane steps 256 / G
// start values, two to a register, and writes its bytes of the segment's
// table.
template <int G>
__device__ __forceinline__ void build_table(const Pixel* px, int s, int seg,
                                            uint32_t in, int gl,
                                            uint8_t* table) {
  constexpr int kVals = 256 / G, kRegs = kVals / 2;
  const uint32_t v0 = (uint32_t)(kVals * gl);
  uint32_t v[kRegs];
#pragma unroll
  for (int k = 0; k < kRegs; ++k) {
    v[k] = ((v0 + 2 * k) | (v0 + 2 * k + 1) << 16) ^ in;
  }
#pragma unroll 4
  for (int t = 0; t < seg; ++t) {
    const Pixel p = px[t * kPxStride + s];
#pragma unroll
    for (int k = 0; k < kRegs; ++k) v[k] = map2(p, v[k]) ^ p.flip;
  }
  uint32_t* dst = reinterpret_cast<uint32_t*>(table + s * 256 + v0);
#pragma unroll
  for (int k = 0; k < kVals / 4; ++k) {
    dst[k] = __byte_perm(v[2 * k], v[2 * k + 1], 0x6420);
  }
}

// A barrier of the frame's CTAs: the cluster's when it has several
template <bool kCluster>
__device__ __forceinline__ void frame_sync() {
  if constexpr (kCluster) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
}

template <bool kCluster>
__global__ void __launch_bounds__(kMaxSeg * 32)
    cg_flat_scan_kernel(const uint8_t* __restrict__ res,
                        uint8_t* __restrict__ out, long long size, int x,
                        int seg, int seg_per_rank, int group, uint32_t one) {
  extern __shared__ __align__(16) uint8_t smem[];
  // px[t * kPxStride + s]: pixel t of segment s (step-major, so the lanes
  // of phase C read neighbouring entries; rows padded so that the prep's
  // threads, which write one segment's pixels, spread over the banks)
  Pixel* px = reinterpret_cast<Pixel*>(smem);                 // [32][33]
  uint8_t* table = smem + kMaxSeg * kPxStride * sizeof(Pixel);  // [32][256]
  int* wstart = reinterpret_cast<int*>(table + kMaxSeg * 256);  // [32]
  uint32_t* seg_in = reinterpret_cast<uint32_t*>(wstart + kMaxSeg);  // [32]
  // phase C's outputs: word w of the rank's segment l at
  // stage[w * kStageStride + l]
  uint32_t* stage = seg_in + kMaxSeg;                         // [8][33]
  // rank k's map of its segments composed, in every rank: comp[k][w]
  uint8_t* comp = reinterpret_cast<uint8_t*>(stage + 8 * kStageStride);
  uint8_t* prev = comp + kMaxRanks * 256;
  uint8_t* cur = prev + ((x + 15) & ~15);

  // the frame's cluster (see the note at the top): nrank CTAs, this one
  // scanning segments [rank * seg_per_rank, (rank + 1) * seg_per_rank)
  const int nrank = kCluster ? (int)cg::this_cluster().num_blocks() : 1;
  const int rank = kCluster ? (int)cg::this_cluster().block_rank() : 0;

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31;
  const long long base = (long long)(blockIdx.x / nrank) * size;
  const uint8_t* r = res + base;
  uint8_t* o = out + base;
  const long long head = x + 1;  // pixels stored verbatim (R >= 2)
  if (rank == 0) {
    for (long long j = tid; j < head; j += nthreads) o[j] = r[j];
  }
  for (int j = tid; j < x; j += nthreads) prev[j] = r[1 + j];
  uint32_t pp_last = r[0];  // nw of the chunk's first pixel (thread 0)
  uint32_t carry = r[x];    // the chain's value before the tile (thread 0)

  const long long chain = size - head;  // pixels after the head
  const long long nchunks = (chain + x - 1) / x;
  // tile (c, t0): pixels [t0, t0 + len) of chunk c; the next one's residual
  // is loaded a tile ahead into rnext
  long long c = 0;
  int t0 = 0;
  auto tile_len = [&](long long cc, int tt) -> int {
    const long long clen = cc + 1 < nchunks ? x : chain - cc * x;
    const long long left = clen - tt;
    return (int)(left < kTile ? left : kTile);
  };
  // this rank's segments [s_lo, s_lo + seg_per_rank) of a tile, and its
  // thread tid's pixel: tile pixel j, its segment, its step, the byte of
  // stage that phase C leaves its output in
  const int s_lo = rank * seg_per_rank;
  const int my_j = s_lo * seg + tid;
  const int my_seg = s_lo + tid / seg, my_t = tid - (my_seg - s_lo) * seg;
  const bool mine = my_seg < s_lo + seg_per_rank;
  const bool seg_last = my_t + 1 == seg;
  Pixel* const my_px = px + my_t * kPxStride + my_seg;
  const uint8_t* const my_out = reinterpret_cast<const uint8_t*>(
      stage + (my_t >> 2) * kStageStride + (my_seg - s_lo)) + (my_t & 3);
  uint32_t rnext = 0;
  if (mine && my_j < tile_len(0, 0)) rnext = r[head + my_j];
  frame_sync<kCluster>();  // (every CTA of the cluster runs)

  while (c < nchunks) {
    const int len = tile_len(c, t0);
    const long long at = head + c * x + t0;  // the tile's first flat index
    const int nseg = (len + seg - 1) / seg;
    const int s_hi = min(s_lo + seg_per_rank, nseg);
    // the next tile
    long long cn = c;
    int tn = t0 + len;
    if ((long long)tn >= (c + 1 < nchunks ? x : chain - c * x)) {
      ++cn;
      tn = 0;
    }
    // prep: pack this rank's pixels of the tile (the last segment padded
    // with pixels that map every value to itself); load the next tile's
    // residuals
    if (mine && my_j < len) {
      const int j = t0 + my_j;
      const int n = prev[j];
      const int nw = j ? prev[j - 1] : (int)pp_last;
      const int rr = (int)rnext;
      const int d = n - nw;
      const bool last = seg_last || my_j + 1 == len;
      const bool neg = d < 0;
      const bool next_neg = !last && prev[j + 1] < n;
      *my_px = neg ? Pixel{dup16(256 - rr), dup16(256 - rr - d),
                           dup16(511 - n - rr), neg != next_neg ? kLanes : 0}
                   : Pixel{dup16(rr), dup16(d + rr), dup16(n + rr),
                           next_neg ? kLanes : 0};
      if (my_t == 0) seg_in[my_seg] = neg ? kLanes : 0;
    } else if (my_seg < s_hi) {
      *my_px = Pixel{0, 0, 0, 0};
    }
    if (cn < nchunks && mine && my_j < tile_len(cn, tn)) {
      rnext = r[head + cn * x + tn + my_j];
    }
    __syncthreads();
    // A: the rank's segments' maps as tables of 256 end values, one group
    // of lanes a segment
    {
      const int s = s_lo + tid / group, gl = tid % group;
      if (s < s_hi) {
        const uint32_t in = seg_in[s];
        if (group == 32) {
          build_table<32>(px, s, seg, in, gl, table);
        } else if (group == 16) {
          build_table<16>(px, s, seg, in, gl, table);
        } else {
          build_table<8>(px, s, seg, in, gl, table);
        }
      }
    }
    __syncthreads();
    if constexpr (kCluster) {  // the rank's composed map, to every rank
      if (tid < 64) {
        uint32_t word = 0;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          uint32_t w = 4 * tid + k;
          for (int s = s_lo; s < s_hi; ++s) w = table[s * 256 + w];
          word |= w << (8 * k);
        }
        for (int rk = 0; rk < nrank; ++rk) {
          reinterpret_cast<uint32_t*>(
              cg::this_cluster().map_shared_rank(comp, rk) +
              rank * 256)[tid] = word;
        }
      }
      cg::this_cluster().sync();
    }
    // B: the rank's segments' start values, through the earlier ranks'
    // composed maps; then the tile's end value through the later ranks'
    if (tid == 0) {
      uint32_t w = carry;
      for (int rk = 0; rk < rank; ++rk) w = comp[rk * 256 + w];
      for (int s = s_lo; s < s_hi; ++s) {
        wstart[s] = (int)w;
        w = table[s * 256 + w];
      }
      for (int rk = rank + 1; rk < nrank; ++rk) w = comp[rk * 256 + w];
      carry = w;
    }
    __syncthreads();
    // C: lane l of warp 0 walks the rank's segment s_lo + l from its start
    // value (pixels past the tile map to themselves) and leaves its outputs
    // in stage, in blocks of 4 steps (L is a multiple of 4) whose pixels
    // are loaded while the block before computes
    if (tid < s_hi - s_lo) {
      const int s = s_lo + lane;
      uint32_t rep = seg_in[s];
      uint32_t v = (uint32_t)wstart[s] * 0x10001u ^ rep;
      Pixel p[4], q[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) p[k] = px[k * kPxStride + s];
      for (int tb = 0; tb < seg; tb += 4) {
        const int tn4 = tb + 4 < seg ? tb + 4 : tb;
#pragma unroll
        for (int k = 0; k < 4; ++k) q[k] = px[(tn4 + k) * kPxStride + s];
        uint32_t word = 0;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const uint32_t out = map1(p[k], v, one);
          word |= ((out ^ rep) & 0xFFu) << (8 * k);
          v = out ^ p[k].flip;
          rep ^= p[k].flip;
        }
        stage[(tb >> 2) * kStageStride + lane] = word;
#pragma unroll
        for (int k = 0; k < 4; ++k) p[k] = q[k];
      }
    }
    __syncthreads();
    // out: the rank's bytes into its chunk buffer and to global memory, its
    // last byte into every rank's; the barrier then also ends every rank's
    // phase B before the next tile's composed maps arrive
    if (mine && my_j < len) {
      const uint8_t b = *my_out;
      cur[t0 + my_j] = b;
      o[at + my_j] = b;
      if (kCluster && (my_j + 1 == len || my_j + 1 == s_hi * seg)) {
        for (int rk = 0; rk < nrank; ++rk) {
          cg::this_cluster().map_shared_rank(cur, rk)[t0 + my_j] = b;
        }
      }
    }
    frame_sync<kCluster>();
    if (cn != c) {  // the chunk is done: it becomes the chunk above
      if (tid == 0) pp_last = prev[x - 1];
      uint8_t* t = prev;
      prev = cur;
      cur = t;
    }
    c = cn;
    t0 = tn;
  }
}

__device__ __forceinline__ uint32_t step(uint32_t r, uint32_t n, uint32_t w,
                                         uint32_t nw) {
  // clamp(n + w - nw, min, max) == med3(n, w, n + w - nw) in exact ints
  const int lo = min((int)n, (int)w);
  const int hi = max((int)n, (int)w);
  const int g = (int)w + ((int)n - (int)nw);
  return (r + (uint32_t)max(lo, min(hi, g))) & 0xFFu;
}

// The serial walk for narrow frames: lane 0 walks the chain, the CTA's
// threads copy the verbatim head first.  For x >= 64 the walk runs in
// blocks of 32 steps whose 64 input bytes (32 of res, 32 of the row above)
// are loaded while the previous block computes (a block ahead never reads
// outputs of the block in flight, since i + 63 - x < i).
__global__ void __launch_bounds__(kSerialThreads)
    cg_flat_serial_kernel(const uint8_t* __restrict__ res,
                          uint8_t* __restrict__ out, long long size,
                          long long x) {
  const long long base = (long long)blockIdx.x * size;
  const uint8_t* r = res + base;
  uint8_t* o = out + base;
  const long long head = size < x + 1 ? size : x + 1;
  for (long long j = threadIdx.x; j < head; j += kSerialThreads) o[j] = r[j];
  __syncthreads();
  if (threadIdx.x != 0 || head == size) return;

  uint32_t w = o[x];
  uint32_t nw = o[0];
  long long i = x + 1;
  if (x >= 2 * kSerialBlock) {
    const long long nblk = (size - i) / kSerialBlock;
    uint32_t rn[kSerialBlock], nn[kSerialBlock];
    if (nblk > 0) {
#pragma unroll
      for (int k = 0; k < kSerialBlock; ++k) {
        rn[k] = r[i + k];
        nn[k] = o[i + k - x];
      }
    }
    for (long long blk = 0; blk < nblk; ++blk, i += kSerialBlock) {
      uint32_t rc[kSerialBlock], nc[kSerialBlock];
#pragma unroll
      for (int k = 0; k < kSerialBlock; ++k) {
        rc[k] = rn[k];
        nc[k] = nn[k];
      }
      if (blk + 1 < nblk) {
#pragma unroll
        for (int k = 0; k < kSerialBlock; ++k) {
          rn[k] = r[i + kSerialBlock + k];
          nn[k] = o[i + kSerialBlock + k - x];
        }
      }
#pragma unroll
      for (int k = 0; k < kSerialBlock; ++k) {
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
  if (b <= 0 || rows <= 0 || x <= 0) return (int)cudaGetLastError();
  const long long size = (long long)rows * x;
  cudaStream_t st = (cudaStream_t)stream;
  if (rows < 2) {
    return (int)cudaMemcpyAsync(out, res, (size_t)(b * size),
                                cudaMemcpyDeviceToDevice, st);
  }
  if (x < kScanMinX) {
    cg_flat_serial_kernel<<<b, kSerialThreads, 0, st>>>(
        (const uint8_t*)res, (uint8_t*)out, size, (long long)x);
    return (int)cudaGetLastError();
  }
  const int tile = x < kTile ? x : kTile;
  int seg = 4;
  while (seg * seg < tile) seg += 4;  // ceil(sqrt(tile)), up to a multiple of 4
  const int nseg = (tile + seg - 1) / seg;
  // a frame's cluster: 8 CTAs when the card's SMs hold 8 for every frame of
  // the batch and the frame is kClusterMinX columns or wider, else one
  // (measured on an H100: 8 CTAs take [1,1024,1024] from 5.7 to 4.0 ms;
  // 2 CTAs a frame made [63,1024,1024] slower, 6.2 against 5.7 ms: their
  // cluster barriers cost more than half a row's phase A saves)
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e != cudaSuccess) return (int)e;
  const int nrank =
      x >= kClusterMinX && (long long)b * kMaxRanks <= sms ? kMaxRanks : 1;
  const int seg_per_rank = (nseg + nrank - 1) / nrank;
  const int threads = (seg_per_rank * seg + 31) / 32 * 32;
  // phase A's lanes a segment: a quarter warp (one shared load then serves
  // 4 segments) on one CTA a frame; in a cluster a rank has only 4
  // segments, so 32 lanes each, one warp a segment
  int group = nrank > 1 ? 32 : 8;
  while (group > 8 && group * seg_per_rank > threads) group /= 2;
  const size_t shm = kMaxSeg * kPxStride * sizeof(Pixel) + kMaxSeg * 256 +
                     2 * kMaxSeg * sizeof(int) +
                     8 * kStageStride * sizeof(uint32_t) + kMaxRanks * 256 +
                     2 * (size_t)((x + 15) & ~15);
  if (shm > 48 * 1024) {
    e = cudaFuncSetAttribute(nrank > 1 ? cg_flat_scan_kernel<true>
                                       : cg_flat_scan_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)shm);
    if (e != cudaSuccess) return (int)e;
  }
  if (nrank == 1) {
    cg_flat_scan_kernel<false><<<b, threads, shm, st>>>(
        (const uint8_t*)res, (uint8_t*)out, size, x, seg, seg_per_rank,
        group, 1u);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(b * nrank));
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = shm;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)nrank;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, cg_flat_scan_kernel<true>, (const uint8_t*)res,
                         (uint8_t*)out, size, x, seg, seg_per_rank, group,
                         1u);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
