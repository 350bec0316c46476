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

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLanes = 1024;
constexpr int kSegLen = 512;
constexpr int kTable = 4096;
constexpr uint32_t kRansL = 1u << 15;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRingChunks = 8;        // ring slots, one chunk each
constexpr int kChunkMin = 128;        // words; a chunk is max(lanes, this)
constexpr int kAhead = 2;             // cp.async groups left in flight

// One plane of a grouped launch; every field is 64 bits so the host packs
// descriptors as an int64 array (ops/rans_cuda.py DEC_FIELDS, same order).
// A launch takes up to kMaxPlanes of them by value, as a kernel parameter.
struct DecDesc {
  long long counts;   // const i32 [nblocks*nseg] words per group
  long long starts;   // const i64 [nblocks*nseg] group offsets in payload
  long long states;   // const u32 [nblocks, lanes]
  long long lens;     // const i32 [nblocks, lanes]
  long long table;    // const u32 [4096] fused entries, 16-byte aligned
  long long payload;  // const u16, 16-byte aligned, readable to a 1024-word
                      // multiple past total_words
  long long out;      // u8 [nblocks, K, lanes]
  long long ok;       // i32 [nblocks, lanes]
  long long total_words, nblocks, lanes, chunk_len;
  long long prob_bits;  // 12, or 7 with ctx_mode (checked by the host)
  long long ctx_mode;
  long long cta0;     // first CTA of this plane
};

constexpr int kMaxPlanes = 8;  // ops/rans_cuda.py MAX_PLANES
struct DecDescs {
  DecDesc d[kMaxPlanes];
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Barrier over the first `n` threads (the plane's lanes; the CTA's other
// threads have exited).
__device__ __forceinline__ void lane_barrier(int n) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(n) : "memory");
}

// The staged payload of one segment: chunks [req_lo, top] are requested,
// rl1..rl3 hold req_lo after each of the last three steps (chunks >= rl3
// have landed).  A segment whose region lies inside the payload computes
// positions in 32 bits and stages its words; any other (corrupt counts)
// reads every word from global memory at the plain version's clamped
// position.  Every field is uniform across the block.
struct Stage {
  const uint16_t* pay;
  uint16_t* ring;
  int tw, cshift, ahead;
  int64_t base64;
  bool staged;
  int base, top, req_lo, rl1, rl2, rl3;

  __device__ __forceinline__ void start_segment(int64_t b64, int count) {
    base64 = b64;
    staged = b64 >= 0 && count >= 0 && b64 + count <= tw;
    base = staged ? (int)b64 : 0;
    top = staged && base + count > 0 ? (base + count - 1) >> cshift : -1;
    req_lo = rl1 = rl2 = rl3 = top + 1;
    cp_async_wait<0>();  // no copy of the last segment lands in this one
  }

  // The last chunk a read of this step may take from the ring: this
  // step's requests reach at most 2 chunks below req_lo, so slots of
  // chunks up to req_lo + kRingChunks - 3 keep their data.
  __device__ __forceinline__ int vhi() const {
    return min(top, req_lo + kRingChunks - 3);
  }

  // The word at stream position ptr + before (ptr: the segment's read
  // pointer after this step), clamped to the payload as the plain version
  // clamps it.
  __device__ __forceinline__ uint32_t word(int ptr, int before,
                                           int hi) const {
    int pos;
    if (staged) {
      pos = max(base + ptr + before, 0);
    } else {
      const int64_t p64 = base64 + ptr + before;
      pos = p64 < 0 ? 0 : (p64 > tw ? tw : (int)p64);
    }
    pos = min(pos, tw - 1);
    const int c = pos >> cshift;
    return (c >= rl3 && c <= hi)
               ? ring[pos & ((kRingChunks << cshift) - 1)]
               : __ldg(pay + pos);
  }

  // Request the chunks down to `ahead` words below the read pointer (not
  // below the segment's base), thread `t` of `nthreads` copying its share,
  // and close this step's copy group.
  __device__ __forceinline__ void request(int ptr, int t, int nthreads) {
    if (staged) {
      const int tgt = max(base + ptr - ahead, base) >> cshift;
      if (tgt < req_lo) {
        const int gshift = cshift - 3;  // 16-byte granules per chunk
        const int n = (req_lo - tgt) << gshift;
        for (int i = t; i < n; i += nthreads) {
          const int c = tgt + (i >> gshift);
          const int g = (i & ((1 << gshift) - 1)) * 8;
          cp_async16(ring + ((c & (kRingChunks - 1)) << cshift) + g,
                     pay + ((int64_t)c << cshift) + g);
        }
        req_lo = tgt;
      }
    }
    cp_async_commit();
    rl3 = rl2;
    rl2 = rl1;
    rl1 = req_lo;
  }
};

__device__ __forceinline__ Stage make_stage(const DecDesc& d,
                                            uint16_t* ring) {
  const int lanes = (int)d.lanes;
  Stage st;
  st.pay = (const uint16_t*)d.payload;
  st.ring = ring;
  st.tw = (int)d.total_words;  // < 2^31 (checked by the host)
  st.cshift = 31 - __clz(lanes > kChunkMin ? lanes : kChunkMin);
  // the words a step needs were requested kAhead + 1 steps before, and a
  // step reads at most `lanes` words
  st.ahead = (kAhead + 1) * lanes;
  st.top = -1;
  return st;
}

// One step's table lookup: the entry's symbol and the state before renorm.
template <bool kCtx>
struct Lookup {
  static constexpr int kProbBits = kCtx ? 7 : 12;  // fixed by the layout
  static constexpr int kSymBits = kCtx ? 4 : 8;
  uint32_t sym, xn;
  __device__ __forceinline__ Lookup(const uint32_t* tab, uint32_t x,
                                    uint32_t ctx) {
    constexpr uint32_t fmask = (1u << kProbBits) - 1;
    const uint32_t e = tab[(x & fmask) + (ctx << kProbBits)];
    sym = e & ((1u << kSymBits) - 1);
    const uint32_t f = ((e >> kSymBits) & fmask) + 1;
    xn = f * (x >> kProbBits) + (e >> (kSymBits + kProbBits));
  }
};

__device__ __forceinline__ uint32_t ctx_of(uint32_t a, uint32_t al,
                                           uint32_t ar) {
  return a * 2 + (al != ar ? 1u : 0u);
}

// A block of at most 32 lanes: one (partial) warp, thread = lane, no
// barrier.
template <bool kCtx>
__device__ __forceinline__ void decode_narrow(const DecDesc& d, int lane,
                                              const uint32_t* tab,
                                              uint16_t* ring) {
  const int lanes = (int)d.lanes;
  const unsigned members = lanes >= 32 ? kFull : (1u << lanes) - 1u;
  const unsigned below = (1u << lane) - 1;
  const int64_t m = blockIdx.x - d.cta0;
  const int k = (int)d.chunk_len;
  const int kseg = k < kSegLen ? k : kSegLen;
  const int nseg = k / kseg;
  const int len = ((const int32_t*)d.lens)[m * lanes + lane];
  const int left = (lane + lanes - 1) & (lanes - 1);
  const int right = (lane + 1) & (lanes - 1);
  const int32_t* counts = (const int32_t*)d.counts + m * nseg;
  const int64_t* starts = (const int64_t*)d.starts + m * nseg;
  uint8_t* outp = (uint8_t*)d.out + m * (int64_t)k * lanes + lane;
  Stage st = make_stage(d, ring);

  uint32_t x = ((const uint32_t*)d.states)[m * lanes + lane];
  uint32_t prev = 0;  // this lane's previous-step symbol (0 when inactive)
  bool seg_ok = true;
  int ptr = 0;
  for (int gs = 0; gs < nseg; ++gs) {
    if (gs) seg_ok = seg_ok && ptr == 0;
    ptr = counts[gs];
    st.start_segment(starts[gs], ptr);
    for (int j = gs * kseg; j < (gs + 1) * kseg; ++j) {
      const bool active = j < len;
      uint32_t ctx = 0;
      if (kCtx) {
        ctx = ctx_of(prev, __shfl_sync(members, prev, left, lanes),
                     __shfl_sync(members, prev, right, lanes));
      }
      const Lookup<kCtx> lk(tab, x, ctx);
      const bool renorm = active && lk.xn < kRansL;
      prev = active ? lk.sym : 0u;
      const int hi = st.vhi();
      const unsigned ball = __ballot_sync(members, renorm);
      cp_async_wait<kAhead>();
      __syncwarp(members);
      ptr -= __popc(ball);
      uint32_t xn = lk.xn;
      if (renorm && st.tw > 0) {
        xn = (xn << 16) | st.word(ptr, __popc(ball & below), hi);
      }
      st.request(ptr, lane, lanes);
      x = active ? xn : x;
      *outp = (uint8_t)prev;
      outp += lanes;
    }
  }
  cp_async_wait<0>();
  seg_ok = seg_ok && ptr == 0;
  ((int32_t*)d.ok)[m * lanes + lane] =
      ((x == kRansL && seg_ok) || len == 0) ? 1 : 0;
}

// A block of 64 or more lanes: thread = lane, one barrier per step; the
// rank of a lane sums the renormalising lanes of the warps before it (two
// redux.sync over the per-warp counts) and those before it in its warp.
// (Two lanes per thread, sharing the barrier and the staging, measured
// slower on the H100: each thread's two chains serialise.)
template <bool kCtx>
__device__ __forceinline__ void decode_wide(const DecDesc& d, int lane,
                                            const uint32_t* tab,
                                            int (*wcnt)[32],
                                            uint8_t (*prevs)[kMaxLanes],
                                            uint16_t* ring) {
  const int lanes = (int)d.lanes;
  const int nwarps = lanes >> 5;
  const int warp = lane >> 5;
  const int wl = lane & 31;
  const unsigned below = (1u << wl) - 1;
  const int64_t m = blockIdx.x - d.cta0;
  const int k = (int)d.chunk_len;
  const int kseg = k < kSegLen ? k : kSegLen;
  const int nseg = k / kseg;
  const int len = ((const int32_t*)d.lens)[m * lanes + lane];
  // ctx16 neighbours at warp edges, which wrap within the block's lanes
  const int left = (lane + lanes - 1) & (lanes - 1);
  const int right = (lane + 1) & (lanes - 1);
  const int32_t* counts = (const int32_t*)d.counts + m * nseg;
  const int64_t* starts = (const int64_t*)d.starts + m * nseg;
  uint8_t* outp = (uint8_t*)d.out + m * (int64_t)k * lanes + lane;
  Stage st = make_stage(d, ring);

  uint32_t x = ((const uint32_t*)d.states)[m * lanes + lane];
  uint32_t prev = 0;  // this lane's previous-step symbol (0 when inactive)
  bool seg_ok = true;
  int ptr = 0;
  int buf = 0;
  for (int gs = 0; gs < nseg; ++gs) {
    if (gs) seg_ok = seg_ok && ptr == 0;
    ptr = counts[gs];
    st.start_segment(starts[gs], ptr);
    for (int j = gs * kseg; j < (gs + 1) * kseg; ++j) {
      const bool active = j < len;
      uint32_t ctx = 0;
      if (kCtx) {
        uint32_t al = __shfl_sync(kFull, prev, (wl + 31) & 31);
        uint32_t ar = __shfl_sync(kFull, prev, (wl + 1) & 31);
        if (wl == 0) al = prevs[buf][left];
        if (wl == 31) ar = prevs[buf][right];
        ctx = ctx_of(prev, al, ar);
      }
      const Lookup<kCtx> lk(tab, x, ctx);
      const bool renorm = active && lk.xn < kRansL;
      prev = active ? lk.sym : 0u;
      const int hi = st.vhi();
      const unsigned ball = __ballot_sync(kFull, renorm);
      if (wl == 0) wcnt[buf][warp] = __popc(ball);
      if (kCtx) prevs[buf ^ 1][lane] = (uint8_t)prev;
      cp_async_wait<kAhead>();
      lane_barrier(lanes);
      const int v = wl < nwarps ? wcnt[buf][wl] : 0;
      ptr -= __reduce_add_sync(kFull, v);
      const int before = __reduce_add_sync(kFull, wl < warp ? v : 0) +
                         __popc(ball & below);
      uint32_t xn = lk.xn;
      if (renorm && st.tw > 0) xn = (xn << 16) | st.word(ptr, before, hi);
      st.request(ptr, lane, lanes);
      x = active ? xn : x;
      *outp = (uint8_t)prev;
      outp += lanes;
      buf ^= 1;
    }
  }
  cp_async_wait<0>();
  seg_ok = seg_ok && ptr == 0;
  ((int32_t*)d.ok)[m * lanes + lane] =
      ((x == kRansL && seg_ok) || len == 0) ? 1 : 0;
}

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
