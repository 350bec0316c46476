// K1: block-interleaved rANS encoder for Hopper (sm_90a), two passes.
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
// What bounds it on this card: each lane's serial state chain (a compare,
// a select and a division per step), not bytes.  The chain of one lane
// depends only on its own symbols and the table: where its emitted words
// land in the stream does not feed back into any state.  A batch has few
// lanes in all (20 Ki for a 32-frame batch of 1024^2 frames at
// 4096-symbol chunks), so the chain's latency per step is the kernel's
// time.
//
// What the design does about it: the placement leaves the chain.
// * K1a (rans_encode_chain_kernel): one thread per lane, CTAs of 128
//   threads, no block-wide coupling (no barrier, no scan in the step loop),
//   so a 1024-lane rANS block spans 8 CTAs and a batch spreads over the
//   card.  Each step writes the word x & 0xFFFF into a dense [block, step,
//   lane] slot and the warp's emit ballot into [block, step, lanes/32];
//   each warp adds its emit count per segment to the group's count with
//   one atomic.  The symbol loads run kAhead = 16 steps ahead of their use
//   and the table lookup needs no state, so the chain is compare -> select
//   -> multiply-high -> shift -> multiply-add: the division is an exact
//   reciprocal multiply whose per-entry constants each CTA builds in
//   shared memory from the encode table (make_coder).  Measured on the
//   H100, the u32 division was the chain's longest link.
// * K1b (rans_encode_place_kernel): one CTA per (block, segment) group.
//   It sums the ballots' popcounts per step, scans them in stream order
//   (steps descending), and scatters each emitted word straight to its
//   place in the tight payload at the group's start (an exclusive cumsum
//   of the counts), 32 steps at a time: per step one coalesced load of
//   its ballots and a shuffle scan, then 16-byte loads of 8 words each.
//   No worst-case regions, no compaction afterwards.
// Both passes take an array of plane descriptors, so the high, low and
// preview planes of a batch go through one launch of each.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr int kChainThreads = 128;
constexpr int kAhead = 16;  // K1a symbol rows in flight (divides kseg >= 16)
constexpr int kPlaceThreads = 512;
constexpr int kTile = 32;  // K1b steps per tile
constexpr int kSegLen = 512;
constexpr uint32_t kRansL = 1u << 15;
constexpr unsigned kFull = 0xffffffffu;

// One plane of a grouped launch; every field is 64 bits so the host packs
// descriptors as an int64 array (ops/rans_cuda.py ENC_FIELDS, same order).
// A launch takes up to kMaxPlanes of them by value, as a kernel parameter:
// no copy to the device before the launch.
struct EncDesc {
  long long syms;      // const u8 [nblocks, K, lanes] symbols (ctx: nibbles)
  long long lens;      // const i32 [nblocks, lanes]
  long long fc;        // const u32 [nidx] (f-1) | cum << prob_bits
  long long states;    // u32 [nblocks, lanes]                     (K1a)
  long long words;     // u16 [nblocks, K, lanes] x & 0xFFFF        (K1a)
  long long ballots;   // u32 [nblocks, K, nwb] emit bits            (K1a)
  long long counts;    // i32 [nblocks * nseg], zeroed by the host   (K1a)
  long long starts;    // const i64 [nblocks * nseg] payload offsets (K1b)
  long long nidx, nblocks, lanes, chunk_len, prob_bits, ctx_mode;
  long long cta0;      // first K1a CTA of this plane
  long long grp0;      // first K1b CTA (group) of this plane
};

constexpr int kMaxPlanes = 8;  // ops/rans_cuda.py MAX_PLANES
struct EncDescs {
  EncDesc d[kMaxPlanes];
};

// The descriptor owning CTA `cta`, by the ascending first-CTA field.
template <long long EncDesc::*First>
__device__ __forceinline__ const EncDesc& find_desc(const EncDesc* d, int n,
                                                    long long cta) {
  int i = 0;
  while (i + 1 < n && d[i + 1].*First <= cta) ++i;
  return d[i];
}

// One step's symbols as lane `lane` needs them: its own, and (ctx16) its
// two neighbours, wrapping within the block's lanes; zeros before step 0
// (`p` then points at any valid row).
struct Row {
  uint32_t a, l, r;
};

__device__ __forceinline__ Row load_row(const uint8_t* p, bool in, int lane,
                                        int lanes, bool ctx_mode) {
  Row row{0u, 0u, 0u};
  row.a = in ? __ldg(p + lane) : 0u;
  if (ctx_mode) {
    row.l = in ? __ldg(p + ((lane + lanes - 1) & (lanes - 1))) : 0u;
    row.r = in ? __ldg(p + ((lane + 1) & (lanes - 1))) : 0u;
  }
  return row;
}

// One encode table entry in the form the chain uses: the emit threshold
// f << (31 - prob_bits), and the update x' = (x/f << prob_bits) + x%f + cum
// as x' = x + bias + (umulhi(x, rcp) >> shift) * cmpl, cmpl = scale - f,
// with an exact reciprocal for every x < 2^31 (Alverson's method, as in
// ryg_rans): shift = ceil(log2 f), rcp = ceil(2^(31+shift) / f), applied
// as umulhi then >> (shift - 1).  f = 1 takes rcp = 2^32 - 1, shift 0
// (quotient x - 1) and folds the missing scale - 1 into the bias.
// ops/rans_cuda.py encode_reciprocal is the same formula in Python.
struct __align__(16) Coder {
  uint32_t xmax, rcp, bias, cmpl_shift;  // cmpl | shift << 16
};

__device__ __forceinline__ Coder make_coder(uint32_t e, int prob_bits) {
  const uint32_t scale = 1u << prob_bits;
  const uint32_t f = (e & (scale - 1)) + 1;
  const uint32_t cum = e >> prob_bits;
  Coder c;
  c.xmax = f << (31 - prob_bits);
  if (f == 1) {
    c.rcp = 0xFFFFFFFFu;
    c.bias = cum + scale - 1;
    c.cmpl_shift = scale - 1;
  } else {
    const int shift = 32 - __clz(f - 1);
    c.rcp = (uint32_t)(((1ull << (shift + 31)) + f - 1) / f);
    c.bias = cum;
    c.cmpl_shift = (scale - f) | (uint32_t)(shift - 1) << 16;
  }
  return c;
}

// Table index of a step from its row and the previous step's row.
__device__ __forceinline__ uint32_t table_index(Row cur, Row prv, bool ctx,
                                                uint32_t idx_max) {
  uint32_t idx = cur.a;
  if (ctx) idx += (prv.a * 2 + (prv.l != prv.r ? 1u : 0u)) * 16;
  return idx < idx_max ? idx : idx_max;
}

__global__ void __launch_bounds__(kChainThreads) rans_encode_chain_kernel(
    const __grid_constant__ EncDescs descs, int ndesc) {
  __shared__ Coder tab[512];
  const EncDesc& d = find_desc<&EncDesc::cta0>(descs.d, ndesc, blockIdx.x);
  const int nidx = (int)d.nidx;
  const int prob_bits = (int)d.prob_bits;
  const uint32_t* fc = (const uint32_t*)d.fc;
  for (int i = threadIdx.x; i < nidx; i += kChainThreads) {
    tab[i] = make_coder(fc[i], prob_bits);
  }
  __syncthreads();

  const int lanes = (int)d.lanes;
  const int64_t total = d.nblocks * lanes;
  const int wl = threadIdx.x & 31;
  const int64_t g = (blockIdx.x - d.cta0) * kChainThreads + threadIdx.x;
  if (g - wl >= total) return;  // a warp past the plane's lanes
  // The rest of a plane's last warp (a plane of fewer than 32 lanes) runs
  // along as lanes of length 0 that store nothing, so every ballot is over
  // the full warp.
  const bool valid = g < total;
  const int64_t gv = valid ? g : total - 1;
  const int64_t m = gv / lanes;
  const int lane = (int)(gv % lanes);
  // ballot word of this lane's block, its bits within the warp, its writer
  const int nwb = (lanes + 31) >> 5;
  const int wshift = lanes >= 32 ? 0 : wl - lane;
  const unsigned wmask = lanes >= 32 ? kFull : (1u << lanes) - 1u;
  const bool writer = valid && (lanes >= 32 ? wl == 0 : lane == 0);

  const int k = (int)d.chunk_len;
  const int kseg = k < kSegLen ? k : kSegLen;
  const int nseg = k / kseg;
  const int len = valid ? ((const int32_t*)d.lens)[gv] : 0;
  const uint32_t idx_max = (uint32_t)nidx - 1;
  const bool ctx = d.ctx_mode != 0;
  const uint8_t* blk = (const uint8_t*)d.syms + m * (int64_t)k * lanes;
  // running pointers at step k-1 (outputs) and k-1-kAhead (symbol rows)
  uint16_t* wp =
      (uint16_t*)d.words + (m * k + k - 1) * (int64_t)lanes + lane;
  uint32_t* bp = (uint32_t*)d.ballots + (m * k + k - 1) * (int64_t)nwb +
                 (lane >> 5);
  const uint8_t* rp = blk + (int64_t)(k - 1 - kAhead) * lanes;
  int32_t* cnt = (int32_t*)d.counts + m * nseg;

  uint32_t x = kRansL;
  // rows[j % kAhead] holds step j's symbols, loaded kAhead steps before
  // their first use: the loads' latency stays off the chain.  Steps come in
  // groups of kAhead (kseg is a multiple), so every index is static.
  Row rows[kAhead];
#pragma unroll
  for (int i = 0; i < kAhead; ++i) {
    const int j = k - kAhead + i;
    rows[i] = load_row(blk + (int64_t)j * lanes, true, lane, lanes, ctx);
  }
  const int jb = k - kAhead - 1;
  Row below_rows = load_row(jb >= 0 ? blk + (int64_t)jb * lanes : blk,
                            jb >= 0, lane, lanes, ctx);
  for (int gs = nseg - 1; gs >= 0; --gs) {
    int emitted = 0;
    const int jlo = gs * kseg;
    for (int j0 = jlo + kseg - 1; j0 >= jlo; j0 -= kAhead) {
#pragma unroll
      for (int i = kAhead - 1; i >= 0; --i) {
        // step j = j0 - (kAhead - 1 - i), whose row is rows[i]; the
        // previous step's row is rows[i - 1], or for i == 0 the row below
        // the group
        const int j = j0 - (kAhead - 1 - i);
        const Row prv = i ? rows[i - 1] : below_rows;
        const Coder c = tab[table_index(rows[i], prv, ctx, idx_max)];
        const bool active = j < len;
        const bool emit = active && x >= c.xmax;
        if (valid) *wp = (uint16_t)(x & 0xFFFFu);
        wp -= lanes;
        const unsigned bits = (__ballot_sync(kFull, emit) >> wshift) & wmask;
        if (writer) *bp = bits;
        bp -= nwb;
        emitted += writer ? __popc(bits) : 0;
        const uint32_t x2 = emit ? (x >> 16) : x;
        const uint32_t q = __umulhi(x2, c.rcp) >> (c.cmpl_shift >> 16);
        const uint32_t xn = x2 + c.bias + q * (c.cmpl_shift & 0xFFFFu);
        x = active ? xn : x;
        // step j's row is free: refill the slot with step j - kAhead's
        const bool in = j - kAhead >= 0;
        rows[i] = load_row(in ? rp : blk, in, lane, lanes, ctx);
        rp -= lanes;
      }
      const int jn = j0 - 2 * kAhead;
      below_rows = load_row(jn >= 0 ? blk + (int64_t)jn * lanes : blk,
                            jn >= 0, lane, lanes, ctx);
    }
    if (writer && emitted) atomicAdd(cnt + gs, emitted);
  }
  if (valid) ((uint32_t*)d.states)[g] = x;
}

// K1a's nsub variant (ops/rans_bound.py's nsub_encode_report; JAX
// encode_pallas's nsub, rans_pallas.py:299-450): K1a's loop above with a
// thread running lane `lane` of the kNsub blocks cell * kNsub + u, their
// chains interleaved step by step (K1a itself stays as written, so its
// machine code does not move).  The block count is a multiple of kNsub (the
// host pads with blocks of length 0).  Each chain keeps kAhead / kNsub
// symbol rows in flight, so a thread holds kAhead rows whatever kNsub is:
// with kNsub chains a step takes about kNsub times as long, and the rows
// still land before their use.
template <int kNsub>
__device__ __forceinline__ void encode_chains(const EncDescs& descs,
                                              int ndesc) {
  constexpr int kAheadN = kAhead / kNsub;  // divides kseg >= 16
  __shared__ Coder tab[512];
  const EncDesc& d = find_desc<&EncDesc::cta0>(descs.d, ndesc, blockIdx.x);
  const int nidx = (int)d.nidx;
  const int prob_bits = (int)d.prob_bits;
  const uint32_t* fc = (const uint32_t*)d.fc;
  for (int i = threadIdx.x; i < nidx; i += kChainThreads) {
    tab[i] = make_coder(fc[i], prob_bits);
  }
  __syncthreads();

  const int lanes = (int)d.lanes;
  const int64_t total = d.nblocks / kNsub * lanes;
  const int wl = threadIdx.x & 31;
  const int64_t g = (blockIdx.x - d.cta0) * kChainThreads + threadIdx.x;
  if (g - wl >= total) return;  // a warp past the plane's lanes
  // The rest of a plane's last warp (a plane of fewer than 32 lanes) runs
  // along as lanes of length 0 that store nothing, so every ballot is over
  // the full warp.
  const bool valid = g < total;
  const int64_t gv = valid ? g : total - 1;
  const int64_t cell = gv / lanes;
  const int lane = (int)(gv % lanes);
  // ballot word of this lane's block, its bits within the warp, its writer
  const int nwb = (lanes + 31) >> 5;
  const int wshift = lanes >= 32 ? 0 : wl - lane;
  const unsigned wmask = lanes >= 32 ? kFull : (1u << lanes) - 1u;
  const bool writer = valid && (lanes >= 32 ? wl == 0 : lane == 0);

  const int k = (int)d.chunk_len;
  const int kseg = k < kSegLen ? k : kSegLen;
  const int nseg = k / kseg;
  // chain u's block is cell * kNsub + u; at[u] its lane's index
  int64_t at[kNsub];
  int len[kNsub];
#pragma unroll
  for (int u = 0; u < kNsub; ++u) {
    at[u] = (cell * kNsub + u) * lanes + lane;
    len[u] = valid ? ((const int32_t*)d.lens)[at[u]] : 0;
  }
  const uint32_t idx_max = (uint32_t)nidx - 1;
  const bool ctx = d.ctx_mode != 0;
  // per chain: its symbol block, running pointers at step k-1 (outputs)
  // and k-1-kAheadN (symbol rows), counts
  const uint8_t* blk[kNsub];
  uint16_t* wp[kNsub];
  uint32_t* bp[kNsub];
  const uint8_t* rp[kNsub];
  int32_t* cnt[kNsub];
#pragma unroll
  for (int u = 0; u < kNsub; ++u) {
    const int64_t m = cell * kNsub + u;
    blk[u] = (const uint8_t*)d.syms + m * (int64_t)k * lanes;
    wp[u] = (uint16_t*)d.words + (m * k + k - 1) * (int64_t)lanes + lane;
    bp[u] = (uint32_t*)d.ballots + (m * k + k - 1) * (int64_t)nwb +
            (lane >> 5);
    rp[u] = blk[u] + (int64_t)(k - 1 - kAheadN) * lanes;
    cnt[u] = (int32_t*)d.counts + m * nseg;
  }

  uint32_t x[kNsub];
#pragma unroll
  for (int u = 0; u < kNsub; ++u) x[u] = kRansL;
  // rows[u][j % kAheadN] holds chain u's step j symbols, loaded kAheadN
  // steps before their first use: the loads' latency stays off the chain.
  // Steps come in groups of kAheadN (kseg is a multiple), so every index
  // is static.
  Row rows[kNsub][kAheadN];
  Row below_rows[kNsub];
#pragma unroll
  for (int u = 0; u < kNsub; ++u) {
#pragma unroll
    for (int i = 0; i < kAheadN; ++i) {
      const int j = k - kAheadN + i;
      rows[u][i] =
          load_row(blk[u] + (int64_t)j * lanes, true, lane, lanes, ctx);
    }
    const int jb = k - kAheadN - 1;
    below_rows[u] = load_row(jb >= 0 ? blk[u] + (int64_t)jb * lanes : blk[u],
                             jb >= 0, lane, lanes, ctx);
  }
  for (int gs = nseg - 1; gs >= 0; --gs) {
    int emitted[kNsub];
#pragma unroll
    for (int u = 0; u < kNsub; ++u) emitted[u] = 0;
    const int jlo = gs * kseg;
    for (int j0 = jlo + kseg - 1; j0 >= jlo; j0 -= kAheadN) {
#pragma unroll
      for (int i = kAheadN - 1; i >= 0; --i) {
        // step j = j0 - (kAheadN - 1 - i), whose row is rows[u][i]; the
        // previous step's row is rows[u][i - 1], or for i == 0 the row
        // below the group
        const int j = j0 - (kAheadN - 1 - i);
#pragma unroll
        for (int u = 0; u < kNsub; ++u) {
          const Row prv = i ? rows[u][i - 1] : below_rows[u];
          const Coder c = tab[table_index(rows[u][i], prv, ctx, idx_max)];
          const bool active = j < len[u];
          const bool emit = active && x[u] >= c.xmax;
          if (valid) *wp[u] = (uint16_t)(x[u] & 0xFFFFu);
          wp[u] -= lanes;
          const unsigned bits =
              (__ballot_sync(kFull, emit) >> wshift) & wmask;
          if (writer) *bp[u] = bits;
          bp[u] -= nwb;
          emitted[u] += writer ? __popc(bits) : 0;
          const uint32_t x2 = emit ? (x[u] >> 16) : x[u];
          const uint32_t q = __umulhi(x2, c.rcp) >> (c.cmpl_shift >> 16);
          const uint32_t xn = x2 + c.bias + q * (c.cmpl_shift & 0xFFFFu);
          x[u] = active ? xn : x[u];
          // step j's row is free: refill the slot with step j - kAheadN's
          const bool in = j - kAheadN >= 0;
          rows[u][i] = load_row(in ? rp[u] : blk[u], in, lane, lanes, ctx);
          rp[u] -= lanes;
        }
      }
      const int jn = j0 - 2 * kAheadN;
#pragma unroll
      for (int u = 0; u < kNsub; ++u) {
        below_rows[u] =
            load_row(jn >= 0 ? blk[u] + (int64_t)jn * lanes : blk[u],
                     jn >= 0, lane, lanes, ctx);
      }
    }
#pragma unroll
    for (int u = 0; u < kNsub; ++u) {
      if (writer && emitted[u]) atomicAdd(cnt[u] + gs, emitted[u]);
    }
  }
#pragma unroll
  for (int u = 0; u < kNsub; ++u) {
    if (valid) ((uint32_t*)d.states)[at[u]] = x[u];
  }
}

// CTAs of kChainThreads threads over the plane's cells of kNsub blocks.
template <int kNsub>
__global__ void __launch_bounds__(kChainThreads)
    rans_encode_chain_nsub_kernel(const __grid_constant__ EncDescs descs,
                                  int ndesc) {
  encode_chains<kNsub>(descs, ndesc);
}

__global__ void __launch_bounds__(kPlaceThreads) rans_encode_place_kernel(
    const __grid_constant__ EncDescs descs, int ndesc,
    uint16_t* __restrict__ payload) {
  constexpr int kWarps = kPlaceThreads / 32;
  // one tile of kTile steps at a time: its ballots, each ballot word's
  // first word in the stream relative to the tile, and the tile's size
  __shared__ uint32_t sball[kTile][32];
  __shared__ int spre[kTile][32];
  __shared__ int sstep[kTile];
  __shared__ int stotal;
  const EncDesc& d = find_desc<&EncDesc::grp0>(descs.d, ndesc, blockIdx.x);
  const int lanes = (int)d.lanes;
  const int lshift = 31 - __clz(lanes);
  const int nwb = (lanes + 31) >> 5;
  const int k = (int)d.chunk_len;
  const int kseg = k < kSegLen ? k : kSegLen;
  const int tile = kseg < kTile ? kseg : kTile;
  const int nseg = k / kseg;
  const int64_t grp = blockIdx.x - d.grp0;
  const int64_t m = grp / nseg;
  // stream order: step s of the group is symbol step jtop - s
  const int64_t jtop = m * k + (grp % nseg) * kseg + kseg - 1;
  const uint32_t* ballots = (const uint32_t*)d.ballots;
  const uint16_t* words = (const uint16_t*)d.words;
  const int warp = threadIdx.x >> 5;
  const int wl = threadIdx.x & 31;
  uint16_t* out = payload + ((const int64_t*)d.starts)[grp];

  for (int s0 = 0; s0 < kseg; s0 += tile) {
    // each warp scans the ballot words of its steps (word w's first word
    // within its step), then warp 0 the steps' totals (each step's first
    // word within the tile)
    for (int t = warp; t < tile; t += kWarps) {
      const uint32_t b =
          wl < nwb ? __ldg(ballots + (jtop - s0 - t) * nwb + wl) : 0u;
      const int c = __popc(b);
      int incl = c;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(kFull, incl, o);
        if (wl >= o) incl += v;
      }
      sball[t][wl] = b;
      spre[t][wl] = incl - c;
      if (wl == 31) sstep[t] = incl;
    }
    __syncthreads();
    if (warp == 0) {
      // the steps' first words: an exclusive scan of their totals (tile
      // <= 32 steps, one per lane)
      const int c = wl < tile ? sstep[wl] : 0;
      int incl = c;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(kFull, incl, o);
        if (wl >= o) incl += v;
      }
      if (wl < tile) sstep[wl] = incl - c;
      if (wl == 31) stotal = incl;
    }
    __syncthreads();
    // every (step, 8 lanes) of the tile: one 16-byte load of the 8 words,
    // the emitted ones stored at their places (8 divides lanes and 32)
#pragma unroll 4
    for (int e = threadIdx.x; e < tile << (lshift - 3); e += kPlaceThreads) {
      const int t = e >> (lshift - 3);
      const int l = (e << 3) & (lanes - 1);
      const int w = l >> 5;
      const uint32_t b = sball[t][w];
      const uint32_t bits = (b >> (l & 31)) & 0xFFu;
      if (bits) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(
            words + (jtop - s0 - t) * lanes + l));
        const uint32_t v32[4] = {v.x, v.y, v.z, v.w};
        int r = sstep[t] + spre[t][w] + __popc(b & ((1u << (l & 31)) - 1u));
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if ((bits >> i) & 1u) {
            out[r++] = (uint16_t)(v32[i >> 1] >> ((i & 1) * 16));
          }
        }
      }
    }
    out += stotal;
    __syncthreads();
  }
}

}  // namespace

// The host's descriptors (int64 rows) as one kernel parameter.
static bool to_param(const void* descs, int ndesc, EncDescs* out) {
  if (ndesc < 1 || ndesc > kMaxPlanes) return false;
  memcpy(out->d, descs, ndesc * sizeof(EncDesc));
  return true;
}

extern "C" int fpvt_rans_encode_chain(const void* descs, int ndesc,
                                      int nctas, void* stream) {
  EncDescs p;
  if (!to_param(descs, ndesc, &p)) return (int)cudaErrorInvalidValue;
  if (nctas > 0) {
    rans_encode_chain_kernel<<<nctas, kChainThreads, 0,
                               (cudaStream_t)stream>>>(p, ndesc);
  }
  return (int)cudaGetLastError();
}

// K1a with nsub in {2, 4, 8} chains per thread; each plane's nblocks is a
// multiple of nsub and its cta0 counts CTAs of cells.
extern "C" int fpvt_rans_encode_chain_nsub(const void* descs, int ndesc,
                                           int nctas, int nsub,
                                           void* stream) {
  EncDescs p;
  if (!to_param(descs, ndesc, &p)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (nctas > 0) {
    if (nsub == 2) {
      rans_encode_chain_nsub_kernel<2><<<nctas, kChainThreads, 0, s>>>(p,
                                                                       ndesc);
    } else if (nsub == 4) {
      rans_encode_chain_nsub_kernel<4><<<nctas, kChainThreads, 0, s>>>(p,
                                                                       ndesc);
    } else if (nsub == 8) {
      rans_encode_chain_nsub_kernel<8><<<nctas, kChainThreads, 0, s>>>(p,
                                                                       ndesc);
    } else {
      return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}

extern "C" int fpvt_rans_encode_place(const void* descs, int ndesc,
                                      int ngroups, void* payload,
                                      void* stream) {
  EncDescs p;
  if (!to_param(descs, ndesc, &p)) return (int)cudaErrorInvalidValue;
  if (ngroups > 0) {
    rans_encode_place_kernel<<<ngroups, kPlaceThreads, 0,
                               (cudaStream_t)stream>>>(p, ndesc,
                                                       (uint16_t*)payload);
  }
  return (int)cudaGetLastError();
}
