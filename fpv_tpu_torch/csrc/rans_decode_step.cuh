// K2's step, shared by the production decoder (rans_decode.cu) and its
// measurement variants (rans_decode_variants.cu).
//
// decode_wide is a template over a Variant.  The production kernel
// instantiates it with Production, whose every flag is off and whose one
// chain per thread makes each per-chain loop a single pass: the code it
// compiles is the step as it was written before the variants existed.  A
// variant changes only the part its flag names (see Variant below), so the
// replicas time the production step with one part taken out, and never a
// hand-copied step that could drift from it.

#pragma once

#include <cstdint>
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
constexpr int kTwoTableSym = 1024;    // two-table layout: symbol words first
constexpr int kTwoTableWords = kTwoTableSym + 256;  // then 256 fc words

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
// kPb0 is the order-0 precision (12 in the format; 11 and 10 only in the
// fused-rows variants), whose fused table has 2^kPb0 entries.
template <bool kCtx, int kPb0 = 12>
struct Lookup {
  static constexpr int kProbBits = kCtx ? 7 : kPb0;  // fixed by the layout
  static constexpr int kSymBits = kCtx ? 4 : 8;
  uint32_t sym, xn;
  __device__ __forceinline__ Lookup() {}
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

// A decode variant (JAX: decode_pallas's flags, rans_pallas.py:942-946):
// * StubTables: no table load; the entry comes from arithmetic of the
//   same dependency shape (sym = slot & 0xFF, f = (slot & fmask/4) + 1,
//   off = slot - f).  Outputs are meaningless.
// * StubWindow: no word staging and no word read; the ballot, the barrier,
//   both redux sums and the pointer update stay (the cross-lane chain), and
//   a renormalising lane takes the word 0x8000.  Outputs are meaningless.
// * Classes N > 0: the table holds N copies of the fused table; a lane
//   reads copy (lane & 127) % N, the column of JAX's [8, 128] lane layout.
// * ProbBits: the order-0 precision (fused table of 2^ProbBits entries).
// * TwoTable: the two dependent loads slot -> sym -> fc (fused_tab=False).
// * Nsub: rANS blocks per CTA; thread t carries lane t of each, the chains
//   interleaved and sharing one barrier per step.
template <bool StubTables, bool StubWindow, int Classes, int ProbBits,
          bool TwoTable, int Nsub>
struct Variant {
  static constexpr bool kStubTables = StubTables;
  static constexpr bool kStubWindow = StubWindow;
  static constexpr int kClasses = Classes;
  static constexpr int kProbBits = ProbBits;
  static constexpr bool kTwoTable = TwoTable;
  static constexpr int kNsub = Nsub;
};
using Production = Variant<false, false, 0, 12, false, 1>;

// The step's lookup under variant V; Production's is Lookup itself.
template <bool kCtx, class V>
__device__ __forceinline__ Lookup<kCtx, V::kProbBits> step_lookup(
    const uint32_t* tab, uint32_t x, uint32_t ctx) {
  using L = Lookup<kCtx, V::kProbBits>;
  constexpr int pb = L::kProbBits;
  constexpr uint32_t fmask = (1u << pb) - 1;
  if constexpr (V::kStubTables) {
    L lk;
    const uint32_t slot = x & fmask;
    lk.sym = slot & 0xFFu;
    const uint32_t f = (slot & (fmask >> 2)) + 1;
    lk.xn = f * (x >> pb) + (slot - f);
    return lk;
  } else if constexpr (V::kTwoTable) {
    // symbols packed 4 bytes (order-0) or 8 nibbles (ctx16) to a word,
    // then the fc words: (f-1) | cum << 12, or ctx16's 14-bit pairs
    L lk;
    const uint32_t slot = x & fmask;
    uint32_t e;
    if constexpr (kCtx) {
      const uint32_t idx = (ctx << pb) + slot;
      lk.sym = (tab[idx >> 3] >> ((idx & 7) * 4)) & 0xFu;
      const uint32_t pi = ctx * 16 + lk.sym;
      e = (tab[kTwoTableSym + (pi >> 1)] >> ((pi & 1) * 16)) & 0x3FFFu;
    } else {
      lk.sym = (tab[slot >> 2] >> ((slot & 3) * 8)) & 0xFFu;
      e = tab[kTwoTableSym + lk.sym];
    }
    const uint32_t f = (e & fmask) + 1;
    lk.xn = f * (x >> pb) + (slot - (e >> pb));
    return lk;
  } else {
    return L(tab, x, ctx);
  }
}

// A block of at most 32 lanes: one (partial) warp, thread = lane, no
// barrier.  (Production only: the variants are for wide blocks.)
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
//
// Under variant V the CTA decodes V::kNsub blocks, (CTA - cta0) * kNsub +
// u for chain u, each with its own ring (`ring` + u ring sizes), its own
// per-warp counts (`wcnt` + 2u) and ctx16 neighbours (`prevs` + 2u); the
// chains share the barrier.  With Production (one chain) every loop over
// the chains is one pass and the step is K2's.
template <bool kCtx, class V = Production>
__device__ __forceinline__ void decode_wide(const DecDesc& d, int lane,
                                            const uint32_t* tab,
                                            int (*wcnt)[32],
                                            uint8_t (*prevs)[kMaxLanes],
                                            uint16_t* ring) {
  constexpr int kN = V::kNsub;
  using L = Lookup<kCtx, V::kProbBits>;
  // (the statements keep K2's order, chain by chain)
  const int lanes = (int)d.lanes;
  const int nwarps = lanes >> 5;
  const int warp = lane >> 5;
  const int wl = lane & 31;
  const unsigned below = (1u << wl) - 1;
  int64_t m[kN];
#pragma unroll
  for (int u = 0; u < kN; ++u) m[u] = (blockIdx.x - d.cta0) * kN + u;
  const int k = (int)d.chunk_len;
  const int kseg = k < kSegLen ? k : kSegLen;
  const int nseg = k / kseg;
  int len[kN];
#pragma unroll
  for (int u = 0; u < kN; ++u) {
    len[u] = ((const int32_t*)d.lens)[m[u] * lanes + lane];
  }
  // ctx16 neighbours at warp edges, which wrap within the block's lanes
  const int left = (lane + lanes - 1) & (lanes - 1);
  const int right = (lane + 1) & (lanes - 1);
  const int32_t* counts[kN];
  const int64_t* starts[kN];
  uint8_t* outp[kN];
  Stage st[kN];
  uint32_t x[kN], prev[kN];
  bool seg_ok[kN];
  int ptr[kN];
#pragma unroll
  for (int u = 0; u < kN; ++u) {
    counts[u] = (const int32_t*)d.counts + m[u] * nseg;
    starts[u] = (const int64_t*)d.starts + m[u] * nseg;
    outp[u] = (uint8_t*)d.out + m[u] * (int64_t)k * lanes + lane;
    st[u] = make_stage(d, ring + u * (kRingChunks * kMaxLanes));
  }
#pragma unroll
  for (int u = 0; u < kN; ++u) {
    x[u] = ((const uint32_t*)d.states)[m[u] * lanes + lane];
    prev[u] = 0;  // this lane's previous-step symbol (0 when inactive)
    seg_ok[u] = true;
    ptr[u] = 0;
  }
  if constexpr (V::kClasses > 0) {
    // this lane's copy of the table: its column's class
    tab += ((lane & 127) % V::kClasses) * kTable;
  }
  int buf = 0;
  for (int gs = 0; gs < nseg; ++gs) {
#pragma unroll
    for (int u = 0; u < kN; ++u) {
      if (gs) seg_ok[u] = seg_ok[u] && ptr[u] == 0;
      ptr[u] = counts[u][gs];
      st[u].start_segment(starts[u][gs], ptr[u]);
    }
    for (int j = gs * kseg; j < (gs + 1) * kseg; ++j) {
      bool active[kN], renorm[kN];
      L lk[kN];
      unsigned ball[kN];
      int hi[kN];
#pragma unroll
      for (int u = 0; u < kN; ++u) {
        int(*wc)[32] = wcnt + 2 * u;
        uint8_t(*pv)[kMaxLanes] = prevs + 2 * u;
        active[u] = j < len[u];
        uint32_t ctx = 0;
        if (kCtx) {
          uint32_t al = __shfl_sync(kFull, prev[u], (wl + 31) & 31);
          uint32_t ar = __shfl_sync(kFull, prev[u], (wl + 1) & 31);
          if (wl == 0) al = pv[buf][left];
          if (wl == 31) ar = pv[buf][right];
          ctx = ctx_of(prev[u], al, ar);
        }
        lk[u] = step_lookup<kCtx, V>(tab, x[u], ctx);
        renorm[u] = active[u] && lk[u].xn < kRansL;
        prev[u] = active[u] ? lk[u].sym : 0u;
        if constexpr (!V::kStubWindow) hi[u] = st[u].vhi();
        ball[u] = __ballot_sync(kFull, renorm[u]);
        if (wl == 0) wc[buf][warp] = __popc(ball[u]);
        if (kCtx) pv[buf ^ 1][lane] = (uint8_t)prev[u];
      }
      if constexpr (!V::kStubWindow) cp_async_wait<kAhead * kN>();
      lane_barrier(lanes);
#pragma unroll
      for (int u = 0; u < kN; ++u) {
        int(*wc)[32] = wcnt + 2 * u;
        const int v = wl < nwarps ? wc[buf][wl] : 0;
        ptr[u] -= __reduce_add_sync(kFull, v);
        const int before = __reduce_add_sync(kFull, wl < warp ? v : 0) +
                           __popc(ball[u] & below);
        uint32_t xn = lk[u].xn;
        if constexpr (V::kStubWindow) {
          // the stand-in word 0x8000 (before >> 31 is 0, as before lies in
          // [0, lanes)): the rank stays on the chain, the window does not
          if (renorm[u]) xn = (xn << 16) | 0x8000u | ((uint32_t)before >> 31);
        } else {
          if (renorm[u] && st[u].tw > 0) {
            xn = (xn << 16) | st[u].word(ptr[u], before, hi[u]);
          }
          st[u].request(ptr[u], lane, lanes);
        }
        x[u] = active[u] ? xn : x[u];
        *outp[u] = (uint8_t)prev[u];
        outp[u] += lanes;
      }
      buf ^= 1;
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int u = 0; u < kN; ++u) {
    seg_ok[u] = seg_ok[u] && ptr[u] == 0;
    ((int32_t*)d.ok)[m[u] * lanes + lane] =
        ((x[u] == kRansL && seg_ok[u]) || len[u] == 0) ? 1 : 0;
  }
}

}  // namespace
