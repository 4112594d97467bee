// The scan of scalar-quantized slots (SQ8, SQ4, SQ6), shared by K1
// (csrc/rowscan.cu, the multi-row layout's rows) and K2's non-PQ path
// (csrc/scan_scores.cu, padded lists): worklist.cuh's contract, its
// worklist and its fill units, with its own tile, ring and dots.
//
// What bounds it: device-memory bandwidth, with the decode close behind. A
// coded slot is 3.6-6x narrower than a float32 one, so the float32 design
// (64-slot tiles, a two-tile ring filled anew for each item, the item's
// units, CSR and entries read one dependent load after another) left the
// SQ scans latency-bound, about 11 us an item at the 10M cell, whose rows
// are one 256-slot tile each. So:
//   * A stage is 256 slots, one a consumer thread: a row of the 10M cell
//     in one TMA copy (24 KB of SQ8 at d 96).
//   * One producer warp runs ahead of the eight consumer warps across
//     items. It claims the worklist's units up to four at a time (guided:
//     fewer as they run out, so the last ones spread over the blocks; the
//     next claim in flight while it issues the current ones), its lanes
//     resolve the claimed items at once (each unit's list, CSR offsets,
//     entries and their norms), and it fills a ring of two stages: the
//     item's tile by one TMA bulk copy where the slot is a multiple of 16
//     bytes, else by cp.async from its 32 lanes, with the header (list,
//     slots, entries, q_sq) and, for a small chunk, the entries' queries.
//     A stage completes on its mbarrier and the consumers release it on
//     another. Three or four stages ran slower than two on an H100: two
//     already cover the copy's latency, and the smaller block leaves more
//     of the SM's memory to L1.
//   * Up to kThreadQ entries an item (most items of the 10M cell: about
//     two queries a row) each consumer thread owns one slot: for each
//     entry it reads the slot's codes from shared memory in 16-byte blocks
//     (12 for SQ6), decodes them and runs the entry's query (broadcast
//     reads) past them, holding lane j's 32 partials in registers. Larger
//     chunks take worklist.cuh's warp units (8 slots x 4 queries a warp,
//     each slot decoded once for all) over 64-slot parts of the stage.
//     Two entries a decode held 64 partials,
//     past the registers of two blocks an SM (nine warps a block leave 96
//     a thread), and a tree evaluated depth first for four entries a
//     decode spilled; both ran slower.
//   * The integer codes become floats by the 2^23 trick (code_float; for
//     SQ8 one byte permute), so no element waits on the conversion unit.
//   * A slot's dot is the same bits on every route and chunk: lane j's
//     partial is the FMA chain over groups j, j + 32, ... of 4 dims from
//     0, and the 32 partials add as reduce_scatter32's butterfly (j with j
//     + 16, then + 8, + 4, + 2, + 1), which a thread evaluates in its
//     registers (tree32).
// Outside these widths (the slot not a whole number of blocks, unaligned
// bases, or stages too large for two blocks an SM: SQ8 past d 176) the
// scans keep their own kernels; so do float32 and bfloat16, whose 256-slot
// stages would not fit two blocks an SM.

#pragma once

#include "worklist.cuh"

namespace {

constexpr int kSqTile = kThreads;     // slots a stage, one a consumer
constexpr int kSqThreads = kThreads + 32;  // consumers and the producer
constexpr int kSqStages = 2;          // ring stages
constexpr int kSqSub = 64;            // warp route: slots of a part
constexpr int kThreadQ = 8;           // thread route: entries an item
constexpr int kClaim = 4;             // worklist units a claim, at most
constexpr int kSqBarBytes = 128;      // the mbarriers, before the ring

// ---- mbarriers and the Tensor Memory Accelerator

__device__ __forceinline__ unsigned smem_addr(const void* ptr) {
  return (unsigned)__cvta_generic_to_shared(ptr);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@!P1 bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Arrives once the thread's earlier cp.async copies have landed, as one of
// the barrier's expected arrivals.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                   "r"(smem_addr(bar))
               : "memory");
}

// Orders the shared memory's earlier reads (generic proxy) before the
// writes of bulk copies issued after it.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The arrival that arms `bar` for `bytes` of bulk copies.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// One bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) that completes on `bar`.
__device__ __forceinline__ void tma_copy(void* dst, const void* src,
                                         unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// One bulk copy that arms `bar` for its own bytes.
__device__ __forceinline__ void tma_load(void* dst, const void* src,
                                         unsigned bytes, uint64_t* bar) {
  fence_proxy_async();
  mbar_expect_tx(bar, bytes);
  tma_copy(dst, src, bytes, bar);
}

// ---- the thread route's dot

// The 32 lane partials added as reduce_scatter32 adds them: p[j] with
// p[j + 16], then the sums with those 8 apart, 4, 2 and 1.
template <int H>
__device__ __forceinline__ void tree_step(float (&p)[32]) {
#pragma unroll
  for (int j = 0; j < H; ++j) p[j] = p[j] + p[j + H];
}

__device__ __forceinline__ float tree32(float (&p)[32]) {
  tree_step<16>(p);
  tree_step<8>(p);
  tree_step<4>(p);
  tree_step<2>(p);
  tree_step<1>(p);
  return p[0];
}

__device__ __forceinline__ float4 affine4(unsigned c0, unsigned c1,
                                          unsigned c2, unsigned c3, float4 s,
                                          float4 b) {
  return make_float4(sq_affine(c0, s.x, b.x), sq_affine(c1, s.y, b.y),
                     sq_affine(c2, s.z, b.z), sq_affine(c3, s.w, b.w));
}

// A block of a slot's codes, read at once: kBytes bytes holding kGroups
// groups of 4 dims; group(u) decodes group u of the block.
template <typename Codec>
struct SlotBlock;

template <>
struct SlotBlock<SQ8> {
  static constexpr int kBytes = 16, kGroups = 4;
  uint4 w;
  __device__ void load(const unsigned char* x, int b) {
    w = reinterpret_cast<const uint4*>(x)[b];
  }
  // code k of v as 2^23 + code: one byte permute
  __device__ static float magic(unsigned v, unsigned k) {
    return __uint_as_float(__byte_perm(v, 0x4B000000u, 0x7440u | k));
  }
  __device__ static float affine(float m, float s, float b) {
    return __fadd_rn(__fmul_rn(__fsub_rn(m, 8388608.0f), s), b);
  }
  __device__ float4 group(int u, float4 s, float4 b) const {
    const unsigned v = u == 0 ? w.x : u == 1 ? w.y : u == 2 ? w.z : w.w;
    return make_float4(affine(magic(v, 0), s.x, b.x),
                       affine(magic(v, 1), s.y, b.y),
                       affine(magic(v, 2), s.z, b.z),
                       affine(magic(v, 3), s.w, b.w));
  }
};

template <>
struct SlotBlock<SQ4> {
  static constexpr int kBytes = 16, kGroups = 8;
  uint4 w;
  __device__ void load(const unsigned char* x, int b) {
    w = reinterpret_cast<const uint4*>(x)[b];
  }
  __device__ float4 group(int u, float4 s, float4 b) const {
    const int m = u >> 1;
    const unsigned v =
        (m == 0 ? w.x : m == 1 ? w.y : m == 2 ? w.z : w.w) >> (16 * (u & 1));
    return affine4(v & 15u, (v >> 4) & 15u, (v >> 8) & 15u, (v >> 12) & 15u,
                   s, b);
  }
};

template <>
struct SlotBlock<SQ6> {
  static constexpr int kBytes = 12, kGroups = 4;
  unsigned w0, w1, w2;
  __device__ void load(const unsigned char* x, int b) {
    const unsigned* p = reinterpret_cast<const unsigned*>(x) + 3 * b;
    w0 = p[0];
    w1 = p[1];
    w2 = p[2];
  }
  __device__ float4 group(int u, float4 s, float4 b) const {
    const unsigned v = u == 0   ? w0
                       : u == 1 ? __funnelshift_r(w0, w1, 24)
                       : u == 2 ? __funnelshift_r(w1, w2, 16)
                                : w2 >> 8;
    return affine4(v & 63u, (v >> 6) & 63u, (v >> 12) & 63u, (v >> 18) & 63u,
                   s, b);
  }
};

// The dot of one staged slot (x) with one query (q: ng float4s of shared
// memory), ng = d / 4 groups: lane j's partial over groups j, j + 32, ...
// in registers, then the butterfly.
template <typename Codec>
__device__ __forceinline__ float slot_dot(const unsigned char* x,
                                          const float4* sc, const float4* bi,
                                          const float4* q, int ng) {
  using Block = SlotBlock<Codec>;
  constexpr int kG = Block::kGroups;
  float part[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) part[j] = 0.f;
  for (int g0 = 0; g0 < ng; g0 += 32) {
#pragma unroll
    for (int bb = 0; bb < 32 / kG; ++bb) {
      const int gb = g0 + bb * kG;
      if (gb < ng) {
        Block blk;
        blk.load(x, gb / kG);
#pragma unroll
        for (int u = 0; u < kG; ++u) {
          const float4 v = blk.group(u, sc[gb + u], bi[gb + u]);
          const float4 w = q[gb + u];
          float a = part[bb * kG + u];
          a = fmaf(v.x, w.x, a);
          a = fmaf(v.y, w.y, a);
          a = fmaf(v.z, w.z, a);
          a = fmaf(v.w, w.w, a);
          part[bb * kG + u] = a;
        }
      }
    }
  }
  return tree32(part);
}

// Whether the scan takes this codec and width: an SQ codec whose slot is a
// whole number of its blocks, with float4 dots (vec4_dots).
inline bool sq_shape(int codec, int d, bool vec4) {
  if (!vec4) return false;
  switch (codec) {
    case kCodecSQ8: return d % 16 == 0;
    case kCodecSQ4: return d % 32 == 0;
    case kCodecSQ6: return d % 16 == 0;
    default: return false;
  }
}

// ---- the stages

enum StageKind { kStageItem = 0, kStageFill = 1, kStageEnd = 2 };

// A stage's header, written by the producer: an item's tile (list l, slots
// [c0, c0 + n_live), nq entries with their q_sq; first: the item's first
// tile), fill units [l, c0), or the end.
struct StageMeta {
  int kind, l, c0, n_live, nq, first, pad0, pad1;
  int ents[kMaxChunk];
  float qsq[kMaxChunk];
};

struct SqSmem {
  uint64_t* full;       // [stages]: the stage's header and copies landed
  uint64_t* empty;      // [stages]: the consumers are done with it
  unsigned char* ring;  // [stages][stage_bytes]: 256 stored slots each
  StageMeta* meta;      // [stages]
  float* tq;            // [stages][kThreadQ][d]: a small chunk's queries
  float* scale;         // [d]
  float* bias;          // [d]
  float* qs;            // [chunk][d]: a large chunk's queries
  float* dots;          // [chunk][kSqSub]
};

inline size_t sq_fixed_bytes(int d, int chunk) {
  return kSqBarBytes + 8 * (size_t)d + 4 * (size_t)chunk * d +
         4 * (size_t)chunk * kSqSub;
}

inline size_t sq_stage_bytes(const Config& c, int d) {
  return (size_t)c.stage_bytes + sizeof(StageMeta) + 4 * (size_t)kThreadQ * d;
}

__device__ __forceinline__ SqSmem carve_sq(const Params& p,
                                           unsigned char* base) {
  SqSmem s;
  s.full = reinterpret_cast<uint64_t*>(base);
  s.empty = s.full + kSqStages;
  s.ring = base + kSqBarBytes;
  s.meta = reinterpret_cast<StageMeta*>(s.ring +
                                        (size_t)kSqStages * p.stage_bytes);
  s.tq = reinterpret_cast<float*>(s.meta + kSqStages);
  s.scale = s.tq + (size_t)kSqStages * kThreadQ * p.d;
  s.bias = s.scale + p.d;
  s.qs = s.bias + p.d;
  s.dots = s.qs + (size_t)p.chunk * p.d;
  return s;
}

// The tile, chunk, span and shared memory for these shapes (slots
// of w bytes; items of item_tiles tiles, 0: whole lists), or false when
// the stages do not fit two blocks an SM.
bool sq_config(int nlist, int cap, int d, int w, long long n_work,
               int item_tiles, Config& c) {
  c = Config{};
  c.tile = kSqTile;
  c.slot_bytes = w;
  c.stage_bytes = (int)(((long long)kSqTile * w + 127) / 128 * 128);
  c.chunk = kMaxChunk;
  while (c.chunk > 4 && (long long)c.chunk * d * 4 > kQueryBytes)
    c.chunk >>= 1;
  c.direct = n_work <= c.chunk;
  if (item_tiles <= 0) item_tiles = (cap + c.tile - 1) / c.tile;
  c.span = c.tile * (c.direct ? kDirectTiles : item_tiles);
  const long long spans = (cap + (long long)c.span - 1) / c.span;
  const long long groups =
      n_work / c.chunk + (n_work < nlist ? n_work : nlist);
  c.max_items = spans * groups;
  const size_t fixed = sq_fixed_bytes(d, c.chunk);
  const size_t per = sq_stage_bytes(c, d);
  // two blocks an SM: 228 KB an SM, 1 KB of it kept a block
  c.smem = fixed + kSqStages * per;
  return c.smem <= 233472 / kMinBlocks - 1024;
}

// Whether a launch takes the scan of coded slots (sq_shape, and its
// stages fit), with its config in c.
inline bool sq_route(int codec, int d, bool vec4, int nlist, int cap,
                     long long n_work, int item_tiles, Config& c) {
  return sq_shape(codec, d, vec4) &&
         sq_config(nlist, cap, d, codec_slot_bytes(codec, d), n_work,
                   item_tiles, c) &&
         checked_scratch_ints(c, nlist, n_work) >= 0;
}

// The scratch of a launch whose other kernel needs n ints (-1: it does
// not fit): the larger of the two where the launch may take this scan
// (sq_route, with its pointers' alignment).
inline long long with_sq_scratch(long long n, int codec, int d, int nlist,
                                 int cap, long long n_work, int item_tiles) {
  Config c;
  if (n < 0 || !sq_route(codec, d, true, nlist, cap, n_work, item_tiles, c))
    return n;
  const long long n_sq = checked_scratch_ints(c, nlist, n_work);
  return n_sq > n ? n_sq : n;
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
}

// The producer's 32 lanes copy `bytes` contiguous bytes from src into dst
// (16-byte aligned): 16-byte cp.async when src is 16-byte aligned, else
// 4-byte when 4-byte aligned, the rest with plain loads and stores.
__device__ __forceinline__ void copy_bytes_lanes(unsigned char* dst,
                                                 const unsigned char* src,
                                                 int bytes, int lane) {
  const unsigned a = (unsigned)reinterpret_cast<uintptr_t>(src);
  const int g = (a & 15) == 0 ? 16 : (a & 3) == 0 ? 4 : 1;
  const int body = g == 1 ? 0 : bytes / g * g;
  if (g == 16) {
    for (int i = 16 * lane; i < body; i += 16 * 32)
      cp_async16(dst + i, src + i);
  } else if (g == 4) {
    for (int i = 4 * lane; i < body; i += 4 * 32) cp_async4(dst + i, src + i);
  }
  for (int i = body + lane; i < bytes; i += 32) dst[i] = __ldg(src + i);
}

// The producer warp: the block's units in order, each item's tiles as
// stages, then the end. The full barrier counts one arrival (the TMA
// path's expect_tx) or 64 (every lane's cp.async arrival and its own).
template <bool kTma>
__device__ void sq_produce(const Params& p, const SqSmem& s) {
  const int lane = threadIdx.x & 31;
  const unsigned char* db = static_cast<const unsigned char*>(p.db);
  int it = 0;
  auto acquire = [&]() {
    const int st = it % kSqStages;
    if (it >= kSqStages) mbar_wait(s.empty + st, ((it / kSqStages) - 1) & 1);
    return st;
  };
  auto publish = [&](int st) {  // a stage without copies
    __syncwarp();
    if (kTma) {
      if (lane == 0) mbar_arrive(s.full + st);
    } else {
      cp_async_arrive(s.full + st);
      mbar_arrive(s.full + st);
    }
    ++it;
  };
  auto fill = [&](int f0, int f1) {
    const int st = acquire();
    if (lane == 0) {
      s.meta[st].kind = kStageFill;
      s.meta[st].l = f0;
      s.meta[st].c0 = f1;
    }
    publish(st);
  };
  auto finish = [&]() {
    const int st = acquire();
    if (lane == 0) s.meta[st].kind = kStageEnd;
    publish(st);
  };
  // the tiles of list l's slots [c_begin, c_end) for nq entries;
  // ents(meta) writes their entries and q_sq into a header
  auto item = [&](int l, int c_begin, int c_end, int nq, auto&& ents) {
    const long long list_off = (long long)l * p.cap;
    const bool small = nq <= kThreadQ;
    for (int c0 = c_begin; c0 < c_end; c0 += kSqTile) {
      const int n_live = min(kSqTile, c_end - c0);
      const int st = acquire();
      StageMeta* m = s.meta + st;
      ents(m);
      if (lane == 0) {
        m->kind = kStageItem;
        m->l = l;
        m->c0 = c0;
        m->n_live = n_live;
        m->nq = nq;
        m->first = c0 == c_begin;
      }
      __syncwarp();
      unsigned char* dst = s.ring + (size_t)st * p.stage_bytes;
      const unsigned char* src = db + (list_off + c0) * p.slot_bytes;
      const int bytes = n_live * p.slot_bytes;
      float* tq = s.tq + (size_t)st * kThreadQ * p.d;
      const int qrow = 4 * p.d;
      if (kTma) {
        if (lane == 0) {
          fence_proxy_async();
          mbar_expect_tx(s.full + st, bytes + (small ? nq * qrow : 0));
          tma_copy(dst, src, bytes, s.full + st);
          if (small)
            for (int k = 0; k < nq; ++k)
              tma_copy(tq + k * p.d,
                       p.q + (long long)(m->ents[k] / p.n_slots) * p.d, qrow,
                       s.full + st);
        }
      } else {
        copy_bytes_lanes(dst, src, bytes, lane);
        if (small) {
          const int d4 = p.d >> 2;
          for (int i = lane; i < nq * d4; i += 32) {
            const int k = i / d4;
            cp_async16(tq + 4 * i,
                       p.q + (long long)(m->ents[k] / p.n_slots) * p.d +
                           4 * (i - k * d4));
          }
        }
        cp_async_arrive(s.full + st);
        mbar_arrive(s.full + st);
      }
      ++it;
    }
  };

  if (p.items == nullptr) {
    // direct mode: block u < direct_ub takes span u of the concatenated
    // live spans of the distinct lists (in order of first entry), the
    // blocks above it one fill unit each
    if (blockIdx.x >= (unsigned)p.direct_ub) {
      fill(blockIdx.x - p.direct_ub, blockIdx.x - p.direct_ub + 1);
      finish();
      return;
    }
    const int raw = lane < p.n_work ? p.lists[lane] : -1;
    const int l = raw < 0 ? -1 : min(raw, p.nlist - 1);
    const unsigned group =
        __match_any_sync(0xffffffffu, l >= 0 ? l : -1 - lane);
    const bool lead = l >= 0 && __ffs(group) - 1 == lane;
    const int n_t = lead ? (live_size(p, l) + p.span - 1) / p.span : 0;
    int incl = n_t;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    const int u = blockIdx.x;
    const bool hit = u >= incl - n_t && u < incl;
    const int who = __ffs(__ballot_sync(0xffffffffu, hit)) - 1;
    if (who >= 0) {
      const unsigned mine = __shfl_sync(0xffffffffu, group, who);
      const int lw = __shfl_sync(0xffffffffu, l, who);
      const int first =
          (u - __shfl_sync(0xffffffffu, incl - n_t, who)) * p.span;
      const bool member = (mine >> lane) & 1u;
      const int pos = __popc(mine & ((1u << lane) - 1u));
      const float qsq = member ? p.q_sq[lane / p.n_slots] : 0.f;
      item(lw, first, min(first + p.span, live_size(p, lw)), __popc(mine),
           [&](StageMeta* m) {
             if (member) {
               m->ents[pos] = lane;
               m->qsq[pos] = qsq;
             }
           });
    }
    finish();
    return;
  }

  // worklist mode: units claimed kClaim at a time; lane i resolves unit
  // u0 + i and every lane reads its entry of each item, so the dependent
  // loads of kClaim items overlap, and the next claim is in flight while
  // this batch's tiles are issued
  const int n_items = *p.n_items;
  const int n_units = n_items + p.n_fill;
  // guided: a claim takes the units left over twice the grid, at least
  // one and at most kClaim, so that the last units spread over the blocks
  auto share = [&](int left) {
    return max(1, min(kClaim, left / (2 * (int)gridDim.x)));
  };
  auto claim = [&](int step) {
    int u = 0;
    if (lane == 0) u = atomicAdd(p.counter, step);
    return __shfl_sync(0xffffffffu, u, 0);
  };
  int step = share(n_units);
  int u_next = claim(step);
  while (u_next < n_units) {
    const int u0 = u_next, got = step, u = u0 + lane;
    int l = -1, c_begin = 0, c_end = 0, nq = 0, ebase = 0;
    if (lane < got && u < n_items) {
      const int2 unit = p.items[u];
      l = unit.x;
      const int first = p.off[l], cnt = p.off[l + 1] - first;
      const int n_chunks = (cnt + p.chunk - 1) / p.chunk;
      const int span = unit.y / n_chunks, ch = unit.y - span * n_chunks;
      c_begin = span * p.span;
      c_end = min(c_begin + p.span, live_size(p, l));
      nq = min(p.chunk, cnt - ch * p.chunk);
      ebase = first + ch * p.chunk;
    }
    step = share(n_units - u0 - got);
    u_next = claim(step);
    int e[kClaim];
    float qsq[kClaim];
#pragma unroll
    for (int i = 0; i < kClaim; ++i) {
      const int nqi = __shfl_sync(0xffffffffu, nq, i);
      const int ebi = __shfl_sync(0xffffffffu, ebase, i);
      e[i] = lane < nqi ? p.order[ebi + lane] : 0;
    }
#pragma unroll
    for (int i = 0; i < kClaim; ++i)
      qsq[i] = __shfl_sync(0xffffffffu, nq, i) > lane
                   ? p.q_sq[e[i] / p.n_slots]
                   : 0.f;
#pragma unroll
    for (int i = 0; i < kClaim; ++i) {
      const int li = __shfl_sync(0xffffffffu, l, i);
      const int nqi = __shfl_sync(0xffffffffu, nq, i);
      const int cb = __shfl_sync(0xffffffffu, c_begin, i);
      const int ce = __shfl_sync(0xffffffffu, c_end, i);
      const int ei = e[i];
      const float qi = qsq[i];
      if (li >= 0)
        item(li, cb, ce, nqi, [&](StageMeta* m) {
          if (lane < nqi) {
            m->ents[lane] = ei;
            m->qsq[lane] = qi;
          }
        });
    }
    const int f0 = max(u0, n_items), f1 = min(u0 + got, n_units);
    if (f0 < f1) fill(f0 - n_items, f1 - n_items);
  }
  finish();
}

// The consumer warps: each stage in order, then its release.
template <typename Codec>
__device__ void sq_consume(const Params& p, const SqSmem& s) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const float worst = p.is_l2 ? CUDART_INF_F : -CUDART_INF_F;
  const int d = p.d, ng = d >> 2;
  const float4* sc = reinterpret_cast<const float4*>(s.scale);
  const float4* bi = reinterpret_cast<const float4*>(s.bias);
  auto score_of = [&](float q_sq, float db_sq, float dot) {
    // (q_sq + db_sq) - 2 * dot, rounded step by step as the plain version
    // does; 2 * dot is exact, so no contraction can change it
    return p.is_l2 ? fmaxf(__fsub_rn(__fadd_rn(q_sq, db_sq), 2.0f * dot),
                           0.0f)
                   : dot;
  };
  for (int it = 0;; ++it) {
    const int st = it % kSqStages;
    mbar_wait(s.full + st, (it / kSqStages) & 1);
    const StageMeta& m = s.meta[st];
    const int kind = m.kind;
    if (kind == kStageEnd) break;
    if (kind == kStageFill) {
      for (int f = m.l; f < m.c0; ++f) fill_unit(p, f);
    } else {
      const int c0 = m.c0, n_live = m.n_live, nq = m.nq;
      const long long row_off = (long long)m.l * p.cap + c0;
      const unsigned char* ring = s.ring + (size_t)st * p.stage_bytes;
      if (nq <= kThreadQ) {
        // a slot a thread, one entry after the other
        if (t < n_live) {
          const float dsq = __ldg(p.db_sq + row_off + t);
          const int id = __ldg(p.vec_ids + row_off + t);
          const unsigned char* x = ring + t * p.slot_bytes;
          const float4* q4 =
              reinterpret_cast<const float4*>(s.tq + (size_t)st * kThreadQ * d);
          for (int k = 0; k < nq; ++k) {
            const float dot = slot_dot<Codec>(x, sc, bi, q4 + k * ng, ng);
            const long long at = (long long)m.ents[k] * p.cap + c0 + t;
            p.scores[at] = id >= 0 ? score_of(m.qsq[k], dsq, dot) : worst;
            p.ids[at] = id >= 0 ? id : -1;
          }
        }
      } else {
        // the warp units over 64-slot parts of the stage
        if (m.first) {
          for (int k = warp; k < nq; k += kWarps) {
            const float4* src = reinterpret_cast<const float4*>(
                p.q + (long long)(m.ents[k] / p.n_slots) * d);
            float4* dst = reinterpret_cast<float4*>(s.qs + k * d);
            for (int i = lane; i < ng; i += 32) dst[i] = __ldg(src + i);
          }
          consumers_sync();
        }
        for (int s0 = 0; s0 < n_live; s0 += kSqSub) {
          const int n_sub = min(kSqSub, n_live - s0);
          dot_units<Codec, true, 8>(p, s.qs, s.dots,
                                    ring + (size_t)s0 * p.slot_bytes, n_sub,
                                    nq, kSqSub);
          consumers_sync();
          for (int k = warp; k < nq; k += kWarps) {
            const long long base = (long long)m.ents[k] * p.cap + c0 + s0;
            const float q_sq = m.qsq[k];
            for (int c = lane; c < n_sub; c += 32) {
              const int id = __ldg(p.vec_ids + row_off + s0 + c);
              p.scores[base + c] =
                  id >= 0 ? score_of(q_sq, __ldg(p.db_sq + row_off + s0 + c),
                                     s.dots[k * kSqSub + c])
                          : worst;
              p.ids[base + c] = id >= 0 ? id : -1;
            }
          }
          consumers_sync();
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(s.empty + st);
  }
}

template <typename Codec, bool kTma>
__global__ void __launch_bounds__(kSqThreads, kMinBlocks)
sq_scan_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const SqSmem s = carve_sq(p, smem_raw);
  if (threadIdx.x == 0) {
    for (int i = 0; i < kSqStages; ++i) {
      mbar_init(s.full + i, kTma ? 1 : 64);
      mbar_init(s.empty + i, kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = threadIdx.x; i < p.d; i += kSqThreads) {
    s.scale[i] = p.sq_scale[i];
    s.bias[i] = p.sq_bias[i];
  }
  __syncthreads();
  if (threadIdx.x >= kThreads)
    sq_produce<kTma>(p, s);
  else
    sq_consume<Codec>(p, s);
}

template <typename Codec, bool kTma>
cudaError_t launch_sq(const Params& p, const Config& c, int* scratch,
                      int device, cudaStream_t stream) {
  static int done_smem[64], occupancy[64];
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  int per_sm = 0;
  const cudaError_t err =
      prepare((const void*)sq_scan_kernel<Codec, kTma>, c.smem,
              done_smem[device], occupancy[device], &per_sm, kSqThreads);
  if (err != cudaSuccess) return err;
  return launch_units(sq_scan_kernel<Codec, kTma>, per_sm, p, c, scratch,
                      device, stream, kSqThreads);
}

// The scan of coded slots on p (made with sq_config's c): TMA when a slot
// is a multiple of 16 bytes on an aligned base (every tile then is).
template <typename Codec>
cudaError_t launch_sq_codec(const Params& p, const Config& c, int* scratch,
                            int device, cudaStream_t stream) {
  const bool tma = p.slot_bytes % 16 == 0 &&
                   (reinterpret_cast<uintptr_t>(p.db) & 15) == 0;
  return tma ? launch_sq<Codec, true>(p, c, scratch, device, stream)
             : launch_sq<Codec, false>(p, c, scratch, device, stream);
}

inline cudaError_t launch_sq_any(int codec, const Params& p, const Config& c,
                                 int* scratch, int device,
                                 cudaStream_t stream) {
  switch (codec) {
    case kCodecSQ8: return launch_sq_codec<SQ8>(p, c, scratch, device, stream);
    case kCodecSQ4: return launch_sq_codec<SQ4>(p, c, scratch, device, stream);
    default: return launch_sq_codec<SQ6>(p, c, scratch, device, stream);
  }
}

}  // namespace
