// The list-major scaffolding of the two scans, included by
// csrc/scan_scores.cu (K2, padded lists) and csrc/rowscan.cu (K1, the
// multi-row layout's rows). Both take the same contract:
//
//     for every entry e = b * n_slots + s (query b, probe slot s) with list
//     l = lists[e] (a padded list for K2, a row for K1) and slot c of l:
//     scores[e * cap + c] = max((q_sq[b] + db_sq[l, c]) - 2 * dot, 0)  (L2)
//                           dot                                        (IP)
//     ids[e * cap + c]    = vec_ids[l, c]
//
// with dot = <db[l, c, :], q[b, :]>. A slot is dead, with the metric's
// worst value and id -1, when l < 0 (an inactive entry), c >= list_sizes[l]
// or vec_ids[l, c] < 0; list ids >= nlist clamp to nlist - 1.
//
// Here: the launch parameters; the worklist that groups the live entries by
// list on the device (histogram, scan and scatter into a CSR, with the
// items (list, span of slots, chunk of up to `chunk` entries) beside it;
// no host sync); run_units, which hands a block its items from an atomic
// counter, or in direct mode (at most one chunk of entries, no worklist)
// groups the entries inside each block; the storage codecs, which decode a
// stored element in registers; the fp32 dots of a staged tile with a
// chunk's queries (dot_units); and the fill units that write the dead
// slots. Each scan brings its own way of staging a tile (scan_item); the
// SQ codecs have a scan of their own (sq_scan.cuh).
//
// The plan (the scan of the per-list counts) runs over many blocks of
// kPlanThreads lists, each list read once and coalesced: a pass of block
// sums, then a pass in which each block adds the sums before it to a scan
// of its lists (up to kPlanThreads lists, the second pass alone). One
// block looping over 40k lists, one serial load after another, took
// 150-160 us at the 10M cell's 39576 rows; two passes take about 5 us, and
// write the same offsets.
//
// Storage codecs: db holds float32 or bfloat16 vectors, or uint8 scalar-
// quantizer codes (SQ8: d bytes a slot; SQ4: d / 2, two dims a byte, low
// nibble first; SQ6: 3d / 4, four dims in each little-endian 24-bit group)
// with the affine decode x = code * sq_scale + sq_bias, a multiply then an
// add, each rounded (no contraction into an FMA), so that a decoded element
// is bitwise the plain version's. A ring stages a tile's stored bytes
// (slot_bytes a slot) and the dot units decode while they read it; bf16
// widens exactly. The dots, the norms (stored, of the decoded vectors) and
// the epilogue are the same for every codec.
//
// Product quantization (K2 only): db holds M uint8 codes a slot. K2 does
// not decode them: it sums a slot's M entries of per-query lookup tables
// (csrc/scan_scores.cu). codec_slot_bytes() knows no PQ width: the PQ
// launch sizes a slot by M, and K1 refuses the codec.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 2;         // blocks per SM the registers allow
constexpr int kDirectTiles = 2;       // tiles per block in direct mode
constexpr int kStages = 2;            // db ring: two tiles in flight
constexpr int kRingBytes = 64 * 1024;
constexpr int kQueryBytes = 32 * 1024;
constexpr int kMaxChunk = 32;
constexpr int kFillRows = kWarps;     // (b, s) rows of one fill unit
constexpr size_t kMaxSmem = 232448;   // sm_90 opt-in limit per block

// ---- storage codecs (the ids are kernels/scan_scores.py's CODECS)

enum CodecId { kCodecF32 = 0, kCodecBF16 = 1, kCodecSQ8 = 2, kCodecSQ4 = 3,
               kCodecSQ6 = 4, kCodecPQ = 5 };

// Bytes of one stored slot of dimension d, or -1 for an unknown codec, a
// width the codec does not pack, or PQ (whose width is M, not a function of
// d).
inline int codec_slot_bytes(int codec, int d) {
  switch (codec) {
    case kCodecF32: return 4 * d;
    case kCodecBF16: return 2 * d;
    case kCodecSQ8: return d;
    case kCodecSQ4: return d % 2 == 0 ? d / 2 : -1;
    case kCodecSQ6: return d % 4 == 0 ? 3 * d / 4 : -1;
    default: return -1;
  }
}

// (float)c for c < 2^23, exactly, without the conversion unit (a quarter
// of the FMA rate on sm_90): 2^23 + c has c in its mantissa, and the
// subtraction of 2^23 is exact.
__device__ __forceinline__ float code_float(unsigned c) {
  return __fsub_rn(__uint_as_float(0x4B000000u | c), 8388608.0f);
}

__device__ __forceinline__ float sq_affine(unsigned code, float scale,
                                           float bias) {
  return __fadd_rn(__fmul_rn(code_float(code), scale), bias);
}

__device__ __forceinline__ float4 sq_affine4(unsigned c0, unsigned c1,
                                             unsigned c2, unsigned c3,
                                             float4 s, float4 b) {
  return make_float4(sq_affine(c0, s.x, b.x), sq_affine(c1, s.y, b.y),
                     sq_affine(c2, s.z, b.z), sq_affine(c3, s.w, b.w));
}

// Each codec reads dims [4i, 4i + 4) (load4) or dim i (load1) of a staged
// slot as floats; the SQ codecs take the dims' scale and bias (kAffine).
struct F32 {
  static constexpr bool kAffine = false;
  __device__ static float4 load4(const unsigned char* x, int i, float4,
                                 float4) {
    return reinterpret_cast<const float4*>(x)[i];
  }
  __device__ static float load1(const unsigned char* x, int i, float,
                                float) {
    return reinterpret_cast<const float*>(x)[i];
  }
};

struct BF16 {
  static constexpr bool kAffine = false;
  __device__ static float4 load4(const unsigned char* x, int i, float4,
                                 float4) {
    const uint2 w = reinterpret_cast<const uint2*>(x)[i];
    return make_float4(__uint_as_float(w.x << 16),
                       __uint_as_float(w.x & 0xffff0000u),
                       __uint_as_float(w.y << 16),
                       __uint_as_float(w.y & 0xffff0000u));
  }
  __device__ static float load1(const unsigned char* x, int i, float,
                                float) {
    return __uint_as_float(
        (unsigned)reinterpret_cast<const unsigned short*>(x)[i] << 16);
  }
};

struct SQ8 {
  static constexpr bool kAffine = true;
  __device__ static float4 load4(const unsigned char* x, int i, float4 s,
                                 float4 b) {
    const unsigned w = reinterpret_cast<const unsigned*>(x)[i];
    return sq_affine4(w & 255u, (w >> 8) & 255u, (w >> 16) & 255u, w >> 24,
                      s, b);
  }
  __device__ static float load1(const unsigned char* x, int i, float s,
                                float b) {
    return sq_affine(x[i], s, b);
  }
};

struct SQ4 {
  static constexpr bool kAffine = true;
  __device__ static float4 load4(const unsigned char* x, int i, float4 s,
                                 float4 b) {
    const unsigned w = reinterpret_cast<const unsigned short*>(x)[i];
    return sq_affine4(w & 15u, (w >> 4) & 15u, (w >> 8) & 15u, w >> 12, s,
                      b);
  }
  __device__ static float load1(const unsigned char* x, int i, float s,
                                float b) {
    return sq_affine((x[i >> 1] >> (4 * (i & 1))) & 15u, s, b);
  }
};

struct SQ6 {
  static constexpr bool kAffine = true;
  __device__ static unsigned group(const unsigned char* x, int g) {
    const unsigned char* b = x + 3 * g;
    return b[0] | ((unsigned)b[1] << 8) | ((unsigned)b[2] << 16);
  }
  __device__ static float4 load4(const unsigned char* x, int i, float4 s,
                                 float4 b) {
    const unsigned w = group(x, i);
    return sq_affine4(w & 63u, (w >> 6) & 63u, (w >> 12) & 63u, w >> 18, s,
                      b);
  }
  __device__ static float load1(const unsigned char* x, int i, float s,
                                float b) {
    return sq_affine((group(x, i >> 2) >> (6 * (i & 3))) & 63u, s, b);
  }
};

struct Config {
  int tile;        // list slots per ring stage
  int chunk;       // entries (queries) per item
  int span;        // list slots per item
  int slot_bytes;  // bytes of one stored slot
  int stage_bytes; // bytes of one ring stage: tile slots, rounded to 16
  bool direct;     // n_work <= chunk: grouped in-block, no worklist
  size_t smem;     // dynamic shared memory per block (set by the scan)
  long long max_items;
};

// The tile, chunk, mode and item count for these shapes (slots of
// slot_bytes bytes), with worklist items of item_tiles tiles (0: a whole
// list each). The caller sets smem.
Config make_config(int nlist, int cap, int d, int slot_bytes,
                   long long n_work, int item_tiles) {
  Config c;
  // a multiple of 8 slots, at most 64, that lets the ring fit kRingBytes
  const long long fit = kRingBytes / ((long long)kStages * slot_bytes) / 8 * 8;
  c.tile = (int)(fit < 8 ? 8 : fit > 64 ? 64 : fit);
  c.slot_bytes = slot_bytes;
  c.stage_bytes = (c.tile * slot_bytes + 15) / 16 * 16;
  c.chunk = kMaxChunk;
  while (c.chunk > 4 && (long long)c.chunk * d * 4 > kQueryBytes)
    c.chunk >>= 1;
  c.direct = n_work <= c.chunk;
  if (item_tiles <= 0) item_tiles = (cap + c.tile - 1) / c.tile;
  c.span = c.tile * (c.direct ? kDirectTiles : item_tiles);
  c.smem = 0;
  const long long spans = (cap + c.span - 1) / c.span;
  const long long groups =
      n_work / c.chunk + (n_work < nlist ? n_work : nlist);
  c.max_items = spans * groups;
  return c;
}

struct Params {
  const void* db;           // stored slots, slot_bytes each
  const float* sq_scale;    // [d] (SQ codecs; else null)
  const float* sq_bias;     // [d]
  const float* pq_books;    // [M, d / M, 256]: PQ's codebook transposed
  const float* centroids;   // [nlist, d] (residual PQ; else null)
  const unsigned char* qcodes;  // [n_work, M] (PQ's Hamming filter; else null)
  const float* db_sq;
  const int* vec_ids;
  const int* list_sizes;
  const float* q;
  const float* q_sq;
  const int* lists;
  float* scores;
  int* ids;
  int n_work, n_slots, nlist, cap, d, is_l2;
  int ht;           // the Hamming threshold (with qcodes)
  int tile, chunk, span, slot_bytes, stage_bytes;
  int n_fill;       // fill units: kFillRows rows each
  int direct_ub;    // direct mode: blocks below it take a span, above fill
  // worklist (null in direct mode)
  int* counter;
  const int* off;       // [nlist + 1] CSR offsets of the entries by list
  const int* order;     // [n_work] entries grouped by list
  const int2* items;    // (list, index of the item within the list)
  const int* n_items;
};

__device__ __forceinline__ int live_size(const Params& p, int l) {
  return min(max(p.list_sizes[l], 0), p.cap);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// The block's threads copy `bytes` contiguous bytes from src into dst
// (16-byte aligned): 16-byte cp.async when src is 16-byte aligned, else
// 4-byte when it is 4-byte aligned, the tail and otherwise every byte with
// plain loads and stores (visible to the block after its next barrier).
__device__ __forceinline__ void copy_bytes(unsigned char* dst,
                                           const unsigned char* src,
                                           int bytes) {
  const unsigned a = (unsigned)reinterpret_cast<uintptr_t>(src);
  const int g = (a & 15) == 0 ? 16 : (a & 3) == 0 ? 4 : 1;
  const int body = g == 1 ? 0 : bytes / g * g;
  if (g == 16) {
    for (int i = 16 * threadIdx.x; i < body; i += 16 * kThreads)
      cp_async16(dst + i, src + i);
  } else if (g == 4) {
    for (int i = 4 * threadIdx.x; i < body; i += 4 * kThreads)
      cp_async4(dst + i, src + i);
  }
  for (int i = body + threadIdx.x; i < bytes; i += kThreads)
    dst[i] = __ldg(src + i);
}

// One step of the reduce-scatter: the lane keeps the half of v[0, 2H) that
// its bit H selects, adds its partner's copy of that half, and moves it to
// v[0, H).
template <int H>
__device__ __forceinline__ void reduce_step(float (&v)[32], int lane) {
  const bool up = (lane & H) != 0;
#pragma unroll
  for (int m = 0; m < H; ++m) {
    const float send = up ? v[m] : v[m + H];
    const float keep = up ? v[m + H] : v[m];
    v[m] = keep + __shfl_xor_sync(0xffffffffu, send, H);
  }
}

// Sum each of the 32 values over the warp's lanes; lane L returns the sum of
// v[L]. Lanes are paired by xor 16, 8, 4, 2, 1, as a butterfly all-reduce
// pairs them, so every sum is rounded exactly as in that tree.
__device__ __forceinline__ float reduce_scatter32(float (&v)[32], int lane) {
  reduce_step<16>(v, lane);
  reduce_step<8>(v, lane);
  reduce_step<4>(v, lane);
  reduce_step<2>(v, lane);
  reduce_step<1>(v, lane);
  return v[0];
}

// Worst values and id -1 for the dead part [size, cap) of each row of fill
// unit f (every slot of an inactive row).
__device__ void fill_unit(const Params& p, int f) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)f * kFillRows + (threadIdx.x >> 5);
  if (row >= p.n_work) return;
  const int raw = p.lists[row];
  const int size = raw < 0 ? 0 : live_size(p, min(raw, p.nlist - 1));
  const float worst = p.is_l2 ? CUDART_INF_F : -CUDART_INF_F;
  float* srow = p.scores + row * p.cap;
  int* irow = p.ids + row * p.cap;
  // 16-byte stores from the first 16-byte boundary at or past size
  int body = p.cap;
  if ((reinterpret_cast<uintptr_t>(p.scores) & 15) == 0 &&
      (reinterpret_cast<uintptr_t>(p.ids) & 15) == 0) {
    body = min(p.cap, size + (int)((4 - ((row * p.cap + size) & 3)) & 3));
    const float4 w4 = make_float4(worst, worst, worst, worst);
    const int4 m4 = make_int4(-1, -1, -1, -1);
    for (int c = body + 4 * lane; c + 4 <= p.cap; c += 128) {
      *reinterpret_cast<float4*>(srow + c) = w4;
      *reinterpret_cast<int4*>(irow + c) = m4;
    }
    for (int c = p.cap - (p.cap - body) % 4 + lane; c < p.cap; c += 32) {
      srow[c] = worst;
      irow[c] = -1;
    }
  }
  for (int c = size + lane; c < body; c += 32) {
    srow[c] = worst;
    irow[c] = -1;
  }
}

// The dots of a staged tile's first n_live slots (ring: the tile's stored
// slots, slot_bytes each, decoded by Codec) with the nq staged queries (qs,
// [chunk][d]), into dots ([chunk][ld]). A unit is kSlots slots x 32 /
// kSlots queries, 32 dots that one reduce-scatter finishes, one per lane;
// each lane holds its float4 (or float) of the unit's queries and streams
// the slots past them.
template <typename Codec, bool kVec4, int kSlots>
__device__ __forceinline__ void dot_units(const Params& p, const float* qs,
                                          float* dots,
                                          const unsigned char* ring,
                                          int n_live, int nq, int ld) {
  constexpr int kQ = 32 / kSlots;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int d = p.d, w = p.slot_bytes;
  const int n_sg = (n_live + kSlots - 1) / kSlots;
  const int n_qg = (nq + kQ - 1) / kQ;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  if constexpr (kVec4 && kSlots == 8) {
    if ((d >> 2) <= 32) {
      // d <= 128: a lane's part of a slot is one float4, so a warp keeps
      // its 8 slots in registers (decoded once) and runs every query group
      // past them
      const bool has = lane < (d >> 2);
      float4 sc = zero, bi = zero;
      if constexpr (Codec::kAffine) {
        if (has) {
          sc = __ldg(reinterpret_cast<const float4*>(p.sq_scale) + lane);
          bi = __ldg(reinterpret_cast<const float4*>(p.sq_bias) + lane);
        }
      }
      for (int sg = warp; sg < n_sg; sg += kWarps) {
        const unsigned char* xs = ring + sg * kSlots * w;
        float4 x[kSlots];
#pragma unroll
        for (int j = 0; j < kSlots; ++j)
          x[j] = has ? Codec::load4(xs + j * w, lane, sc, bi) : zero;
        for (int qg = 0; qg < n_qg; ++qg) {
          float acc[32];
#pragma unroll
          for (int k = 0; k < kQ; ++k) {
            const float* qk = qs + min(qg * kQ + k, nq - 1) * d;
            const float4 v =
                has ? reinterpret_cast<const float4*>(qk)[lane] : zero;
#pragma unroll
            for (int j = 0; j < kSlots; ++j) {
              float a = fmaf(x[j].x, v.x, 0.f);
              a = fmaf(x[j].y, v.y, a);
              a = fmaf(x[j].z, v.z, a);
              acc[j * kQ + k] = fmaf(x[j].w, v.w, a);
            }
          }
          const float dot = reduce_scatter32(acc, lane);
          const int k = qg * kQ + lane % kQ;
          if (k < nq) dots[k * ld + sg * kSlots + lane / kQ] = dot;
        }
      }
      return;
    }
  }
  for (int u = warp; u < n_sg * n_qg; u += kWarps) {
    const int sg = u / n_qg, qg = u - sg * n_qg;
    const unsigned char* xs = ring + sg * kSlots * w;
    const float* qv[kQ];
#pragma unroll
    for (int k = 0; k < kQ; ++k) qv[k] = qs + min(qg * kQ + k, nq - 1) * d;
    float acc[32];
#pragma unroll
    for (int m = 0; m < 32; ++m) acc[m] = 0.f;
    if (kVec4) {
      for (int i = lane; i < (d >> 2); i += 32) {
        float4 sc = zero, bi = zero;
        if constexpr (Codec::kAffine) {
          sc = __ldg(reinterpret_cast<const float4*>(p.sq_scale) + i);
          bi = __ldg(reinterpret_cast<const float4*>(p.sq_bias) + i);
        }
        float4 v[kQ];
#pragma unroll
        for (int k = 0; k < kQ; ++k)
          v[k] = reinterpret_cast<const float4*>(qv[k])[i];
#pragma unroll
        for (int j = 0; j < kSlots; ++j) {
          const float4 x = Codec::load4(xs + j * w, i, sc, bi);
#pragma unroll
          for (int k = 0; k < kQ; ++k) {
            float a = acc[j * kQ + k];
            a = fmaf(x.x, v[k].x, a);
            a = fmaf(x.y, v[k].y, a);
            a = fmaf(x.z, v[k].z, a);
            a = fmaf(x.w, v[k].w, a);
            acc[j * kQ + k] = a;
          }
        }
      }
    } else {
      for (int i = lane; i < d; i += 32) {
        float sc = 0.f, bi = 0.f;
        if constexpr (Codec::kAffine) {
          sc = __ldg(p.sq_scale + i);
          bi = __ldg(p.sq_bias + i);
        }
        float v[kQ];
#pragma unroll
        for (int k = 0; k < kQ; ++k) v[k] = qv[k][i];
#pragma unroll
        for (int j = 0; j < kSlots; ++j) {
          const float x = Codec::load1(xs + j * w, i, sc, bi);
#pragma unroll
          for (int k = 0; k < kQ; ++k)
            acc[j * kQ + k] = fmaf(x, v[k], acc[j * kQ + k]);
        }
      }
    }
    const float dot = reduce_scatter32(acc, lane);
    const int k = qg * kQ + lane % kQ;
    if (k < nq) dots[k * ld + sg * kSlots + lane / kQ] = dot;
  }
}

// The dots of a staged tile, the unit's shape following the chunk so that
// few (slot, query) pairs are padding.
template <typename Codec, bool kVec4>
__device__ __forceinline__ void tile_dots(const Params& p, const float* qs,
                                          float* dots,
                                          const unsigned char* ring,
                                          int n_live, int nq) {
  if (nq == 1 && p.tile % 32 == 0)
    dot_units<Codec, kVec4, 32>(p, qs, dots, ring, n_live, nq, p.tile);
  else if (nq <= 2 && p.tile % 16 == 0)
    dot_units<Codec, kVec4, 16>(p, qs, dots, ring, n_live, nq, p.tile);
  else
    dot_units<Codec, kVec4, 8>(p, qs, dots, ring, n_live, nq, p.tile);
}

// A block's share of the work. scan(l, c_begin, c_end, nq, ents) scores
// list l's live slots [c_begin, c_end) for the nq entries ents[0, nq).
// Direct mode: block u < direct_ub takes span u of the concatenated live
// spans of the distinct lists (in order of first entry), grouping the
// entries itself (__match_any_sync), and the blocks above it fill.
// Otherwise a persistent grid takes the worklist's items, then the fill
// units, from an atomic counter.
template <typename Scan>
__device__ __forceinline__ void run_units(const Params& p, Scan&& scan) {
  __shared__ int s_unit, s_l, s_first, s_nq;
  __shared__ int s_ents[kMaxChunk];

  if (p.items == nullptr) {
    if (blockIdx.x >= (unsigned)p.direct_ub) {
      fill_unit(p, blockIdx.x - p.direct_ub);
      return;
    }
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
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
      const unsigned mine = __shfl_sync(0xffffffffu, group, who < 0 ? 0 : who);
      if (who >= 0 && ((mine >> lane) & 1u))
        s_ents[__popc(mine & ((1u << lane) - 1u))] = lane;
      if (hit) {
        s_l = l;
        s_first = (u - (incl - n_t)) * p.span;
        s_nq = __popc(group);
      }
      if (lane == 0) s_unit = who;
    }
    __syncthreads();
    if (s_unit < 0) return;
    const int l = s_l;
    scan(l, s_first, min(s_first + p.span, live_size(p, l)), s_nq, s_ents);
    return;
  }

  const int n_items = *p.n_items;
  const int n_units = n_items + p.n_fill;
  for (;;) {
    if (threadIdx.x == 0) s_unit = atomicAdd(p.counter, 1);
    __syncthreads();
    const int u = s_unit;
    __syncthreads();
    if (u >= n_units) break;
    if (u >= n_items) {
      fill_unit(p, u - n_items);
      continue;
    }
    const int2 it = p.items[u];
    const int l = it.x;
    const int first = p.off[l], cnt = p.off[l + 1] - first;
    const int n_chunks = (cnt + p.chunk - 1) / p.chunk;
    const int span = it.y / n_chunks, ch = it.y - span * n_chunks;
    const int c_begin = span * p.span;
    scan(l, c_begin, min(c_begin + p.span, live_size(p, l)),
         min(p.chunk, cnt - ch * p.chunk), p.order + first + ch * p.chunk);
  }
}

// ---- the worklist: entries grouped by list, items per (list, span, chunk)

__global__ void count_kernel(const int* __restrict__ lists, int n_work,
                             int nlist, int* __restrict__ cnt) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_work) return;
  const int raw = lists[e];
  if (raw >= 0) atomicAdd(cnt + min(raw, nlist - 1), 1);
}

constexpr int kPlanThreads = 1024;   // lists of a plan block, one a thread

// Items of list l with c entries: spans of its live slots x chunks of c.
__device__ __forceinline__ int items_of(const int* __restrict__ list_sizes,
                                        int l, int c, int cap, int chunk,
                                        int span) {
  if (c == 0) return 0;
  const int size = min(max(list_sizes[l], 0), cap);
  return ((size + span - 1) / span) * ((c + chunk - 1) / chunk);
}

// Inclusive scan of (e, i) over the block's kPlanThreads threads (ws: 32
// pairs of shared memory); the block's totals are the last thread's.
__device__ __forceinline__ int2 block_scan(int e, int i, int2* ws) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int ve = __shfl_up_sync(0xffffffffu, e, o);
    const int vi = __shfl_up_sync(0xffffffffu, i, o);
    if (lane >= o) {
      e += ve;
      i += vi;
    }
  }
  if (lane == 31) ws[warp] = make_int2(e, i);
  __syncthreads();
  if (warp == 0) {
    const int2 w = ws[lane];
    int ce = w.x, ci = w.y;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int ve = __shfl_up_sync(0xffffffffu, ce, o);
      const int vi = __shfl_up_sync(0xffffffffu, ci, o);
      if (lane >= o) {
        ce += ve;
        ci += vi;
      }
    }
    ws[lane] = make_int2(ce - w.x, ci - w.y);
  }
  __syncthreads();
  return make_int2(ws[warp].x + e, ws[warp].y + i);
}

// The plan's first pass: block b's sums of entries and items over its
// kPlanThreads lists, read once and coalesced.
__global__ void __launch_bounds__(kPlanThreads)
plan_sums_kernel(const int* __restrict__ cnt,
                 const int* __restrict__ list_sizes, int nlist, int cap,
                 int chunk, int span, int* __restrict__ sum_e,
                 int* __restrict__ sum_i) {
  __shared__ int2 ws[32];
  const int l = blockIdx.x * kPlanThreads + threadIdx.x;
  const int c = l < nlist ? cnt[l] : 0;
  const int n = l < nlist ? items_of(list_sizes, l, c, cap, chunk, span) : 0;
  const int2 incl = block_scan(c, n, ws);
  if (threadIdx.x == kPlanThreads - 1) {
    sum_e[blockIdx.x] = incl.x;
    sum_i[blockIdx.x] = incl.y;
  }
}

// The second pass: CSR offsets of the entries and of the items by list.
// Block b adds the sums of the blocks before it to a scan of its lists.
__global__ void __launch_bounds__(kPlanThreads)
plan_kernel(const int* __restrict__ cnt, const int* __restrict__ list_sizes,
            int nlist, int cap, int chunk, int span,
            const int* __restrict__ sum_e, const int* __restrict__ sum_i,
            int* __restrict__ off, int* __restrict__ cursor,
            int* __restrict__ item_off, int* __restrict__ n_items) {
  __shared__ int2 ws[32];
  __shared__ int2 base;
  const int l = blockIdx.x * kPlanThreads + threadIdx.x;
  if (threadIdx.x < 32) {
    int be = 0, bi = 0;
    for (int b = threadIdx.x; b < (int)blockIdx.x; b += 32) {
      be += sum_e[b];
      bi += sum_i[b];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      be += __shfl_xor_sync(0xffffffffu, be, o);
      bi += __shfl_xor_sync(0xffffffffu, bi, o);
    }
    if (threadIdx.x == 0) base = make_int2(be, bi);
  }
  const int c = l < nlist ? cnt[l] : 0;
  const int n = l < nlist ? items_of(list_sizes, l, c, cap, chunk, span) : 0;
  const int2 incl = block_scan(c, n, ws);   // its barriers publish base
  const int e0 = base.x + incl.x - c, i0 = base.y + incl.y - n;
  if (l < nlist) {
    off[l] = e0;
    cursor[l] = e0;
    item_off[l] = i0;
  }
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x == kPlanThreads - 1) {
    off[nlist] = e0 + c;
    item_off[nlist] = i0 + n;
    *n_items = i0 + n;
  }
}

__global__ void scatter_kernel(const int* __restrict__ lists, int n_work,
                               int nlist, int* __restrict__ cursor,
                               const int* __restrict__ item_off,
                               int* __restrict__ order,
                               int2* __restrict__ items) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t < n_work) {
    const int raw = lists[t];
    if (raw >= 0) order[atomicAdd(cursor + min(raw, nlist - 1), 1)] = (int)t;
  }
  if (t < nlist) {
    const int i0 = item_off[t], n = item_off[t + 1] - i0;
    for (int i = 0; i < n; ++i) items[i0 + i] = make_int2((int)t, i);
  }
}

inline long long plan_blocks(int nlist) {
  return (nlist + kPlanThreads - 1) / kPlanThreads;
}

// Ints of the scratch before the items: counter, cnt[nlist], off[nlist + 1],
// cursor[nlist], item_off[nlist + 1], n_items, the plan blocks' sums of
// entries and of items, order[n_work].
inline long long scratch_head_ints(int nlist, long long n_work) {
  return 1 + nlist + (nlist + 1) + nlist + (nlist + 1) + 1 +
         2 * plan_blocks(nlist) + n_work;
}

// scratch layout in ints: the head, (pad to even), items[max_items] as int2
long long scratch_ints(const Config& c, int nlist, long long n_work) {
  if (c.direct) return 0;
  long long n = scratch_head_ints(nlist, n_work);
  n += n & 1;
  return n + 2 * c.max_items;
}

// Ints of device scratch a launch needs for these shapes (0: none, the
// direct mode), or -1 when its shared memory or worklist would not fit.
long long checked_scratch_ints(const Config& c, int nlist, long long n_work) {
  if (c.smem + 1024 > kMaxSmem) return -1;
  const long long n = scratch_ints(c, nlist, n_work);
  if (c.max_items + (n_work + kFillRows - 1) / kFillRows > 0x7fffffffLL ||
      n > 0x7fffffffLL)
    return -1;
  return n;
}

// Sets the kernel's shared-memory limit and reads its occupancy at blocks
// of `threads`, once per (kernel, device) and size; `done` and `occupancy`
// are that kernel's.
cudaError_t prepare(const void* kernel, size_t smem, int& done,
                    int& occupancy, int* blocks_per_sm,
                    int threads = kThreads) {
  if ((size_t)done != smem) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occupancy, kernel,
                                                        threads, smem);
    if (err != cudaSuccess) return err;
    done = (int)smem;
  }
  *blocks_per_sm = occupancy;
  return cudaSuccess;
}

// Enqueues `kernel` (blocks of `threads`) over p's units: in direct mode
// one block per span and fill unit; otherwise the worklist's memset,
// histogram, two-pass scan and scatter, then a persistent grid of per_sm
// blocks on each SM.
cudaError_t launch_units(void (*kernel)(Params), int per_sm, Params p,
                         const Config& c, int* scratch, int device,
                         cudaStream_t stream, int threads = kThreads) {
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long n_fill = (p.n_work + kFillRows - 1) / kFillRows;
  p.n_fill = (int)n_fill;
  if (c.direct) {
    p.direct_ub = p.n_work * ((p.cap + c.span - 1) / c.span);
    kernel<<<(unsigned)(p.direct_ub + n_fill), threads, c.smem, stream>>>(p);
    return cudaGetLastError();
  }
  const int nlist = p.nlist;
  int* counter = scratch;
  int* cnt = counter + 1;
  int* off = cnt + nlist;
  int* cursor = off + nlist + 1;
  int* item_off = cursor + nlist;
  int* n_items = item_off + nlist + 1;
  const int nb = (int)plan_blocks(nlist);
  int* sum_e = n_items + 1;
  int* sum_i = sum_e + nb;
  int* order = sum_i + nb;
  const long long pre = scratch_head_ints(nlist, p.n_work);
  int2* items = reinterpret_cast<int2*>(scratch + pre + (pre & 1));
  cudaError_t err =
      cudaMemsetAsync(counter, 0, sizeof(int) * (1 + (size_t)nlist), stream);
  if (err != cudaSuccess) return err;
  const unsigned g_work = (unsigned)((p.n_work + 255) / 256);
  count_kernel<<<g_work, 256, 0, stream>>>(p.lists, p.n_work, nlist, cnt);
  if (nb > 1)  // one block has no blocks before it to sum
    plan_sums_kernel<<<nb, kPlanThreads, 0, stream>>>(
        cnt, p.list_sizes, nlist, p.cap, c.chunk, c.span, sum_e, sum_i);
  plan_kernel<<<nb, kPlanThreads, 0, stream>>>(
      cnt, p.list_sizes, nlist, p.cap, c.chunk, c.span, sum_e, sum_i, off,
      cursor, item_off, n_items);
  const long long n_sc = p.n_work > nlist ? p.n_work : nlist;
  scatter_kernel<<<(unsigned)((n_sc + 255) / 256), 256, 0, stream>>>(
      p.lists, p.n_work, nlist, cursor, item_off, order, items);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  p.counter = counter;
  p.off = off;
  p.order = order;
  p.items = items;
  p.n_items = n_items;
  int n_sm = 0;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  long long grid = (long long)n_sm * per_sm;
  const long long units = c.max_items + n_fill;
  if (grid > units) grid = units;
  kernel<<<(unsigned)grid, threads, c.smem, stream>>>(p);
  return cudaGetLastError();
}

// Whether the dots read float4s of the staged slots and the queries: d %
// 4 == 0 and db, q and (SQ codecs) the scale and bias 16-byte aligned. Both
// scans decide alike, so that they round alike.
inline bool vec4_dots(const void* db, const float* q, const float* sq_scale,
                      const float* sq_bias, int d) {
  auto aligned = [](const void* ptr) {
    return ptr == nullptr || (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
  };
  return d % 4 == 0 && aligned(db) && aligned(q) && aligned(sq_scale) &&
         aligned(sq_bias);
}

// The Params of one launch (worklist fields unset).
Params make_params(const void* db, const float* sq_scale,
                   const float* sq_bias, const float* db_sq,
                   const int* vec_ids, const int* list_sizes, const float* q,
                   const float* q_sq, const int* lists, float* scores,
                   int* ids, long long n_work, int n_slots, int nlist,
                   int cap, int d, int is_l2, const Config& c) {
  Params p = {};
  p.db = db;
  p.sq_scale = sq_scale;
  p.sq_bias = sq_bias;
  p.db_sq = db_sq;
  p.vec_ids = vec_ids;
  p.list_sizes = list_sizes;
  p.q = q;
  p.q_sq = q_sq;
  p.lists = lists;
  p.scores = scores;
  p.ids = ids;
  p.n_work = (int)n_work;
  p.n_slots = n_slots;
  p.nlist = nlist;
  p.cap = cap;
  p.d = d;
  p.is_l2 = is_l2;
  p.tile = c.tile;
  p.chunk = c.chunk;
  p.span = c.span;
  p.slot_bytes = c.slot_bytes;
  p.stage_bytes = c.stage_bytes;
  return p;
}

}  // namespace
