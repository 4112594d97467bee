// Padded-layout probe scan for Hopper (sm_90a):
//
//     for every query b, probe slot s and list slot c, with l = lists[b, s]:
//     scores[b, s * cap + c] = max((q_sq[b] + db_sq[l, c]) - 2 * dot, 0)  (L2)
//                              dot                                       (IP)
//     ids[b, s * cap + c]    = vec_ids[l, c]
//
// where dot = <db[l, c, :], q[b, :]>. A slot is dead, and gets the metric's
// worst value (+inf for L2, -inf for IP) and id -1, when l < 0 (an inactive
// probe slot), c >= list_sizes[l] or vec_ids[l, c] < 0. List ids >= nlist
// are clamped to nlist - 1, as XLA clamps a gather.
//
// Replaces the Pallas TPU kernel
// auncel_tpu/pallas_kernels/scan_scores.py::scan_scores_pallas, with the
// semantics of the JAX package's XLA scan rather than the TPU kernel's
// workarounds: the stored norms db_sq instead of an in-kernel ||x||^2 (so
// every term but the dot is bitwise the plain version's), padding decided by
// vec_ids and list_sizes instead of zero norm (an exact-zero stored vector
// is a valid result), inactive slots marked by list id -1, and no
// n_slots % 8 rule.
//
// Storage codecs (worklist.cuh): db holds float32 or bfloat16 vectors, or
// uint8 SQ8/SQ4/SQ6 codes with sq_scale and sq_bias; the XLA scan decodes a
// gathered block before its einsum (auncel_tpu/index/scan.py:226), here the
// ring stages the stored bytes and the dot units decode each element in
// registers. A float32 tile is copied slot by slot, as before the codecs; a
// coded tile is one contiguous run of bytes, copied with 16-byte cp.async
// where its address allows, else 4-byte, else byte by byte. SQ codes at the
// widths sq_scan.cuh takes (d % 16 == 0; SQ4 d % 32 == 0; aligned bases)
// go to that scan, shared with K1, with items of one 256-slot stage (the
// heaviest items, many queries on a long list, then spread over the
// blocks): at the 10M cell's training chunk, about one query a list, the
// 64-slot tiles below left most warps idle and each item paid a pipeline
// fill of its own.
//
// What bounds it: device-memory bandwidth. The least traffic is each
// distinct probed list's live slots read once (the slot's stored bytes,
// 4d for float32 and d for SQ8, plus norm and id) and 8 bytes of output
// (score and id) written for every slot of every (query, probe slot) row,
// live or dead. A query-major schedule (one
// block per (query, probe slot, tile)) reads a list once per query probing
// it: at the 1M index's window chunk about 9 times on average, 3.9 GB where
// the bound needs 0.55 GB. This design is list-major:
//   * the (b, s) entries are grouped by list on the device (histogram, scan
//     and scatter into a CSR, no host sync), and a worklist of items
//     (list, span of kTilesPerItem tiles of the list's live slots, chunk of
//     up to `chunk` of its entries) is written beside it. A persistent grid
//     takes the items from an atomic counter; the chunks of one span are
//     neighbours in the list, so a span leaves device memory once and its
//     other chunks find it in L2. Up to `chunk` entries a call skips the
//     worklist: each block groups the entries itself (__match_any_sync) and
//     takes one span of kDirectTiles tiles, so batch 1 costs a single
//     launch;
//   * an item starts the copy of its first tile, stages its queries, and
//     streams its tiles through a two-stage shared-memory ring with
//     cp.async (16-byte copies; 4-byte when d % 4 != 0 or a base is not
//     16-byte aligned). A stage is refilled as soon as its dots are taken,
//     so two tiles' copies run under one tile's epilogue and the next
//     tile's dots. Slots at or past list_sizes and inactive entries read
//     nothing: separate fill units write their worst values and -1;
//   * fp32 FMA, no tensor cores (the distance path is fp32 with no TF32).
//     A warp takes 32 (slot, query) pairs at a time, 8 slots x 4 queries,
//     or 16 x 2 or 32 x 1 when the chunk has one or two queries; each lane
//     keeps the strided partial sums over its part of d, and one
//     31-shuffle reduce-scatter leaves each lane one finished dot. The
//     partial sums and the tree that adds them are those of the
//     query-major design this one replaced, so the dots are bitwise the
//     same;
//   * the dots are staged in shared memory and each (b, s) row segment of
//     the tile is written as one coalesced run of scores and ids.
// Two blocks of 256 threads per SM (up to 128 registers a thread): on an
// H100, more blocks with smaller tiles, or deeper rings, ran slower.
// The worklist, run_units, the dots and the fill units are in
// worklist.cuh, shared with K1's row scan (csrc/rowscan.cu); the ring and
// the epilogue are this file's.
//
// Product quantization: db holds M uint8 codes a slot, pq_books the [M,
// 256, d / M] codebook. The XLA scan decodes a gathered block by a codebook
// gather and contracts it (auncel_tpu/ops/pq.py:5-11, index/scan.py:226-
// 247). Here the codes are never decoded: asymmetric distance computation
// (ADC) with lookup tables in shared memory. An item (list l, span of its
// live slots, chunk of its entries) first builds, for each entry (b, s) of
// the chunk, the table
//     T[m][c] = sum_{j < dsub} r[m * dsub + j] * books[m][c][j]
// (fp32 FMAs in order of j; r = q_b - c_l for residual codes, else q_b),
// M x 256 floats; then a slot's dot is sum_m T[m][code[m]], M lookups and
// adds in order of m. Everything but the dot is as on the other codecs:
// the stored db_sq, ||q_b - c_l||^2 in q_sq's place for residual L2 (its
// sum staged as before), + <c_l, q_b> for residual IP, the clamp, the dead
// slots.
//   * A table costs 256 * d FMAs and d KB of codebook reads, a slot M
//     lookups, so a table must outlive many tiles: a PQ item spans a whole
//     list unless the (list, chunk) groups would underfill the grid (batch
//     1): then each list is cut into as many spans as bring the items near
//     kPQItems. The launch first transposes the codebook into scratch
//     ([M][dsub][256]), so that the 256 threads building a table, one
//     codeword each, read consecutive floats; each thread keeps 16 loads
//     in flight. Strided reads of the [M][256][dsub] codebook made the
//     build the larger part of an item.
//   * One thread a slot: a tile is 256 slots, a two-stage ring stages
//     their codes, norms and ids with cp.async, and each (b, s) row of the
//     tile is written as one coalesced run. The codes are read as 16-byte
//     groups when M % 16 == 0 (a warp's 32 slots then read without bank
//     conflicts). The entries of a chunk are scored one after the other
//     (no per-entry registers, so no predicated work for absent entries).
//   * The chunk holds as many entries as keep kPQBlocks (3) blocks on an
//     SM: 3 at M 16, 1 at M 64; at least one, so M is bounded by one
//     table (M KB) and two tiles of codes (512 M bytes) within the 227 KB
//     of a block (kernels/scan_scores.py's check_pq_fits: M <= 147).
//   * Lookups conflict in shared-memory banks: a warp's 32 slots read 32
//     random codes of one table row, about 3.5 ways on average, and no
//     layout helps, since the bank is the code's (rotating m per lane only
//     moves the conflict). They do not bound the kernel: a call with every
//     code dropped by the filter (no lookups) is only a little faster.
//   * Polysemous filter (qcodes [n_work, M], ht): the item stages each
//     entry's query code beside its table; a live slot's Hamming distance
//     to it is M / 4 XOR-popcounts, and a slot more than ht bits away is
//     dead (worst value, id -1) and takes no lookups (its lane waits for
//     the warp's others) rather than compacting the kept (slot, entry)
//     pairs across the block, which was tried and was slower. A kept
//     slot sums its lookups as without the filter, so its score is bitwise
//     the same.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

#include "sq_scan.cuh"

namespace {

constexpr int kTilesPerItem = 8;
constexpr int kSqItemTiles = 1;       // SQ codes: 256-slot tiles an item
constexpr int kNormStages = 3;        // norms and ids live one step longer
constexpr int kMaxChunkPQ = 8;        // PQ: entries (tables) of an item
constexpr long long kPQItems = 2048;  // PQ: items a call aims for
constexpr int kPQBlocks = 3;          // PQ: blocks an SM holds
// PQ: the dynamic shared memory of a block when kPQBlocks share an SM (228
// KB a SM, 1 KB of it reserved a block, run_units' own variables)
constexpr size_t kPQBlockSmem = 233472 / kPQBlocks - 1024 - 256;

Config scan_config(int nlist, int cap, int d, int slot_bytes,
                   long long n_work) {
  Config c = make_config(nlist, cap, d, slot_bytes, n_work, kTilesPerItem);
  // ring, queries, dots, norms and ids of the ring, q_sq and rows
  c.smem = (size_t)kStages * c.stage_bytes +
           4 * ((size_t)c.chunk * d + (size_t)c.chunk * c.tile +
                2 * kNormStages * c.tile + 2 * c.chunk);
  return c;
}

// Shared memory of a PQ block: tables, ring, query codes (16-byte
// aligned), staged queries, norms and ids of the ring, q_sq and rows
// (kernels/scan_scores.py's pq_shared_bytes at chunk 1).
size_t pq_smem_bytes(const Config& c, int d, int chunk) {
  const size_t m = c.slot_bytes;
  return (size_t)chunk * m * 256 * 4 + (size_t)kStages * c.stage_bytes +
         ((size_t)chunk * m + 15) / 16 * 16 +
         4 * ((size_t)chunk * d + 2 * kStages * (size_t)c.tile +
              2 * (size_t)chunk);
}

// The PQ layout (codes of m bytes a slot): a tile of one slot a thread;
// the chunk as large as kPQBlocks blocks an SM allow (at least 1); whole
// lists as spans unless fewer (list, chunk) groups than kPQItems: then
// each list in as many spans as bring the items near kPQItems.
Config pq_config(int nlist, int cap, int d, int m, long long n_work) {
  Config c;
  c.tile = kThreads;
  c.slot_bytes = m;
  c.stage_bytes = (c.tile * m + 15) / 16 * 16;
  c.direct = false;
  c.chunk = 1;
  while (c.chunk < kMaxChunkPQ &&
         pq_smem_bytes(c, d, c.chunk + 1) <= kPQBlockSmem)
    ++c.chunk;
  long long groups = n_work < nlist ? n_work : nlist;
  if (groups < 1) groups = 1;
  const long long n_tiles = ((long long)cap + c.tile - 1) / c.tile;
  long long per = (kPQItems + groups - 1) / groups;
  per = per < 1 ? 1 : per > n_tiles ? n_tiles : per;
  long long span_tiles = (n_tiles + per - 1) / per;
  const long long max_tiles = 0x7fffffffLL / c.tile;
  if (span_tiles > max_tiles) span_tiles = max_tiles;
  c.span = (int)(span_tiles * c.tile);
  c.smem = pq_smem_bytes(c, d, c.chunk);
  c.max_items = ((cap + (long long)c.span - 1) / c.span) *
                (n_work / c.chunk + groups);
  return c;
}

struct Smem {
  unsigned char* ring;  // [kStages][stage_bytes]: tile stored slots each
  float* qs;      // [chunk][d]
  float* dots;    // [chunk][tile]
  float* sq;      // [kNormStages][tile]
  int* vid;       // [kNormStages][tile]
  float* qsq;     // [chunk]
  int* rows;      // [chunk]
};

__device__ __forceinline__ Smem carve(const Params& p, unsigned char* base) {
  Smem s;
  s.ring = base;
  s.qs = reinterpret_cast<float*>(s.ring + kStages * p.stage_bytes);
  s.dots = s.qs + p.chunk * p.d;
  s.sq = s.dots + p.chunk * p.tile;
  s.vid = reinterpret_cast<int*>(s.sq + kNormStages * p.tile);
  s.qsq = reinterpret_cast<float*>(s.vid + kNormStages * p.tile);
  s.rows = reinterpret_cast<int*>(s.qsq + p.chunk);
  return s;
}

// Copies of the norms and ids of a tile's live slots (tile <= kThreads)
// into stage `stage` of sq and vid.
__device__ __forceinline__ void issue_norms(const Params& p, float* sq,
                                            int* vid, long long list_off,
                                            int c0, int n_live, int stage) {
  if (threadIdx.x < n_live) {
    const int j = stage * p.tile + threadIdx.x;
    cp_async4(sq + j, p.db_sq + list_off + c0 + threadIdx.x);
    cp_async4(vid + j, p.vec_ids + list_off + c0 + threadIdx.x);
  }
}

// Copies of tile t of the item (live slots only): stored slots into ring
// stage t % kStages, norms and ids into stage t % kNormStages.
template <typename Codec, bool kVec4>
__device__ __forceinline__ void issue_tile(const Params& p, const Smem& s,
                                           long long list_off, int c0,
                                           int n_live, int t) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned char* stage = s.ring + (t % kStages) * p.stage_bytes;
  float* dst = reinterpret_cast<float*>(stage);
  const float* src = static_cast<const float*>(p.db) + (list_off + c0) * p.d;
  if constexpr (!std::is_same<Codec, F32>::value) {
    copy_bytes(stage,
               static_cast<const unsigned char*>(p.db) +
                   (list_off + c0) * p.slot_bytes,
               n_live * p.slot_bytes);
  } else if (kVec4) {
    const int d4 = p.d >> 2;
    for (int r = warp; r < n_live; r += kWarps)
      for (int i = lane; i < d4; i += 32)
        cp_async16(dst + r * p.d + 4 * i, src + (long long)r * p.d + 4 * i);
  } else {
    for (int r = warp; r < n_live; r += kWarps)
      for (int i = lane; i < p.d; i += 32)
        cp_async4(dst + r * p.d + i, src + (long long)r * p.d + i);
  }
  issue_norms(p, s.sq, s.vid, list_off, c0, n_live, t % kNormStages);
}

// Scores and ids of list l's live slots [c_begin, c_end) for nq entries
// (ents: b * n_slots + s), each slot read from device memory once.
template <typename Codec, bool kVec4>
__device__ void scan_item(const Params& p, const Smem& s, int l, int c_begin,
                          int c_end, int nq, const int* ents) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float worst = p.is_l2 ? CUDART_INF_F : -CUDART_INF_F;
  const long long list_off = (long long)l * p.cap;
  const int d = p.d;
  const int n_tiles = (c_end - c_begin + p.tile - 1) / p.tile;
  auto issue = [&](int t) {
    const int c0 = c_begin + t * p.tile;
    issue_tile<Codec, kVec4>(p, s, list_off, c0, min(p.tile, c_end - c0),
                             t);
  };
  // Two tiles in flight: tile t + 2's copy starts as soon as tile t's dots
  // are taken, under tile t's epilogue and tile t + 1's dots. One copy
  // group per tile, the first with the queries; the first tile's copy
  // starts before the entries are read. A group is committed at every
  // step, empty past the last tile, so that "all groups but the newest"
  // is always the tile in use.
  issue(0);
  if (threadIdx.x < nq) {
    const int e = ents[threadIdx.x];
    s.rows[threadIdx.x] = e;
    s.qsq[threadIdx.x] = p.q_sq[e / p.n_slots];
  }
  __syncthreads();
  for (int k = warp; k < nq; k += kWarps) {
    const float* src = p.q + (long long)(s.rows[k] / p.n_slots) * d;
    float* dst = s.qs + k * d;
    if (kVec4) {
      for (int i = lane; i < (d >> 2); i += 32)
        cp_async16(dst + 4 * i, src + 4 * i);
    } else {
      for (int i = lane; i < d; i += 32) cp_async4(dst + i, src + i);
    }
  }
  cp_async_commit();
  if (n_tiles > 1) issue(1);
  cp_async_commit();

  for (int t = 0; t < n_tiles; ++t) {
    const int c0 = c_begin + t * p.tile;
    const int n_live = min(p.tile, c_end - c0);
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncthreads();

    // dots: units of 32 (slot, query) pairs, round robin over the warps
    tile_dots<Codec, kVec4>(p, s.qs, s.dots,
                            s.ring + (t % kStages) * p.stage_bytes, n_live,
                            nq);
    __syncthreads();
    if (t + 2 < n_tiles) issue(t + 2);
    cp_async_commit();

    // epilogue: one coalesced run of the tile per (b, s) row
    const float* sq = s.sq + (t % kNormStages) * p.tile;
    const int* vid = s.vid + (t % kNormStages) * p.tile;
    for (int k = warp; k < nq; k += kWarps) {
      const long long base = (long long)s.rows[k] * p.cap + c0;
      const float q_sq = s.qsq[k];
      for (int c = lane; c < n_live; c += 32) {
        const int id = vid[c];
        float score = worst;
        if (id >= 0) {
          const float dot = s.dots[k * p.tile + c];
          // (q_sq + db_sq) - 2 * dot, rounded step by step as the plain
          // version does; 2 * dot is exact, so no contraction can change it
          score = p.is_l2
                      ? fmaxf(__fsub_rn(__fadd_rn(q_sq, sq[c]), 2.0f * dot),
                              0.0f)
                      : dot;
        }
        p.scores[base + c] = score;
        p.ids[base + c] = id >= 0 ? id : -1;
      }
    }
  }
  __syncthreads();  // the next item reuses the buffers
}

template <typename Codec, bool kVec4>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
scan_lists_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem s = carve(p, smem);
  run_units(p, [&](int l, int c_begin, int c_end, int nq, const int* ents) {
    scan_item<Codec, kVec4>(p, s, l, c_begin, c_end, nq, ents);
  });
}

// ---- product quantization: ADC lookup tables

static_assert(kThreads == 256, "a PQ table row is built one codeword a "
              "thread, and a PQ tile is one slot a thread");

struct PQSmem {
  float* tab;             // [chunk][M][256] lookup tables
  unsigned char* ring;    // [kStages][stage_bytes]: a tile's codes each
  unsigned char* qcode;   // [chunk][M] the entries' query codes (filter)
  float* qs;              // [chunk][d] the tables' queries
  float* sq;              // [kStages][tile] the tiles' norms
  int* vid;               // [kStages][tile] and ids
  float* qsq;             // [chunk]
  int* rows;              // [chunk]
};

__device__ __forceinline__ PQSmem carve_pq(const Params& p,
                                           unsigned char* base) {
  const int m = p.slot_bytes;
  PQSmem s;
  s.tab = reinterpret_cast<float*>(base);
  s.ring = base + (size_t)p.chunk * m * 256 * 4;
  s.qcode = s.ring + kStages * p.stage_bytes;
  s.qs = reinterpret_cast<float*>(s.qcode + (p.chunk * m + 15) / 16 * 16);
  s.sq = s.qs + p.chunk * p.d;
  s.vid = reinterpret_cast<int*>(s.sq + kStages * p.tile);
  s.qsq = reinterpret_cast<float*>(s.vid + kStages * p.tile);
  s.rows = reinterpret_cast<int*>(s.qsq + p.chunk);
  return s;
}

// The queries of the item's tables on list l: q_b - c_l with its squared
// norm in qsq[k] (residual L2), q_b with <c_l, q_b> in qsq[k] (residual
// IP), else q_b (qsq[k] holds q_sq[b]). One warp a query: the lanes take
// strided elements and a butterfly adds their partial sums.
template <bool kRes>
__device__ __forceinline__ void stage_queries(const Params& p,
                                              const PQSmem& s, int l,
                                              int nq) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int d = p.d;
  for (int k = warp; k < nq; k += kWarps) {
    const float* src = p.q + (long long)(s.rows[k] / p.n_slots) * d;
    float* dst = s.qs + k * d;
    if constexpr (!kRes) {
      for (int i = lane; i < d; i += 32) dst[i] = __ldg(src + i);
      continue;
    }
    const float* cl = p.centroids + (long long)l * d;
    float acc = 0.f;
    for (int i = lane; i < d; i += 32) {
      const float qv = __ldg(src + i), cv = __ldg(cl + i);
      if (p.is_l2) {
        const float r = __fsub_rn(qv, cv);
        dst[i] = r;
        acc = fmaf(r, r, acc);
      } else {
        dst[i] = qv;
        acc = fmaf(cv, qv, acc);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) s.qsq[k] = acc;
  }
}

// tab[k][m][c] = sum_j qs[k][m * dsub + j] * books[m][c][j] for the K
// staged queries, fp32 FMAs in order of j from 0. Thread c takes codeword
// c of every subspace from the transposed codebook (books_t[m][j][c], so a
// warp's loads are coalesced), each element read once for all K tables
// and kLoads at a time, so that their latencies overlap.
template <int K>
__device__ __forceinline__ void build_tables(const Params& p,
                                             const PQSmem& s) {
  constexpr int kLoads = 16;
  const int m_all = p.slot_bytes, d = p.d, dsub = d / m_all;
  const int c = threadIdx.x;
  const float* col = p.pq_books + c;
  float acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = 0.f;
  int m = 0, j = 0;
  for (int i0 = 0; i0 < d; i0 += kLoads) {
    float x[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u)
      x[u] = i0 + u < d ? __ldg(col + (long long)(i0 + u) * 256) : 0.f;
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      if (i0 + u < d) {
#pragma unroll
        for (int k = 0; k < K; ++k)
          acc[k] = fmaf(s.qs[k * d + i0 + u], x[u], acc[k]);
        if (++j == dsub) {
#pragma unroll
          for (int k = 0; k < K; ++k) {
            s.tab[(k * m_all + m) * 256 + c] = acc[k];
            acc[k] = 0.f;
          }
          j = 0;
          ++m;
        }
      }
    }
  }
}

// build_tables for the item's nq (1 to kMaxChunkPQ) queries.
__device__ __forceinline__ void build_tables(const Params& p,
                                             const PQSmem& s, int nq) {
  static_assert(kMaxChunkPQ == 8, "one case a chunk size");
  switch (nq) {
    case 1: build_tables<1>(p, s); break;
    case 2: build_tables<2>(p, s); break;
    case 3: build_tables<3>(p, s); break;
    case 4: build_tables<4>(p, s); break;
    case 5: build_tables<5>(p, s); break;
    case 6: build_tables<6>(p, s); break;
    case 7: build_tables<7>(p, s); break;
    default: build_tables<8>(p, s);
  }
}

// Codes [4w, 4w + 4) of a staged slot as one little-endian word (the
// bytes past m zero).
__device__ __forceinline__ unsigned code_word(const unsigned char* code,
                                              int w, int m) {
  if ((m & 3) == 0) return reinterpret_cast<const unsigned*>(code)[w];
  unsigned v = 0;
  for (int b = 0; b < 4 && 4 * w + b < m; ++b)
    v |= (unsigned)code[4 * w + b] << (8 * b);
  return v;
}

// acc + tab[i][code[i]] for subspaces i = 4w .. 4w + 3 (those below m,
// unless kAll), added in that order.
template <bool kAll>
__device__ __forceinline__ float lookup4(const float* tab, unsigned word,
                                         int w, int m, float acc) {
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const int i = 4 * w + b;
    if (kAll || i < m) acc += tab[i * 256 + ((word >> (8 * b)) & 255u)];
  }
  return acc;
}

// The dot of one staged slot by one table: sum_m tab[m][code[m]], added in
// order of m from 0. The codes are read as 16-byte groups when m % 16 == 0
// (a warp's 32 slots then read without bank conflicts), else as words.
__device__ __forceinline__ float adc_dot(const float* tab,
                                         const unsigned char* code, int m) {
  float acc = 0.f;
  if ((m & 15) == 0) {
    for (int g = 0; g < m / 16; ++g) {
      const uint4 v = reinterpret_cast<const uint4*>(code)[g];
      acc = lookup4<true>(tab, v.x, 4 * g, m, acc);
      acc = lookup4<true>(tab, v.y, 4 * g + 1, m, acc);
      acc = lookup4<true>(tab, v.z, 4 * g + 2, m, acc);
      acc = lookup4<true>(tab, v.w, 4 * g + 3, m, acc);
    }
  } else {
    for (int w = 0; 4 * w < m; ++w)
      acc = lookup4<false>(tab, code_word(code, w, m), w, m, acc);
  }
  return acc;
}

// The Hamming distance between a staged slot's code and a query code,
// read as 16-byte groups when m % 16 == 0, else as words.
__device__ __forceinline__ int hamming(const unsigned char* code,
                                       const unsigned char* qcode, int m) {
  int ham = 0;
  if ((m & 15) == 0) {
    for (int g = 0; g < m / 16; ++g) {
      const uint4 a = reinterpret_cast<const uint4*>(code)[g];
      const uint4 b = reinterpret_cast<const uint4*>(qcode)[g];
      ham += __popc(a.x ^ b.x) + __popc(a.y ^ b.y) + __popc(a.z ^ b.z) +
             __popc(a.w ^ b.w);
    }
    return ham;
  }
  for (int w = 0; 4 * w < m; ++w)
    ham += __popc(code_word(code, w, m) ^ code_word(qcode, w, m));
  return ham;
}

// The score of a live slot from its dot: (q_sq + db_sq) - 2 * dot, rounded
// step by step, clamped at 0 (L2; for residual codes q_sq holds ||q -
// c_l||^2), <c_l, q> + dot (residual IP) or the dot (IP).
template <bool kRes>
__device__ __forceinline__ float pq_score(const Params& p, float q_sq,
                                          float db_sq, float dot) {
  if (p.is_l2)
    return fmaxf(__fsub_rn(__fadd_rn(q_sq, db_sq), 2.0f * dot), 0.0f);
  return kRes ? __fadd_rn(q_sq, dot) : dot;
}

// Scores and ids of list l's live slots [c_begin, c_end) for nq entries by
// their lookup tables, one slot a thread. kRes: residual codes; kFilter:
// the polysemous filter (qcodes, ht).
template <bool kRes, bool kFilter>
__device__ void scan_pq_item(const Params& p, const PQSmem& s, int l,
                             int c_begin, int c_end, int nq,
                             const int* ents) {
  const int c = threadIdx.x;
  const int m = p.slot_bytes;
  const float worst = p.is_l2 ? CUDART_INF_F : -CUDART_INF_F;
  const long long list_off = (long long)l * p.cap;
  const int n_tiles = (c_end - c_begin + p.tile - 1) / p.tile;
  auto issue = [&](int t) {
    const int c0 = c_begin + t * p.tile;
    const int n_live = min(p.tile, c_end - c0);
    copy_bytes(s.ring + (t % kStages) * p.stage_bytes,
               static_cast<const unsigned char*>(p.db) +
                   (list_off + c0) * m,
               n_live * m);
    issue_norms(p, s.sq, s.vid, list_off, c0, n_live, t % kStages);
  };
  // The first tile's copy runs under the tables' build; then two tiles are
  // in flight: tile t + 2 is copied as soon as tile t is scored. One copy
  // group a tile, committed at every step (empty past the last tile), so
  // that "all groups but the newest" is always the tile in use.
  issue(0);
  if (c < nq) {
    const int e = ents[c];
    s.rows[c] = e;
    s.qsq[c] = p.q_sq[e / p.n_slots];
  }
  __syncthreads();
  stage_queries<kRes>(p, s, l, nq);
  if constexpr (kFilter) {
    for (int i = c; i < nq * m; i += kThreads)
      s.qcode[i] = p.qcodes[(long long)s.rows[i / m] * m + i % m];
  }
  __syncthreads();
  build_tables(p, s, nq);  // visible after the barrier that opens tile 0
  cp_async_commit();
  if (n_tiles > 1) issue(1);
  cp_async_commit();

  for (int t = 0; t < n_tiles; ++t) {
    const int c0 = c_begin + t * p.tile;
    const int n_live = min(p.tile, c_end - c0);
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncthreads();
    const unsigned char* ring = s.ring + (t % kStages) * p.stage_bytes;
    const float* sq = s.sq + (t % kStages) * p.tile;
    const int* vid = s.vid + (t % kStages) * p.tile;
    const int id = c < n_live ? vid[c] : -1;
    const unsigned char* code = ring + c * m;
    if (c < n_live) {
      // a slot the filter drops (more than ht bits from the entry's query
      // code) is dead and takes no lookups; its lanes wait for the others
      const float dsq = sq[c];
      for (int k = 0; k < nq; ++k) {
        bool live = id >= 0;
        if constexpr (kFilter)
          live = live && hamming(code, s.qcode + k * m, m) <= p.ht;
        const long long at = (long long)s.rows[k] * p.cap + c0 + c;
        p.scores[at] = live ? pq_score<kRes>(
                                  p, s.qsq[k], dsq,
                                  adc_dot(s.tab + k * m * 256, code, m))
                            : worst;
        p.ids[at] = live ? id : -1;
      }
    }
    __syncthreads();
    if (t + 2 < n_tiles) issue(t + 2);
    cp_async_commit();
  }
}

template <bool kRes, bool kFilter>
__global__ void __launch_bounds__(kThreads, kPQBlocks)
scan_pq_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const PQSmem s = carve_pq(p, smem);
  run_units(p, [&](int l, int c_begin, int c_end, int nq, const int* ents) {
    scan_pq_item<kRes, kFilter>(p, s, l, c_begin, c_end, nq, ents);
  });
}

// books_t[m][j][c] = books[m][c][j]: the codebook transposed so that the
// threads of a table's build, one codeword each, read consecutive floats.
// One block of 256 threads a subspace.
__global__ void transpose_books_kernel(const float* __restrict__ books,
                                       int dsub, float* __restrict__ books_t) {
  const long long m = blockIdx.x, c = threadIdx.x;
  for (int j = 0; j < dsub; ++j)
    books_t[(m * dsub + j) * 256 + c] = books[(m * 256 + c) * dsub + j];
}

// Enqueues `kernel` (one instance's own shared-memory state in done_smem
// and occupancy) over p's units.
cudaError_t launch_kernel(void (*kernel)(Params), int* done_smem,
                          int* occupancy, const Params& p, const Config& c,
                          int* scratch, int device, cudaStream_t stream) {
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  int per_sm = 0;
  const cudaError_t err = prepare((const void*)kernel, c.smem,
                                  done_smem[device], occupancy[device],
                                  &per_sm);
  if (err != cudaSuccess) return err;
  return launch_units(kernel, per_sm, p, c, scratch, device, stream);
}

template <typename Codec, bool kVec4>
cudaError_t launch(const Params& p, const Config& c, int* scratch, int device,
                   cudaStream_t stream) {
  static int done_smem[64], occupancy[64];
  return launch_kernel(scan_lists_kernel<Codec, kVec4>, done_smem, occupancy,
                       p, c, scratch, device, stream);
}

template <typename Codec>
cudaError_t launch_codec(const Params& p, const Config& c, bool vec4,
                         int* scratch, int device, cudaStream_t stream) {
  return vec4 ? launch<Codec, true>(p, c, scratch, device, stream)
              : launch<Codec, false>(p, c, scratch, device, stream);
}

template <bool kRes, bool kFilter>
cudaError_t launch_pq(const Params& p, const Config& c, int* scratch,
                      int device, cudaStream_t stream) {
  static int done_smem[64], occupancy[64];
  return launch_kernel(scan_pq_kernel<kRes, kFilter>, done_smem, occupancy,
                       p, c, scratch, device, stream);
}

// Where the transposed codebook starts in a PQ call's scratch: after the
// worklist's ints, 16-byte aligned.
long long pq_books_offset(const Config& c, int nlist, long long n_work) {
  return (scratch_ints(c, nlist, n_work) + 3) / 4 * 4;
}

}  // namespace

// Ints of device scratch that scan_scores_launch needs for these shapes
// and codec (0: none, the direct mode), or -1 when the codec does not pack
// d or the shared memory or worklist would not fit.
extern "C" long long scan_scores_scratch_ints(int nlist, int cap, int d,
                                              long long n_work, int codec) {
  const int w = codec_slot_bytes(codec, d);
  if (w <= 0) return -1;
  const Config c = scan_config(nlist, cap, d, w, n_work);
  return with_sq_scratch(checked_scratch_ints(c, nlist, n_work), codec, d,
                         nlist, cap, n_work, kSqItemTiles);
}

// Enqueues the scan on `stream` (a cudaStream_t) of device `device`:
// n_work = B * n_slots (query, probe slot) rows; `scratch` holds
// scan_scores_scratch_ints(...) ints (may be null when that is 0); db holds
// slots of the codec (worklist.cuh's CodecId), sq_scale and sq_bias [d]
// the SQ codecs' range (else null). Returns the first CUDA error of the
// enqueued launches (cudaGetLastError()): 0 on success. Does not
// synchronise.
extern "C" int scan_scores_launch(const void* db, const float* db_sq,
                                  const int* vec_ids, const int* list_sizes,
                                  const float* q, const float* q_sq,
                                  const int* lists, float* scores, int* ids,
                                  int* scratch, const float* sq_scale,
                                  const float* sq_bias, long long n_work,
                                  int n_slots, int nlist, int cap, int d,
                                  int is_l2, int codec, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_work <= 0 || cap <= 0) return 0;
  if (scan_scores_scratch_ints(nlist, cap, d, n_work, codec) < 0)
    return (int)cudaErrorInvalidValue;
  const bool affine = codec >= kCodecSQ8;
  if (affine && (sq_scale == nullptr || sq_bias == nullptr))
    return (int)cudaErrorInvalidValue;
  const Config c =
      scan_config(nlist, cap, d, codec_slot_bytes(codec, d), n_work);
  if (!c.direct && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const Params p = make_params(db, sq_scale, sq_bias, db_sq, vec_ids,
                               list_sizes, q, q_sq, lists, scores, ids,
                               n_work, n_slots, nlist, cap, d, is_l2, c);
  const bool vec4 = vec4_dots(db, q, sq_scale, sq_bias, d);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Config sc;
  if (sq_route(codec, d, vec4, nlist, cap, n_work, kSqItemTiles, sc)) {
    const Params ps = make_params(db, sq_scale, sq_bias, db_sq, vec_ids,
                                  list_sizes, q, q_sq, lists, scores, ids,
                                  n_work, n_slots, nlist, cap, d, is_l2, sc);
    return (int)launch_sq_any(codec, ps, sc, scratch, device, s);
  }
  switch (codec) {
    case kCodecF32: err = launch_codec<F32>(p, c, vec4, scratch, device, s);
      break;
    case kCodecBF16: err = launch_codec<BF16>(p, c, vec4, scratch, device, s);
      break;
    case kCodecSQ8: err = launch_codec<SQ8>(p, c, vec4, scratch, device, s);
      break;
    case kCodecSQ4: err = launch_codec<SQ4>(p, c, vec4, scratch, device, s);
      break;
    default: err = launch_codec<SQ6>(p, c, vec4, scratch, device, s);
  }
  return (int)err;
}

// Ints of device scratch that scan_scores_pq_launch needs for these shapes
// (codes of m bytes a slot, d % m == 0): the worklist (a PQ call always
// takes it) and the transposed codebook; or -1 when m does not divide d,
// or one query's table and the ring do not fit a block's shared memory,
// or the scratch would not fit int32.
extern "C" long long scan_scores_pq_scratch_ints(int nlist, int cap, int d,
                                                 int m, long long n_work) {
  if (m <= 0 || d % m != 0) return -1;
  const Config c = pq_config(nlist, cap, d, m, n_work);
  if (checked_scratch_ints(c, nlist, n_work) < 0) return -1;
  const long long n = pq_books_offset(c, nlist, n_work) + 256LL * d;
  return n > 0x7fffffffLL ? -1 : n;
}

// Enqueues the scan of PQ codes (m bytes a slot) on `stream` of device
// `device`: books [m, 256, d / m] f32; centroids [nlist, d] f32 for
// residual codes, else null; qcodes [n_work, m] uint8, the query's code
// for each (query, probe slot) row, with the Hamming threshold ht for the
// polysemous filter, else null. The rest as scan_scores_launch. Returns
// the first CUDA error of the enqueued launches: 0 on success. Does not
// synchronise.
extern "C" int scan_scores_pq_launch(const void* db, const float* db_sq,
                                     const int* vec_ids,
                                     const int* list_sizes, const float* q,
                                     const float* q_sq, const int* lists,
                                     float* scores, int* ids, int* scratch,
                                     const float* books,
                                     const float* centroids,
                                     const unsigned char* qcodes,
                                     long long n_work, int n_slots, int nlist,
                                     int cap, int d, int m, int is_l2,
                                     int ht, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_work <= 0 || cap <= 0) return 0;
  if (books == nullptr || scratch == nullptr ||
      scan_scores_pq_scratch_ints(nlist, cap, d, m, n_work) < 0)
    return (int)cudaErrorInvalidValue;
  const Config c = pq_config(nlist, cap, d, m, n_work);
  Params p = make_params(db, nullptr, nullptr, db_sq, vec_ids, list_sizes, q,
                         q_sq, lists, scores, ids, n_work, n_slots, nlist,
                         cap, d, is_l2, c);
  float* books_t =
      reinterpret_cast<float*>(scratch + pq_books_offset(c, nlist, n_work));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  transpose_books_kernel<<<m, 256, 0, s>>>(books, d / m, books_t);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  p.pq_books = books_t;
  p.centroids = centroids;
  p.qcodes = qcodes;
  p.ht = ht;
  const bool res = centroids != nullptr, filter = qcodes != nullptr;
  if (res)
    return (int)(filter ? launch_pq<true, true>(p, c, scratch, device, s)
                        : launch_pq<true, false>(p, c, scratch, device, s));
  return (int)(filter ? launch_pq<false, true>(p, c, scratch, device, s)
                      : launch_pq<false, false>(p, c, scratch, device, s));
}
