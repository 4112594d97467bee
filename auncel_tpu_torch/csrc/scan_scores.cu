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
// where its address allows, else 4-byte, else byte by byte.
//
// Product quantization (worklist.cuh's PQ codec): db holds M uint8 codes a
// slot and pq_books the [M, 256, d / M] codebook. The XLA scan decodes a
// gathered block by a codebook gather and contracts it
// (auncel_tpu/ops/pq.py:5-11, index/scan.py:226-247); here every block
// copies the codebook (1 KB a dimension: 96 KB at d 96) into shared memory
// once, before its first item, and the dot units gather each element from
// it. With centroids (residual PQ, the codes approximate x - c_l) the
// block stages the residual query q_b - c_l instead of q_b, one fp32
// subtraction an element, and sums ||q_b - c_l||^2 while it does, which
// takes q_sq's place in the L2 score; for IP it stages q_b and <c_l, q_b>,
// which is added to the dot. A PQ call always takes the worklist (no
// direct mode), so a persistent grid loads the codebook once a block
// rather than once a span. On PQ codes this simple design is bound by the
// decode, not by device memory: d shared-memory gathers a slot (four
// scalar gathers a float4 when dsub % 4 != 0), with no reuse across
// queries when a list has one query; on an H100 it reads PQ16 codes at
// about 2 % of the byte bound (PERF.md). Per-(query, list) ADC tables are
// the next design.
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

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

#include "worklist.cuh"

namespace {

constexpr int kTilesPerItem = 8;
constexpr int kNormStages = 3;        // norms and ids live one step longer

// Bytes of a block's PQ codebook of dimension d (256 codewords a subspace).
__host__ __device__ inline size_t pq_book_bytes(int d) {
  return (size_t)256 * d * sizeof(float);
}

Config scan_config(int nlist, int cap, int d, int slot_bytes,
                   long long n_work, bool pq = false) {
  Config c = make_config(nlist, cap, d, slot_bytes, n_work, kTilesPerItem,
                         !pq);
  // (PQ: the codebook,) ring, queries, dots, norms and ids of the ring,
  // q_sq and rows
  c.smem = (pq ? pq_book_bytes(d) : 0) + (size_t)kStages * c.stage_bytes +
           4 * ((size_t)c.chunk * d + (size_t)c.chunk * c.tile +
                2 * kNormStages * c.tile + 2 * c.chunk);
  return c;
}

struct Smem {
  float* books;         // PQ: [M][256][dsub] (else empty)
  unsigned char* ring;  // [kStages][stage_bytes]: tile stored slots each
  float* qs;      // [chunk][d]
  float* dots;    // [chunk][tile]
  float* sq;      // [kNormStages][tile]
  int* vid;       // [kNormStages][tile]
  float* qsq;     // [chunk]
  int* rows;      // [chunk]
};

__device__ __forceinline__ Smem carve(const Params& p, unsigned char* base,
                                      size_t book_bytes) {
  Smem s;
  s.books = reinterpret_cast<float*>(base);
  s.ring = base + book_bytes;
  s.qs = reinterpret_cast<float*>(s.ring + kStages * p.stage_bytes);
  s.dots = s.qs + p.chunk * p.d;
  s.sq = s.dots + p.chunk * p.tile;
  s.vid = reinterpret_cast<int*>(s.sq + kNormStages * p.tile);
  s.qsq = reinterpret_cast<float*>(s.vid + kNormStages * p.tile);
  s.rows = reinterpret_cast<int*>(s.qsq + p.chunk);
  return s;
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
  if (threadIdx.x < n_live) {
    const int j = (t % kNormStages) * p.tile + threadIdx.x;
    cp_async4(s.sq + j, p.db_sq + list_off + c0 + threadIdx.x);
    cp_async4(s.vid + j, p.vec_ids + list_off + c0 + threadIdx.x);
  }
}

// The block's copy of the PQ codebook (n floats), then a barrier.
__device__ __forceinline__ void load_books(const float* src, float* dst,
                                           int n) {
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0 && n % 4 == 0) {
    for (int i = threadIdx.x; i < n / 4; i += kThreads)
      reinterpret_cast<float4*>(dst)[i] =
          __ldg(reinterpret_cast<const float4*>(src) + i);
  } else {
    for (int i = threadIdx.x; i < n; i += kThreads) dst[i] = __ldg(src + i);
  }
  __syncthreads();
}

// Residual PQ: the staged query k of the item on list l is q_b - c_l with
// its squared norm in qsq[k] (L2), or q_b with <c_l, q_b> in qsq[k] (IP).
// One warp a query: the lanes take strided elements and a butterfly adds
// their partial sums.
__device__ __forceinline__ void stage_residual(const Params& p, const Smem& s,
                                               int l, int nq) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int d = p.d;
  const float* cl = p.centroids + (long long)l * d;
  for (int k = warp; k < nq; k += kWarps) {
    const float* src = p.q + (long long)(s.rows[k] / p.n_slots) * d;
    float* dst = s.qs + k * d;
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

// Scores and ids of list l's live slots [c_begin, c_end) for nq entries
// (ents: b * n_slots + s), each slot read from device memory once. kRes:
// residual PQ codes (stage_residual); `book` is the PQ codec's codebook.
template <typename Codec, bool kVec4, bool kRes>
__device__ void scan_item(const Params& p, const Smem& s, const PQBook& book,
                          int l, int c_begin, int c_end, int nq,
                          const int* ents) {
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
  if constexpr (kRes) {
    // plain stores, visible after the barrier that opens tile 0
    stage_residual(p, s, l, nq);
  } else {
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
                            nq, book);
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
          // version does; 2 * dot is exact, so no contraction can change it.
          // Residual PQ: q_sq holds ||q - c_l||^2 (L2) or <c_l, q> (IP)
          score = p.is_l2
                      ? fmaxf(__fsub_rn(__fadd_rn(q_sq, sq[c]), 2.0f * dot),
                              0.0f)
                      : (kRes ? __fadd_rn(q_sq, dot) : dot);
        }
        p.scores[base + c] = score;
        p.ids[base + c] = id >= 0 ? id : -1;
      }
    }
  }
  __syncthreads();  // the next item reuses the buffers
}

template <typename Codec, bool kVec4, bool kRes>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
scan_lists_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool kPQ = IsPQ<Codec>::value;
  const Smem s = carve(p, smem, kPQ ? pq_book_bytes(p.d) : 0);
  PQBook book{nullptr, 1};
  if constexpr (kPQ) {
    load_books(p.pq_books, s.books, 256 * p.d);
    book = PQBook{s.books, p.d / p.slot_bytes};
  }
  run_units(p, [&](int l, int c_begin, int c_end, int nq, const int* ents) {
    scan_item<Codec, kVec4, kRes>(p, s, book, l, c_begin, c_end, nq, ents);
  });
}

template <typename Codec, bool kVec4, bool kRes = false>
cudaError_t launch(const Params& p, const Config& c, int* scratch, int device,
                   cudaStream_t stream) {
  static int done_smem[64], occupancy[64];
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  int per_sm = 0;
  const cudaError_t err =
      prepare((const void*)scan_lists_kernel<Codec, kVec4, kRes>, c.smem,
              done_smem[device], occupancy[device], &per_sm);
  if (err != cudaSuccess) return err;
  return launch_units(scan_lists_kernel<Codec, kVec4, kRes>, per_sm, p, c,
                      scratch, device, stream);
}

template <typename Codec>
cudaError_t launch_codec(const Params& p, const Config& c, bool vec4,
                         int* scratch, int device, cudaStream_t stream) {
  return vec4 ? launch<Codec, true>(p, c, scratch, device, stream)
              : launch<Codec, false>(p, c, scratch, device, stream);
}

}  // namespace

// Ints of device scratch that scan_scores_launch needs for these shapes and
// codec (0: none, the direct mode), or -1 when the codec does not pack d or
// the shared memory or worklist would not fit.
extern "C" long long scan_scores_scratch_ints(int nlist, int cap, int d,
                                              long long n_work, int codec) {
  const int w = codec_slot_bytes(codec, d);
  if (w <= 0) return -1;
  return checked_scratch_ints(scan_config(nlist, cap, d, w, n_work), nlist,
                              n_work);
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
// (codes of m bytes a slot, d % m == 0; never 0: a PQ call always takes the
// worklist), or -1 when m does not divide d or the shared memory (with the
// codebook) or the worklist would not fit.
extern "C" long long scan_scores_pq_scratch_ints(int nlist, int cap, int d,
                                                 int m, long long n_work) {
  if (m <= 0 || d % m != 0) return -1;
  return checked_scratch_ints(scan_config(nlist, cap, d, m, n_work, true),
                              nlist, n_work);
}

// Enqueues the scan of PQ codes (m bytes a slot) on `stream` of device
// `device`: books [m, 256, d / m] f32; centroids [nlist, d] f32 for
// residual codes, else null. The rest as scan_scores_launch. Returns the
// first CUDA error of the enqueued launches: 0 on success. Does not
// synchronise.
extern "C" int scan_scores_pq_launch(const void* db, const float* db_sq,
                                     const int* vec_ids,
                                     const int* list_sizes, const float* q,
                                     const float* q_sq, const int* lists,
                                     float* scores, int* ids, int* scratch,
                                     const float* books,
                                     const float* centroids,
                                     long long n_work, int n_slots, int nlist,
                                     int cap, int d, int m, int is_l2,
                                     int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_work <= 0 || cap <= 0) return 0;
  if (books == nullptr || scratch == nullptr ||
      scan_scores_pq_scratch_ints(nlist, cap, d, m, n_work) < 0)
    return (int)cudaErrorInvalidValue;
  const Config c = scan_config(nlist, cap, d, m, n_work, true);
  Params p = make_params(db, nullptr, nullptr, db_sq, vec_ids, list_sizes, q,
                         q_sq, lists, scores, ids, n_work, n_slots, nlist,
                         cap, d, is_l2, c);
  p.pq_books = books;
  p.centroids = centroids;
  const bool vec4 = vec4_dots(nullptr, q, nullptr, nullptr, d);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (centroids != nullptr)
    return (int)(vec4 ? launch<PQ, true, true>(p, c, scratch, device, s)
                      : launch<PQ, false, true>(p, c, scratch, device, s));
  return (int)(vec4 ? launch<PQ, true, false>(p, c, scratch, device, s)
                    : launch<PQ, false, false>(p, c, scratch, device, s));
}
