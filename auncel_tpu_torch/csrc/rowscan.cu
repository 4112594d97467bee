// K1, the row scan of the multi-row layout, for Hopper (sm_90a). Two
// kernels replace the Pallas TPU kernel
// auncel_tpu/pallas_kernels/rowscan.py::rowscan_dots:
//
// rowscan_scores, the main path's: for every query b, row slot s and slot c
// of row r = rows[b, s],
//
//     scores[b, s * row_cap + c] = max((q_sq[b] + db_sq[r, c]) - 2 * dot, 0)
//                                  (L2), or dot (IP)
//     ids[b, s * row_cap + c]    = vec_ids[r, c]
//
// with dot = <db[r, c, :], q[b, :]>. A slot is dead, with the metric's worst
// value and id -1, when r < 0 (an inactive entry: a row slot past the
// query's limit), c >= row_sizes[r] or vec_ids[r, c] < 0; row ids >= n_rows
// clamp. This is K2's contract (csrc/scan_scores.cu) with rows for lists:
// the TPU kernel's dots fused with the score assembly and masks that its
// caller ran as separate passes (auncel_tpu/index/scan.py:249-268).
//
// Storage codecs (worklist.cuh): db holds float32 or bfloat16 vectors, or
// uint8 SQ8/SQ4/SQ6 codes with sq_scale and sq_bias, decoded in registers
// (the XLA route decodes a gathered block before the TPU kernel,
// auncel_tpu/index/scan.py:226). SQ codes at the widths sq_scan.cuh takes
// (d % 16 == 0; SQ4 d % 32 == 0; aligned bases) go to that scan, shared
// with K2: 256-slot stages (a row of the 10M cell is one), a producer warp
// that runs ahead across items, a slot a thread for small chunks. What
// follows is the kernel of float32 and bfloat16 rows and of the other SQ
// widths: a tile goes by one TMA bulk copy when a slot is a multiple of 16
// bytes and the bases are aligned (float32 at d % 4 == 0); otherwise the
// block copies it (cp.async of 16 or 4 bytes as its address allows, else
// byte by byte) and arrives on the same mbarriers.
//
// What bounds it: device-memory bandwidth. The least traffic is each
// distinct live row's live slots read once (the stored bytes, plus norm and
// id) and 8 bytes (score and id) written for every output slot. The TPU
// kernel's schedule, one program per (query, row) entry, reads a row once
// for every query that probes it, and
// the TPU route computes masked entries too. So this design is row-grouped
// and limit-aware:
//   * inactive entries read nothing; fill units write their worst values
//     and -1, and those of the slots past row_sizes;
//   * the live entries are grouped by row on the device (worklist.cuh: a
//     histogram, a two-pass scan and a scatter into a CSR, no host sync),
//     and an item is (row, chunk of up to 32 of its entries). A persistent
//     grid takes the items from an atomic counter; the chunks of one row
//     are neighbours, so a row leaves device memory once and its other
//     chunks find it in L2. Up to one chunk of entries skips the worklist
//     (direct mode: each block groups the entries itself and takes two
//     tiles of one row), so batch 1 costs a single launch;
//   * the Tensor Memory Accelerator loads the rows: one elected thread
//     copies each 64-slot tile of the item's live slots (32 KB at d = 128,
//     contiguous) with one cp.async.bulk into a two-stage shared-memory ring,
//     completing on the stage's mbarrier; a stage is refilled as soon as its
//     dots are taken, so two tiles' copies run under one tile's epilogue and
//     the next tile's dots. Slots past row_sizes are never copied. When d %
//     4 != 0 or a base is not 16-byte aligned, 4-byte cp.async copies fill
//     the same ring and arrive on the same mbarriers;
//   * the queries are staged with plain loads, and each lane reads its two
//     slots' norms and ids into registers while the tile lands;
//   * fp32 FMA, no tensor cores, in K2's dot units (worklist.cuh), so a
//     slot's dot is rounded exactly as K2 rounds it; each (b, s) row
//     segment of a tile is written as one coalesced run of scores and ids.
//
// rowscan_dots, the first, query-major port, off the main path: the TPU
// kernel's own contract, dots[t, c] = <db[work_rows[t], c, :], qs[t, :]>
// over a flat worklist (any T >= 0), row ids clamped. One block per
// (entry, tile of 64 slots): each warp owns 8 slots of the tile and reads
// each slot's d floats as coalesced 16-byte loads with all 8 loads in
// flight before any is reduced (scalar loads when d % 4 != 0 or a base is
// not 16-byte aligned), fp32 FMA and a warp-shuffle reduction. It reads a
// row for every entry.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

#include "sq_scan.cuh"

namespace {

// ---- rowscan_scores

// ring (TMA's destination, 128-byte aligned after the barriers), queries,
// dots, q_sq and entries
constexpr size_t kBarBytes = 128;

Config row_config(int n_rows, int row_cap, int d, int slot_bytes,
                  long long n_work) {
  // a row an item
  Config c = make_config(n_rows, row_cap, d, slot_bytes, n_work, 0);
  c.smem = kBarBytes + (size_t)kStages * c.stage_bytes +
           4 * ((size_t)c.chunk * d + (size_t)c.chunk * c.tile +
                2 * c.chunk);
  return c;
}

struct RowSmem {
  uint64_t* full;       // [kStages] mbarriers: the stage's copy has landed
  unsigned char* ring;  // [kStages][stage_bytes]: tile stored slots each
  float* qs;       // [chunk][d]
  float* dots;     // [chunk][tile]
  float* qsq;      // [chunk]
  int* rows;       // [chunk] entries b * n_slots + s
};

__device__ __forceinline__ RowSmem carve_rows(const Params& p,
                                              unsigned char* base) {
  RowSmem s;
  s.full = reinterpret_cast<uint64_t*>(base);
  s.ring = base + kBarBytes;
  s.qs = reinterpret_cast<float*>(s.ring + kStages * p.stage_bytes);
  s.dots = s.qs + p.chunk * p.d;
  s.qsq = s.dots + p.chunk * p.tile;
  s.rows = reinterpret_cast<int*>(s.qsq + p.chunk);
  return s;
}

// Scores and ids of row r's live slots [c_begin, c_end) for nq entries
// (ents: b * n_slots + s), each slot read from device memory once.
// `phases` holds the parity of each stage's next completion.
template <typename Codec, bool kVec4, bool kTma>
__device__ void scan_row(const Params& p, const RowSmem& s, int r,
                         int c_begin, int c_end, int nq, const int* ents,
                         unsigned& phases) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float worst = p.is_l2 ? CUDART_INF_F : -CUDART_INF_F;
  const long long row_off = (long long)r * p.cap;
  const int d = p.d;
  const int n_tiles = (c_end - c_begin + p.tile - 1) / p.tile;
  auto issue = [&](int t) {
    const int c0 = c_begin + t * p.tile;
    const int n = min(p.tile, c_end - c0);
    unsigned char* dst = s.ring + (t % kStages) * p.stage_bytes;
    const unsigned char* src = static_cast<const unsigned char*>(p.db) +
                               (row_off + c0) * p.slot_bytes;
    uint64_t* bar = s.full + t % kStages;
    if (kTma) {
      if (threadIdx.x == 0)
        tma_load(dst, src, (unsigned)(n * p.slot_bytes), bar);
    } else {
      if constexpr (std::is_same<Codec, F32>::value) {
        float* fdst = reinterpret_cast<float*>(dst);
        const float* fsrc = reinterpret_cast<const float*>(src);
        for (int i = threadIdx.x; i < n * d; i += kThreads)
          cp_async4(fdst + i, fsrc + i);
      } else {
        copy_bytes(dst, src, n * p.slot_bytes);
      }
      asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                       "r"(smem_addr(bar))
                   : "memory");
    }
  };
  // Two tiles in flight: tile t + 2's copy starts as soon as tile t's dots
  // are taken, under tile t's epilogue and tile t + 1's dots.
  issue(0);
  if (n_tiles > 1) issue(1);
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
        reinterpret_cast<float4*>(dst)[i] =
            __ldg(reinterpret_cast<const float4*>(src) + i);
    } else {
      for (int i = lane; i < d; i += 32) dst[i] = __ldg(src + i);
    }
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int c0 = c_begin + t * p.tile;
    const int n_live = min(p.tile, c_end - c0);
    // the norms and ids of this lane's slots (lane and lane + 32; a tile
    // has at most 64), read while the tile lands
    float sq[2];
    int vid[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = lane + 32 * j;
      const bool ok = c < n_live;
      sq[j] = ok ? __ldg(p.db_sq + row_off + c0 + c) : 0.f;
      vid[j] = ok ? __ldg(p.vec_ids + row_off + c0 + c) : -1;
    }
    const int st = t % kStages;
    mbar_wait(s.full + st, (phases >> st) & 1u);
    phases ^= 1u << st;
    __syncthreads();  // the staged queries; the last tile's epilogue is done

    tile_dots<Codec, kVec4>(p, s.qs, s.dots, s.ring + st * p.stage_bytes,
                            n_live, nq);
    __syncthreads();
    if (t + 2 < n_tiles) issue(t + 2);

    // epilogue: one coalesced run of the tile per (b, s) row
    for (int k = warp; k < nq; k += kWarps) {
      const long long base = (long long)s.rows[k] * p.cap + c0;
      const float q_sq = s.qsq[k];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = lane + 32 * j;
        if (c >= n_live) continue;
        const int id = vid[j];
        float score = worst;
        if (id >= 0) {
          const float dot = s.dots[k * p.tile + c];
          // (q_sq + db_sq) - 2 * dot, rounded step by step as the plain
          // version does; 2 * dot is exact, so no contraction can change it
          score = p.is_l2
                      ? fmaxf(__fsub_rn(__fadd_rn(q_sq, sq[j]), 2.0f * dot),
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

template <typename Codec, bool kVec4, bool kTma>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
rowscan_scores_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const RowSmem s = carve_rows(p, smem_raw);
  if (threadIdx.x == 0) {
    // TMA: the elected thread's arrive; cp.async: every thread's
    for (int i = 0; i < kStages; ++i)
      mbar_init(s.full + i, kTma ? 1 : kThreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  unsigned phases = 0;
  run_units(p, [&](int r, int c_begin, int c_end, int nq, const int* ents) {
    scan_row<Codec, kVec4, kTma>(p, s, r, c_begin, c_end, nq, ents, phases);
  });
}

template <typename Codec, bool kVec4, bool kTma>
cudaError_t launch_rows(const Params& p, const Config& c, int* scratch,
                        int device, cudaStream_t stream) {
  static int done_smem[64], occupancy[64];
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  int per_sm = 0;
  const cudaError_t err =
      prepare((const void*)rowscan_scores_kernel<Codec, kVec4, kTma>, c.smem,
              done_smem[device], occupancy[device], &per_sm);
  if (err != cudaSuccess) return err;
  return launch_units(rowscan_scores_kernel<Codec, kVec4, kTma>, per_sm, p,
                      c, scratch, device, stream);
}

// TMA needs 16-byte sizes and addresses: slots of a multiple of 16 bytes
// on aligned bases (a float32 row at d % 4 == 0 always). Float32 takes the
// float4 dots exactly when it takes TMA, so it has two variants.
template <typename Codec>
cudaError_t launch_codec(const Params& p, const Config& c, bool vec4,
                         int* scratch, int device, cudaStream_t stream) {
  const bool tma = vec4 && p.slot_bytes % 16 == 0;
  if (tma) return launch_rows<Codec, true, true>(p, c, scratch, device,
                                                 stream);
  if constexpr (!std::is_same<Codec, F32>::value) {
    if (vec4)
      return launch_rows<Codec, true, false>(p, c, scratch, device, stream);
  }
  return launch_rows<Codec, false, false>(p, c, scratch, device, stream);
}

// ---- rowscan_dots

constexpr int kSlotsPerWarp = 8;
constexpr int kSlotsPerBlock = kWarps * kSlotsPerWarp;

template <bool kVec4>
__global__ void __launch_bounds__(kWarps * 32)
rowscan_dots_kernel(const float* __restrict__ db,
                    const int* __restrict__ work_rows,
                    const float* __restrict__ qs,
                    float* __restrict__ out,
                    int n_rows, int row_cap, int d) {
  extern __shared__ __align__(16) float q_sh[];
  const long long t = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  const float* q = qs + t * d;
  for (int i = threadIdx.x; i < d; i += blockDim.x) q_sh[i] = q[i];
  __syncthreads();

  int row = work_rows[t];
  row = row < 0 ? 0 : (row >= n_rows ? n_rows - 1 : row);
  const float* base = db + (long long)row * row_cap * d;
  const int c0 = blockIdx.y * kSlotsPerBlock + warp;

  float acc[kSlotsPerWarp];
#pragma unroll
  for (int j = 0; j < kSlotsPerWarp; ++j) acc[j] = 0.f;

  if (kVec4) {
    const int d4 = d >> 2;
    const float4* q4 = reinterpret_cast<const float4*>(q_sh);
    for (int i = lane; i < d4; i += 32) {
      float4 a[kSlotsPerWarp];
#pragma unroll
      for (int j = 0; j < kSlotsPerWarp; ++j) {
        const int c = c0 + j * kWarps;
        const float4* x4 =
            reinterpret_cast<const float4*>(base + (long long)c * d);
        a[j] = c < row_cap ? __ldg(x4 + i) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      const float4 b = q4[i];
#pragma unroll
      for (int j = 0; j < kSlotsPerWarp; ++j) {
        acc[j] = fmaf(a[j].x, b.x, acc[j]);
        acc[j] = fmaf(a[j].y, b.y, acc[j]);
        acc[j] = fmaf(a[j].z, b.z, acc[j]);
        acc[j] = fmaf(a[j].w, b.w, acc[j]);
      }
    }
  } else {
    for (int i = lane; i < d; i += 32) {
      float a[kSlotsPerWarp];
#pragma unroll
      for (int j = 0; j < kSlotsPerWarp; ++j) {
        const int c = c0 + j * kWarps;
        a[j] = c < row_cap ? __ldg(base + (long long)c * d + i) : 0.f;
      }
      const float b = q_sh[i];
#pragma unroll
      for (int j = 0; j < kSlotsPerWarp; ++j) acc[j] = fmaf(a[j], b, acc[j]);
    }
  }

  float mine = 0.f;
#pragma unroll
  for (int j = 0; j < kSlotsPerWarp; ++j) {
    float v = acc[j];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == j) mine = v;
  }
  if (lane < kSlotsPerWarp) {
    const int c = c0 + lane * kWarps;
    if (c < row_cap) out[t * row_cap + c] = mine;
  }
}

}  // namespace

// Ints of device scratch that rowscan_scores_launch needs for these shapes
// and codec (0: none, the direct mode), or -1 when the codec does not pack
// d or the shared memory or worklist would not fit.
extern "C" long long rowscan_scores_scratch_ints(int n_rows, int row_cap,
                                                 int d, long long n_work,
                                                 int codec) {
  const int w = codec_slot_bytes(codec, d);
  if (w <= 0) return -1;
  const Config c = row_config(n_rows, row_cap, d, w, n_work);
  return with_sq_scratch(checked_scratch_ints(c, n_rows, n_work), codec, d,
                         n_rows, row_cap, n_work, 0);
}

// Enqueues the row scan on `stream` (a cudaStream_t) of device `device`:
// n_work = B * n_slots (query, row slot) entries; `scratch` holds
// rowscan_scores_scratch_ints(...) ints (may be null when that is 0); db
// holds slots of the codec (worklist.cuh's CodecId), sq_scale and sq_bias
// [d] the SQ codecs' range (else null). Returns the first CUDA error of the
// enqueued launches (cudaGetLastError()): 0 on success. Does not
// synchronise.
extern "C" int rowscan_scores_launch(const void* db, const float* db_sq,
                                     const int* vec_ids, const int* row_sizes,
                                     const float* q, const float* q_sq,
                                     const int* rows, float* scores, int* ids,
                                     int* scratch, const float* sq_scale,
                                     const float* sq_bias, long long n_work,
                                     int n_slots, int n_rows, int row_cap,
                                     int d, int is_l2, int codec, int device,
                                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_work <= 0 || row_cap <= 0) return 0;
  if (rowscan_scores_scratch_ints(n_rows, row_cap, d, n_work, codec) < 0)
    return (int)cudaErrorInvalidValue;
  if (codec >= kCodecSQ8 && (sq_scale == nullptr || sq_bias == nullptr))
    return (int)cudaErrorInvalidValue;
  const Config c =
      row_config(n_rows, row_cap, d, codec_slot_bytes(codec, d), n_work);
  if (!c.direct && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const Params p = make_params(db, sq_scale, sq_bias, db_sq, vec_ids,
                               row_sizes, q, q_sq, rows, scores, ids, n_work,
                               n_slots, n_rows, row_cap, d, is_l2, c);
  const bool vec4 = vec4_dots(db, q, sq_scale, sq_bias, d);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Config sc;
  if (sq_route(codec, d, vec4, n_rows, row_cap, n_work, 0, sc)) {
    const Params ps = make_params(db, sq_scale, sq_bias, db_sq, vec_ids,
                                  row_sizes, q, q_sq, rows, scores, ids,
                                  n_work, n_slots, n_rows, row_cap, d, is_l2,
                                  sc);
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

// Launches rowscan_dots on `stream` (a cudaStream_t) of device `device`.
// Returns cudaGetLastError() after the launch: 0 on success. Does not
// synchronise.
extern "C" int rowscan_dots_launch(const float* db, const int* work_rows,
                                   const float* qs, float* out,
                                   long long T, int n_rows, int row_cap,
                                   int d, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (T <= 0 || row_cap <= 0) return 0;
  const dim3 grid((unsigned)T, (unsigned)((row_cap + kSlotsPerBlock - 1) /
                                          kSlotsPerBlock));
  const size_t smem = (size_t)d * sizeof(float);
  const bool vec4 = (d % 4 == 0) && ((uintptr_t)db % 16 == 0) &&
                    ((uintptr_t)qs % 16 == 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec4) {
    rowscan_dots_kernel<true><<<grid, kWarps * 32, smem, s>>>(
        db, work_rows, qs, out, n_rows, row_cap, d);
  } else {
    rowscan_dots_kernel<false><<<grid, kWarps * 32, smem, s>>>(
        db, work_rows, qs, out, n_rows, row_cap, d);
  }
  return (int)cudaGetLastError();
}
