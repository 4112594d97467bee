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
// What bounds it: device-memory bandwidth. A live slot costs d * 4 bytes of
// db plus its norm and id and one FMA per 4 bytes; every slot, live or dead,
// costs 8 bytes of output (score and id). The design reads only what is
// live:
//   * one block per (query, probe slot, tile of kSlotsPerBlock list slots);
//     a tile of an inactive slot or past list_sizes writes its worst values
//     and exits without reading db, db_sq or vec_ids;
//   * otherwise the tile's ids and norms and the query row are staged in
//     shared memory, and each warp owns kSlotsPerWarp slots, reading each
//     live slot's d floats as coalesced 16-byte loads (float4; scalar loads
//     when d % 4 != 0 or a base pointer is not 16-byte aligned) with all of
//     the warp's loads in flight before any is reduced, as in rowscan.cu;
//   * fp32 FMA accumulation and a warp-shuffle reduction; the tile's
//     scores and ids are written as one coalesced row.
// No tensor cores, TMA or persistent grid: a query's probes that share a
// list still each read it, and the exact top-k stays outside. Those are
// later work.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kSlotsPerWarp = 8;
constexpr int kSlotsPerBlock = kWarps * kSlotsPerWarp;

template <bool kVec4>
__global__ void __launch_bounds__(kWarps * 32)
scan_scores_kernel(const float* __restrict__ db,
                   const float* __restrict__ db_sq,
                   const int* __restrict__ vec_ids,
                   const int* __restrict__ list_sizes,
                   const float* __restrict__ q,
                   const float* __restrict__ q_sq,
                   const int* __restrict__ lists,
                   float* __restrict__ scores,
                   int* __restrict__ ids,
                   int n_slots, int nlist, int cap, int d, int is_l2) {
  extern __shared__ __align__(16) float q_sh[];
  __shared__ int id_sh[kSlotsPerBlock];
  __shared__ float sq_sh[kSlotsPerBlock];
  __shared__ float dot_sh[kSlotsPerBlock];

  const long long bs = blockIdx.x;  // b * n_slots + s
  const long long b = bs / n_slots;
  const int c0 = blockIdx.y * kSlotsPerBlock;
  const float worst = is_l2 ? CUDART_INF_F : -CUDART_INF_F;
  float* score_row = scores + bs * cap;
  int* id_row = ids + bs * cap;

  int l = lists[bs];
  int size = 0;
  if (l >= 0) {
    l = l < nlist ? l : nlist - 1;
    size = min(list_sizes[l], cap);
  }
  if (c0 >= size) {  // uniform over the block: nothing live in the tile
    const int c = c0 + threadIdx.x;
    if (threadIdx.x < kSlotsPerBlock && c < cap) {
      score_row[c] = worst;
      id_row[c] = -1;
    }
    return;
  }

  const long long list_off = (long long)l * cap;
  const float* qb = q + b * d;
  for (int i = threadIdx.x; i < d; i += blockDim.x) q_sh[i] = qb[i];
  if (threadIdx.x < kSlotsPerBlock) {
    const int c = c0 + threadIdx.x;
    int id = -1;
    float sq = 0.f;
    if (c < size) {
      id = vec_ids[list_off + c];
      sq = db_sq[list_off + c];
    }
    id_sh[threadIdx.x] = id;
    sq_sh[threadIdx.x] = sq;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* base = db + list_off * d;
  // the warp's slots are warp + j * kWarps (tile-local), j < kSlotsPerWarp
  bool live[kSlotsPerWarp];
  bool any_live = false;
#pragma unroll
  for (int j = 0; j < kSlotsPerWarp; ++j) {
    live[j] = id_sh[warp + j * kWarps] >= 0;
    any_live |= live[j];
  }

  if (any_live) {  // uniform over the warp
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
          const long long c = c0 + warp + j * kWarps;
          const float4* x4 = reinterpret_cast<const float4*>(base + c * d);
          a[j] = live[j] ? __ldg(x4 + i) : make_float4(0.f, 0.f, 0.f, 0.f);
        }
        const float4 v = q4[i];
#pragma unroll
        for (int j = 0; j < kSlotsPerWarp; ++j) {
          acc[j] = fmaf(a[j].x, v.x, acc[j]);
          acc[j] = fmaf(a[j].y, v.y, acc[j]);
          acc[j] = fmaf(a[j].z, v.z, acc[j]);
          acc[j] = fmaf(a[j].w, v.w, acc[j]);
        }
      }
    } else {
      for (int i = lane; i < d; i += 32) {
        float a[kSlotsPerWarp];
#pragma unroll
        for (int j = 0; j < kSlotsPerWarp; ++j) {
          const long long c = c0 + warp + j * kWarps;
          a[j] = live[j] ? __ldg(base + c * d + i) : 0.f;
        }
        const float v = q_sh[i];
#pragma unroll
        for (int j = 0; j < kSlotsPerWarp; ++j) acc[j] = fmaf(a[j], v, acc[j]);
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
    if (lane < kSlotsPerWarp) dot_sh[warp + lane * kWarps] = mine;
  }
  __syncthreads();

  const int t = threadIdx.x;
  const int c = c0 + t;
  if (t < kSlotsPerBlock && c < cap) {
    const int id = id_sh[t];
    float s = worst;
    if (id >= 0) {
      const float dot = dot_sh[t];
      // (q_sq + db_sq) - 2 * dot, rounded step by step as the plain
      // version does; 2 * dot is exact, so no contraction can change it
      s = is_l2 ? fmaxf(__fsub_rn(__fadd_rn(q_sq[b], sq_sh[t]), 2.0f * dot),
                        0.0f)
                : dot;
    }
    score_row[c] = s;
    id_row[c] = id;
  }
}

}  // namespace

// Launches on `stream` (a cudaStream_t) of device `device`: n_work =
// B * n_slots (query, probe slot) pairs. Returns cudaGetLastError() after
// the launch: 0 on success. Does not synchronise.
extern "C" int scan_scores_launch(const float* db, const float* db_sq,
                                  const int* vec_ids, const int* list_sizes,
                                  const float* q, const float* q_sq,
                                  const int* lists, float* scores, int* ids,
                                  long long n_work, int n_slots, int nlist,
                                  int cap, int d, int is_l2, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_work <= 0 || cap <= 0) return 0;
  const dim3 grid((unsigned)n_work,
                  (unsigned)((cap + kSlotsPerBlock - 1) / kSlotsPerBlock));
  const size_t smem = (size_t)d * sizeof(float);
  const bool vec4 = (d % 4 == 0) && ((uintptr_t)db % 16 == 0) &&
                    ((uintptr_t)q % 16 == 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec4) {
    scan_scores_kernel<true><<<grid, kWarps * 32, smem, s>>>(
        db, db_sq, vec_ids, list_sizes, q, q_sq, lists, scores, ids, n_slots,
        nlist, cap, d, is_l2);
  } else {
    scan_scores_kernel<false><<<grid, kWarps * 32, smem, s>>>(
        db, db_sq, vec_ids, list_sizes, q, q_sq, lists, scores, ids, n_slots,
        nlist, cap, d, is_l2);
  }
  return (int)cudaGetLastError();
}
