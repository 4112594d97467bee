// Worklist row-scan for Hopper (sm_90a):
//
//     dots[t, c] = <db[work_rows[t], c, :], qs[t, :]>
//
// for every worklist entry t (one (query, row) pair) and every slot c of the
// row. Replaces the Pallas TPU kernel
// auncel_tpu/pallas_kernels/rowscan.py::rowscan_dots with the same contract,
// minus its T % 16 requirement: any T >= 0 is valid. The caller assembles
// L2 scores as q_sq + db_sq - 2 * dots from the STORED db_sq.
//
// What bounds it: device-memory bandwidth. Each entry reads one whole
// [row_cap, d] f32 row block (T * row_cap * d * 4 bytes in all) and does one
// FMA per 4 bytes read, far below the card's operations-per-byte balance.
// The design therefore only tries to keep enough loads in flight:
//   * one block per (entry, tile of kSlotsPerBlock row slots); the entry's
//     query row is staged once in shared memory;
//   * each warp owns kSlotsPerWarp slots of the tile and reads each slot's d
//     floats as coalesced 16-byte loads (float4, lane i reads elements
//     4i..4i+3, then 4(i+32)..), with all kSlotsPerWarp loads in flight
//     before any of them is reduced; scalar loads when d % 4 != 0 or a base
//     pointer is not 16-byte aligned;
//   * fp32 FMA accumulation and a warp-shuffle reduction.
// No tensor cores, TMA or fusion: gathering rows with TMA, fusing the score
// assembly, masks and top-k, and SQ8 decode are later work.
//
// Out-of-range row ids are clamped to [0, n_rows), as XLA clamps a gather.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
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

// Launches on `stream` (a cudaStream_t) of device `device`. Returns
// cudaGetLastError() after the launch: 0 on success. Does not synchronise.
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
