// The decision step of the port's bounded engines, for Hopper (sm_90a): the
// per-boundary recall estimate of profile/bounded.py _decide_at_stage and,
// for the multi-row latency engine, the state update that follows it
// (profile/bounded.py _mr_update), in one launch. It replaces no
// pallas_call: the JAX package's decision step
// (auncel_tpu/profile/bounded_mr.py _decide_at_stage) is XLA ops, which the
// port first ran as about 300 small torch kernels per deciding wave, each
// one host dispatch.
//
// For each row b (a query) and stage s, with ind the stage's trace and k the
// query's top-k width:
//   - tval = vals[b, :k] (IP: acos(clamp(vals, -1, 1)));
//   - phi_m = the sum over the 15-boundary window dtb[b, 2^ind - 1 ...] of
//     0 where dtb >= tval_m, else acos(clamp(dtb / den)), den = tval_m or,
//     where |tval_m| <= 1e-30, 1e-30 (the guard an unfilled top-k takes);
//   - U_m = the trace at phi_m (Trace::search): the largest bin whose phi
//     is <= phi_m, counted over every bin as trace_lookup counts them (so a
//     NaN or a tie lands where it lands there), plus std_m * std; at or
//     above the last bin, its value scaled by phi / last_phi, or 1e9 on a
//     degenerate trace;
//   - p_m = (m + 1) * U_m <= k, first_ok = k * U_{k-1} <= float(k * 1.005);
//   - the replay of cur_num's binary search over p with exactly
//     _simulate_cur_num's iteration count, and recall = pre_num * (1 / k).
// Rows under the exact mask also estimate at width k + 1 and keep the
// smaller. With the state update, a row then takes complete, stagnation by
// list gap and its recall = 1 override, pre_val and last_stage, sat (forced
// at stage >= nlist / 8), floor(stage * multipler) with the forced floor to
// nlist, my_np and decided_at, as _mr_update's torch.where chain does.
//
// Bit for bit the plain version as torch computes it on the card. Every
// product, quotient and sum rounds once, as torch's separate kernels round
// it (the __f*_rn intrinsics keep nvcc from contracting a * b + c into an
// FMA); a division by a Python number is a product with the float32
// reciprocal, as torch's CUDA division by a CPU scalar computes it; a
// comparison with a Python number compares with its float32; and phi_m sums
// its window in the order of torch's CUDA sum over a last dimension of W <=
// 15 (Reduce.cuh in torch 2.11: BW lanes, BW the largest power of two <=
// W, lane x adds elements x and x + BW, then a shuffle tree over the BW
// lanes with falling offsets). The card tests hold the kernel to the torch
// it runs beside, at every W.
//
// What bounds it: latency. A row's work is k candidates times a window of
// 15 arccos and a count over the trace's bins (a few hundred floats), and
// its result is a few ints, so one launch that the host never waits for is
// the whole design: one warp a row, four rows a block, a grid over B. The
// lanes stride over the k (and k + 1) candidates; each computes its
// candidate's phi, U and predicate bits, which a ballot gathers into 32-bit
// words in shared memory; lanes 0 and 1 replay cur_num at widths k and
// k + 1, and lane 0 applies the state update. The trace is read through
// the read-only path: at one stage every lane reads the same bin at once.
// No host synchronisation and no allocation: scalars (std_m, multipler, the
// trace's bin count) are read on the card.

#include <cuda_runtime.h>
#include <stdint.h>

// Mirrored field by field by kernels/decide.py (_Args). Outside the unnamed
// namespace: decide_run, which takes it, has C linkage.
struct Args {
  // the running top-k [B, >= max_topk] and the boundary distances [B, nb]
  const float* vals;
  long long vals_ld;
  const float* dtb;
  long long dtb_ld;
  // the stage's trace row: phi, u, std [max_bins], and its bin count
  const float* phi;
  const float* u;
  const float* sd;
  const int* n_bins;
  const float* std_m;
  // [B] bool, or null: the rows that also estimate at width k + 1
  const unsigned char* exact;
  float* recall;            // [B] out
  // the state update (null frontier: the estimate alone)
  const int* frontier;      // [B]
  const int* stage_rows;    // [B], stride rows_ld: offsets[:, min(s, S) - 1]
  const float* require_acc;
  const int* stops;
  const float* multipler;   // 0-d
  const int* my_np_in;
  const int* decided_in;
  const int* stoped_in;
  const float* pre_in;
  const int* last_in;
  int* my_np;               // [B] out, and the next four
  int* decided;
  int* stoped;
  float* pre_val;
  int* last_stage;
  long long rows_ld;
  long long B;
  int win_start;            // 2^ind - 1
  int win_len;              // boundaries in the window (15 unless dtb ends)
  int max_bins;
  int k;
  int k1;                   // k + 1 under the exact mask, else 0
  int iters_k;              // _simulate_cur_num's iteration counts
  int iters_k1;
  int n_words;              // predicate words a width: ceil(max(k, k1) / 32)
  int is_ip;
  int stage;
  int nlist;
  int forced;               // stage >= nlist / 8
  int worst_col;            // max_topk - 1
  float inv_k;              // float32(1) / float32(k), and at k + 1
  float inv_k1;
  float slack_k;            // float32(k * FULL_OK_SLACK), and at k + 1
  float slack_k1;
};

namespace {

constexpr int kWarps = 4;                 // rows a block
constexpr int kThreads = kWarps * 32;
constexpr int kWindow = 15;               // ANGLE_WINDOW
constexpr float kEmptyU = 1e9f;           // EMPTY_TRACE_U
constexpr float kTiny = 1e-30f;           // sum_angle's guard of kdis
constexpr unsigned kFull = 0xffffffffu;

// torch.clamp(x, -1, 1): NaN stays NaN.
__device__ __forceinline__ float clamp_unit(float x) {
  return isnan(x) ? x : fminf(fmaxf(x, -1.f), 1.f);
}

// torch's sum over W <= 15 elements, lane by lane: BW, the largest power
// of two <= W, lanes; lane x holds c[x] + c[x + BW] where x + BW < W, else
// c[x] (each its accumulator's 0 + c, which changes no value but -0, and no
// contribution is -0); then the shuffle tree, offsets BW/2, ..., 1, lane x
// adding lane x + offset. Lane 0's value is the sum.
template <int BW>
__device__ __forceinline__ float reduce_w(const float (&c)[16], int W) {
  float s[8];
#pragma unroll
  for (int x = 0; x < 8; ++x)
    s[x] = x < BW ? (x + BW < W ? __fadd_rn(c[x], c[x + BW]) : c[x]) : 0.f;
#pragma unroll
  for (int off = BW / 2; off > 0; off >>= 1)
#pragma unroll
    for (int x = 0; x < off; ++x) s[x] = __fadd_rn(s[x], s[x + off]);
  return s[0];
}

// phi of one candidate: sum_angle over the window w[0 .. W - 1].
__device__ __forceinline__ float angle_sum(const float (&w)[16], int W,
                                           float kd) {
  const float den = fabsf(kd) > kTiny ? kd : kTiny;
  float c[16];
#pragma unroll
  for (int j = 0; j < 16; ++j)
    c[j] = (j >= W || w[j] >= kd) ? 0.f
                                  : acosf(clamp_unit(__fdiv_rn(w[j], den)));
  if (W >= 8) return reduce_w<8>(c, W);
  if (W >= 4) return reduce_w<4>(c, W);
  if (W >= 2) return reduce_w<2>(c, W);
  return c[0];  // one boundary, or none (an empty sum is 0)
}

// trace_lookup at one phi.
__device__ __forceinline__ float lookup(const Args& a, float ph, float sm,
                                        int last, float last_phi,
                                        float last_u) {
  int c0 = 0, c1 = 0, c2 = 0, c3 = 0;
  int j = 0;
  for (; j + 4 <= a.max_bins; j += 4) {
    c0 += __ldg(a.phi + j) <= ph;
    c1 += __ldg(a.phi + j + 1) <= ph;
    c2 += __ldg(a.phi + j + 2) <= ph;
    c3 += __ldg(a.phi + j + 3) <= ph;
  }
  for (; j < a.max_bins; ++j) c0 += __ldg(a.phi + j) <= ph;
  const int idx = min(max(c0 + c1 + c2 + c3 - 1, 0), last);
  if (ph >= last_phi) {
    const float scaled = __fmul_rn(
        last_u, __fdiv_rn(ph, last_phi != 0.f ? last_phi : 1.f));
    return last_phi > 0.f ? scaled : kEmptyU;
  }
  return __fadd_rn(__ldg(a.u + idx), __fmul_rn(sm, __ldg(a.sd + idx)));
}

// _simulate_cur_num on the predicate words of one width.
__device__ int cur_num(const unsigned* words, bool first_ok, int k,
                       int iters) {
  int low = 0, high = k - 1, result = first_ok ? k : 0;
  bool done = first_ok;
  for (int it = 0; it < iters; ++it) {
    const bool active = !done && low <= high;
    const int middle = (low + high) >> 1;  // floor division
    const bool ret0 = active && middle <= 0;
    if (ret0) result = 0;
    done = done || ret0;
    const int mc = min(max(middle, 0), k - 1);
    const bool pm = (words[mc >> 5] >> (mc & 31)) & 1u;
    const bool go = active && !ret0;
    if (go && pm) low = middle + 1;
    if (go && !pm) high = middle - 1;
  }
  return done ? result : low + 1;
}

// torch.minimum: NaN if either is.
__device__ __forceinline__ float min_nan(float x, float y) {
  return isnan(x) ? x : (isnan(y) ? y : fminf(x, y));
}

template <bool kUpdate>
__global__ void __launch_bounds__(kThreads) decide_kernel(const Args a) {
  extern __shared__ unsigned words[];  // [kWarps][2][n_words]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + warp;
  if (row >= a.B) return;  // the whole warp
  unsigned* wk = words + warp * 2 * a.n_words;
  unsigned* wk1 = wk + a.n_words;
  const bool exact = a.k1 > 0 && a.exact != nullptr && a.exact[row];
  const int n_cand = exact ? a.k1 : a.k;

  float w[16];
  const float* drow = a.dtb + row * a.dtb_ld + a.win_start;
#pragma unroll
  for (int j = 0; j < 16; ++j) w[j] = j < a.win_len ? __ldg(drow + j) : 0.f;
  const float sm = __ldg(a.std_m);
  const int last = min(max(__ldg(a.n_bins) - 1, 0), a.max_bins - 1);
  const float last_phi = __ldg(a.phi + last);
  const float last_u =
      __fadd_rn(__ldg(a.u + last), __fmul_rn(sm, __ldg(a.sd + last)));
  const float kf = (float)a.k;
  const float k1f = (float)a.k1;
  const float* vrow = a.vals + row * a.vals_ld;

  bool fok = false, fok1 = false;
  for (int base = 0; base < n_cand; base += 32) {
    const int m = base + lane;
    bool pk = false, pk1 = false;
    if (m < n_cand) {
      float kd = vrow[m];
      if (a.is_ip) kd = acosf(clamp_unit(kd));
      const float U =
          lookup(a, angle_sum(w, a.win_len, kd), sm, last, last_phi, last_u);
      const float mu = __fmul_rn((float)(m + 1), U);
      pk = m < a.k && mu <= kf;
      pk1 = exact && mu <= k1f;
      if (m == a.k - 1) fok = __fmul_rn(kf, U) <= a.slack_k;
      if (exact && m == a.k) fok1 = __fmul_rn(k1f, U) <= a.slack_k1;
    }
    const unsigned b0 = __ballot_sync(kFull, pk);
    const unsigned b1 = __ballot_sync(kFull, pk1);
    if (lane == 0) {
      wk[base >> 5] = b0;
      wk1[base >> 5] = b1;
    }
  }
  fok = __any_sync(kFull, fok);
  fok1 = __any_sync(kFull, fok1);
  __syncwarp();
  float r = 0.f;
  if (lane == 0)
    r = __fmul_rn((float)cur_num(wk, fok, a.k, a.iters_k), a.inv_k);
  else if (lane == 1 && exact)
    r = __fmul_rn((float)cur_num(wk1, fok1, a.k1, a.iters_k1), a.inv_k1);
  const float r2 = __shfl_sync(kFull, r, 1);
  if (lane != 0) return;
  float recall = exact ? min_nan(r, r2) : r;
  if (!kUpdate) {
    a.recall[row] = recall;
    return;
  }

  // _mr_update's chain: stagnation advances by the list gap since the last
  // complete boundary
  const bool complete = a.frontier[row] >= a.stage_rows[row * a.rows_ld];
  const float max_val = vrow[a.worst_col];
  const int last_st = a.last_in[row];
  const bool seen = last_st > 0;
  const bool cmp_ok = complete && seen;
  const float pv = a.pre_in[row];
  int st = a.stoped_in[row];
  st = (cmp_ok && max_val == pv) ? st + (a.stage - last_st)
                                 : (cmp_ok ? 0 : st);
  if (st >= a.stops[row] && seen) recall = 1.f;
  const int mnp = a.my_np_in[row];
  bool sat = complete && recall >= a.require_acc[row] && mnp == 0;
  if (a.forced) sat = sat || (complete && mnp == 0);
  int new_np =
      __float2int_rz(floorf(__fmul_rn((float)a.stage, __ldg(a.multipler))));
  if (a.forced) new_np = new_np > 0 ? new_np : a.nlist;
  const bool eff = sat && new_np > 0;
  a.recall[row] = recall;
  a.stoped[row] = st;
  a.pre_val[row] = complete ? max_val : pv;
  a.last_stage[row] = complete ? a.stage : last_st;
  a.my_np[row] = eff ? new_np : mnp;
  a.decided[row] = eff ? a.stage : a.decided_in[row];
}

}  // namespace

// Enqueues the decision step of a->B rows on `stream` (a cudaStream_t) of
// device `device`; with a->frontier set, the state update too. The
// wrapper (kernels/decide.py) checks shapes, types and devices. Returns the
// launch's CUDA error: 0 on success. Does not synchronise.
extern "C" int decide_run(const Args* a, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (a->B <= 0) return 0;
  if (a->k < 1 || a->k1 < 0 || a->max_bins < 1 || a->win_len < 0 ||
      a->win_len > kWindow || a->n_words < 1 ||
      (a->B + kWarps - 1) / kWarps >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(unsigned) * kWarps * 2 * (size_t)a->n_words;
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((a->B + kWarps - 1) / kWarps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->frontier != nullptr)
    decide_kernel<true><<<grid, kThreads, smem, s>>>(*a);
  else
    decide_kernel<false><<<grid, kThreads, smem, s>>>(*a);
  return (int)cudaGetLastError();
}
