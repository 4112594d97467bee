// The exact running top-k merge of the port's probe scan, for Hopper
// (sm_90a). It replaces auncel_tpu/ops/topk.py:67 merge_topk_verified,
// which is not a pallas_call: on the TPU it is XLA's approx_min_k candidate
// selector under an exactness certificate, with a full sort as its
// fallback, whose role is a selection that does not sort the window.
//
// For each row b of a batch, over the concatenation (never built)
//
//     positions 0 .. kr-1        the running result rv[b, :], ri[b, :]
//     positions kr .. kr+n-1     the chunk sv[b, :], si[b, :]
//
// the output is the k best values by (key, position), best-first, which is
// topk_scores over the concatenation (a stable sort: ties to the earlier
// position) bit for bit. The key of a value is an order-preserving uint32:
// -0.0 is taken as +0.0 (one key, so the earlier position wins), every NaN
// as larger than +inf (as torch.sort ranks it: last for L2, first for IP),
// and the key is inverted for IP, where larger is better. Each winner's
// value and id are read back from its position, and a winner whose value
// is the metric's worst (+inf for L2, -inf for IP) gets id -1; slots past
// kr + n (a row shorter than k) get the worst value and id -1.
//
// What bounds it: device-memory bytes. Each chunk value is read once (4
// bytes a slot), the running result once (8 bytes a slot), the ids of the
// k winners only, and k values and ids are written: B*n*4 + B*kr*8 + B*k*12
// bytes. The work per value is a key, a compare and, for the few that can
// still win, a radix digit count in shared memory.
//
// Design. Pass A: one block of 512 threads takes one (row, segment), a
// contiguous range of positions. It streams the range in steps of 2048
// (coalesced loads, four a thread) and appends to a shared-memory buffer,
// in position order (a block prefix over warp ballots), only the keys below
// the segment's current k-th key: a later key equal to it loses on
// position, so the filter is exact. When the buffer holds more than k
// keys and no threshold exists yet, or when the next step might not fit, a
// radix select (four 8-bit digits, histograms in shared memory with
// warp-aggregated atomics) finds the k-th key T, and an ordered block
// compaction keeps every key below T and then the first keys equal to T in
// position order: exactly k, still in position order. The ids are not read
// here. A row takes several segments when the batch alone would not fill
// the card (batch 1), else one. Pass B, only for rows of several segments:
// one block a row gathers the segments' candidates in segment order (so in
// position order again) and selects the same way. The block that finishes
// a row ranks its k winners by (key, position) in shared memory (k <= 128,
// one thread a winner), gathers each winner's value and id by position and
// writes them. One or two launches a call, on the caller's stream; no
// host synchronisation, no allocation (the wrapper passes the candidates'
// scratch).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 4;                      // positions a thread a step
constexpr int kStep = kThreads * kPer;       // positions a load step
constexpr int kMaxK = 128;
constexpr int kMaxSegments = 64;
constexpr int kCap = 8192 + kMaxK;           // candidate buffer, >= 64 * 128
constexpr int kBins = 256;
constexpr unsigned kFull = 0xffffffffu;

static_assert(kPer * kWarps == 64, "load_step scans two counts a lane");
static_assert(kMaxSegments * kMaxK <= kCap, "pass B's candidates fit");
static_assert(kCap < 65536, "select_k packs two counts in one int");

struct Smem {
  uint32_t key[kCap];
  uint32_t pos[kCap];
  uint32_t sel_key[kMaxK];
  uint32_t sel_pos[kMaxK];
  int hist[kBins];
  int wcnt[kPer * kWarps];
  int wtot[kWarps];
  int seg_off[kMaxSegments + 1];
  int added;
  int digit;
  int want;
};

struct Args {
  const float* rv;      // [B, kr] running values
  const int* ri;        // [B, kr] running ids
  const float* sv;      // [B, n] chunk values
  const int* si;        // [B, n] chunk ids
  float* out_v;         // [B, k]
  int* out_i;           // [B, k]
  uint32_t* cand_key;   // [B, segments, k] pass A's candidates (segments > 1)
  uint32_t* cand_pos;   // [B, segments, k]
  int* cand_cnt;        // [B, segments]
  long long kr;
  long long n;
  int k;
  int is_ip;
  int segments;
};

__device__ __forceinline__ uint32_t order_key(float v, int is_ip) {
  uint32_t u = __float_as_uint(v);
  if ((u & 0x7fffffffu) > 0x7f800000u) u = 0x7fc00000u;  // NaN: largest
  if (u == 0x80000000u) u = 0u;                           // -0.0 is +0.0
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return is_ip ? ~u : u;
}

__device__ __forceinline__ float value_at(const Args& a, long long b,
                                          long long p) {
  return p < a.kr ? a.rv[b * a.kr + p] : a.sv[b * a.n + (p - a.kr)];
}

__device__ __forceinline__ int id_at(const Args& a, long long b,
                                     long long p) {
  return p < a.kr ? a.ri[b * a.kr + p] : a.si[b * a.n + (p - a.kr)];
}

// Inclusive prefix sum over the warp's lanes.
__device__ __forceinline__ int warp_inclusive(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += t;
  }
  return v;
}

// Exclusive prefix of v over the block in thread order (every thread calls
// it; the caller synchronises before s.wtot is written again).
__device__ int block_exclusive(int v, Smem& s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int incl = warp_inclusive(v, lane);
  if (lane == 31) s.wtot[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < kWarps ? s.wtot[lane] : 0;
    const int wi = warp_inclusive(w, lane);
    if (lane < kWarps) s.wtot[lane] = wi - w;
  }
  __syncthreads();
  return incl - v + s.wtot[warp];
}

// Appends to the buffer at [m, ...) the positions [p0, p1) of row b whose
// key is below thr (every one while !have), in position order; returns how
// many (the same in every thread).
__device__ int load_step(const Args& a, long long b, long long p0,
                         long long p1, int m, bool have, uint32_t thr,
                         Smem& s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float v[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const long long p = p0 + j * kThreads + threadIdx.x;
    v[j] = p < p1 ? value_at(a, b, p) : 0.0f;
  }
  uint32_t key[kPer];
  unsigned ball[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const long long p = p0 + j * kThreads + threadIdx.x;
    key[j] = order_key(v[j], a.is_ip);
    const bool keep = p < p1 && (!have || key[j] < thr);
    ball[j] = __ballot_sync(kFull, keep);
    if (lane == 0) s.wcnt[j * kWarps + warp] = __popc(ball[j]);
  }
  __syncthreads();
  if (warp == 0) {
    // the 64 counts in position order (step j major, warp minor), two a
    // lane, replaced by their exclusive prefix
    const int c0 = s.wcnt[2 * lane], c1 = s.wcnt[2 * lane + 1];
    const int incl = warp_inclusive(c0 + c1, lane);
    s.wcnt[2 * lane] = incl - c0 - c1;
    s.wcnt[2 * lane + 1] = incl - c1;
    if (lane == 31) s.added = incl;
  }
  __syncthreads();
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if ((ball[j] >> lane) & 1u) {
      const int i =
          m + s.wcnt[j * kWarps + warp] + __popc(ball[j] & below);
      s.key[i] = key[j];
      s.pos[i] = (uint32_t)(p0 + j * kThreads + threadIdx.x);
    }
  }
  return s.added;
}

// The buffer [0, m), m > k, in position order, becomes its k smallest by
// (key, position), still in position order. Returns the k-th key.
__device__ uint32_t select_k(int m, int k, Smem& s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t prefix = 0, mask = 0;
  int want = k;  // rank of the k-th among the keys that match the prefix
#pragma unroll 1
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = threadIdx.x; i < kBins; i += kThreads) s.hist[i] = 0;
    __syncthreads();
    for (int base = warp * 32; base < m; base += kThreads) {
      const int i = base + lane;
      const uint32_t u = i < m ? s.key[i] : 0u;
      const bool in = i < m && (u & mask) == prefix;
      const unsigned d = in ? (u >> shift) & 0xffu : 0x100u;
      const unsigned peers = __match_any_sync(kFull, d);
      if (in && lane == __ffs(peers) - 1)
        atomicAdd(&s.hist[d], __popc(peers));
    }
    __syncthreads();
    if (warp == 0) {
      int c[8];
      int sum = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        c[j] = s.hist[lane * 8 + j];
        sum += c[j];
      }
      const int incl = warp_inclusive(sum, lane);
      const int excl = incl - sum;
      const unsigned hit =
          __ballot_sync(kFull, excl < want && want <= incl);
      if (lane == __ffs(hit) - 1) {
        int acc = excl;
        for (int j = 0; j < 8; ++j) {
          if (acc + c[j] >= want) {
            s.digit = lane * 8 + j;
            s.want = want - acc;
            break;
          }
          acc += c[j];
        }
      }
    }
    __syncthreads();
    prefix |= (uint32_t)s.digit << shift;
    mask |= 0xffu << shift;
    want = s.want;
  }
  // keep every key below T and the first `want` keys equal to T, in order
  const uint32_t T = prefix;
  const int per = (m + kThreads - 1) / kThreads;
  const int lo = min(m, (int)threadIdx.x * per), hi = min(m, lo + per);
  int nl = 0, ne = 0;
  for (int i = lo; i < hi; ++i) {
    const uint32_t u = s.key[i];
    nl += u < T;
    ne += u == T;
  }
  const int ex = block_exclusive((nl << 16) | ne, s);
  int L = ex >> 16, E = ex & 0xffff;
  for (int i = lo; i < hi; ++i) {
    const uint32_t u = s.key[i];
    int out = -1;
    if (u < T) {
      out = L + min(E, want);
      ++L;
    } else if (u == T) {
      if (E < want) out = L + E;
      ++E;
    }
    if (out >= 0) {
      s.sel_key[out] = u;
      s.sel_pos[out] = s.pos[i];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < k; i += kThreads) {
    s.key[i] = s.sel_key[i];
    s.pos[i] = s.sel_pos[i];
  }
  __syncthreads();
  return T;
}

// Writes row b's output from the buffer [0, m), m <= k, in position order:
// winner r goes to its rank by (key, position), which is its rank by key
// with ties to the earlier buffer slot.
__device__ void finish_row(const Args& a, long long b, int m, Smem& s) {
  const float worst =
      __int_as_float(a.is_ip ? (int)0xff800000u : 0x7f800000);
  for (int r = threadIdx.x; r < a.k; r += kThreads) {
    if (r < m) {
      const uint32_t u = s.key[r];
      int rank = 0;
      for (int j = 0; j < m; ++j) {
        const uint32_t w = s.key[j];
        rank += (w < u) || (w == u && j < r);
      }
      const long long p = s.pos[r];
      const float v = value_at(a, b, p);
      a.out_v[b * a.k + rank] = v;
      a.out_i[b * a.k + rank] = v == worst ? -1 : id_at(a, b, p);
    } else {
      a.out_v[b * a.k + r] = worst;
      a.out_i[b * a.k + r] = -1;
    }
  }
}

// Pass A: block (b, segment) selects the segment's best k; with one segment
// a row it writes the row's output, else its candidates.
__global__ void __launch_bounds__(kThreads) topk_merge_segment_kernel(
    Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  const long long b = blockIdx.x;
  const int seg = blockIdx.y, S = gridDim.y;
  const long long total = a.kr + a.n;
  const long long len = (total + S - 1) / S;
  const long long lo = min(total, seg * len), hi = min(total, lo + len);
  int m = 0;
  bool have = false;
  uint32_t thr = 0;
  for (long long p = lo; p < hi; p += kStep) {
    m += load_step(a, b, p, min(hi, p + kStep), m, have, thr, s);
    if (m > a.k && (!have || m + kStep > kCap)) {
      thr = select_k(m, a.k, s);
      m = a.k;
      have = true;
    }
  }
  if (m > a.k) {
    select_k(m, a.k, s);
    m = a.k;
  }
  __syncthreads();
  if (S == 1) {
    finish_row(a, b, m, s);
    return;
  }
  const long long c = (b * S + seg) * a.k;
  for (int i = threadIdx.x; i < m; i += kThreads) {
    a.cand_key[c + i] = s.key[i];
    a.cand_pos[c + i] = s.pos[i];
  }
  if (threadIdx.x == 0) a.cand_cnt[b * S + seg] = m;
}

// Pass B: block b merges its row's segments' candidates and writes the row.
__global__ void __launch_bounds__(kThreads) topk_merge_row_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  const long long b = blockIdx.x;
  const int S = a.segments;
  if (threadIdx.x == 0) {
    int off = 0;
    for (int t = 0; t < S; ++t) {
      s.seg_off[t] = off;
      off += a.cand_cnt[b * S + t];
    }
    s.seg_off[S] = off;
  }
  __syncthreads();
  for (int t = 0; t < S; ++t) {
    const int off = s.seg_off[t], cnt = s.seg_off[t + 1] - off;
    const long long c = (b * S + t) * a.k;
    for (int i = threadIdx.x; i < cnt; i += kThreads) {
      s.key[off + i] = a.cand_key[c + i];
      s.pos[off + i] = a.cand_pos[c + i];
    }
  }
  int m = s.seg_off[S];
  if (m > a.k) {
    select_k(m, a.k, s);
    m = a.k;
  }
  __syncthreads();
  finish_row(a, b, m, s);
}

constexpr int kMaxDevices = 64;
bool g_smem_set[kMaxDevices];

}  // namespace

// Ints of scratch a call needs: the candidates of pass A when a row has
// several segments, else none.
extern "C" long long topk_merge_scratch_ints(long long B, int k,
                                             int segments) {
  return segments > 1 ? B * segments * (2LL * k + 1) : 0;
}

// Enqueues the merge of B rows on `stream` (a cudaStream_t) of device
// `device`: rv, ri [B, kr], sv, si [B, n] (contiguous; kr + n < 2^31),
// out_v, out_i [B, k] with 1 <= k <= 128, `segments` (1..64) segments a row
// and, when it is above 1, topk_merge_scratch_ints(B, k, segments) ints of
// scratch. Returns the first CUDA error of the launches: 0 on success.
// Does not synchronise.
extern "C" int topk_merge_launch(const float* rv, const int* ri,
                                 const float* sv, const int* si,
                                 float* out_v, int* out_i, int* scratch,
                                 long long B, long long kr, long long n,
                                 int k, int is_ip, int segments, int device,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0) return 0;
  if (k < 1 || k > kMaxK || segments < 1 || segments > kMaxSegments ||
      kr < 0 || n < 0 || kr + n >= (1LL << 31) || B >= (1LL << 31) ||
      (segments > 1 && scratch == nullptr) || device < 0 ||
      device >= kMaxDevices)
    return (int)cudaErrorInvalidValue;
  if (!g_smem_set[device]) {
    err = cudaFuncSetAttribute(topk_merge_segment_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)sizeof(Smem));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(topk_merge_row_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)sizeof(Smem));
    if (err != cudaSuccess) return (int)err;
    g_smem_set[device] = true;
  }
  Args a;
  a.rv = rv;
  a.ri = ri;
  a.sv = sv;
  a.si = si;
  a.out_v = out_v;
  a.out_i = out_i;
  const long long nc = segments > 1 ? B * segments * k : 0;
  a.cand_key = reinterpret_cast<uint32_t*>(scratch);
  a.cand_pos = segments > 1 ? a.cand_key + nc : nullptr;
  a.cand_cnt = segments > 1 ? scratch + 2 * nc : nullptr;
  a.kr = kr;
  a.n = n;
  a.k = k;
  a.is_ip = is_ip;
  a.segments = segments;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)B, (unsigned)segments);
  topk_merge_segment_kernel<<<grid, kThreads, sizeof(Smem), s>>>(a);
  if (segments > 1)
    topk_merge_row_kernel<<<(unsigned)B, kThreads, sizeof(Smem), s>>>(a);
  return (int)cudaGetLastError();
}
