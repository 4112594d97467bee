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
// position) bit for bit, at any k. The key of a value is an
// order-preserving uint32 of its bits: -0.0 is taken as +0.0 (one key, as
// torch.sort compares them; no scan emits -0.0, since every dot sums from
// +0.0), every NaN as larger than +inf (as torch.sort ranks it: last for
// L2, first for IP), inverted for IP, where larger is better. A position
// joins it in one 64-bit composite key, (key << 32) | position, which is
// unique, so "the k best" is "the k smallest composite keys" with no tie
// rule left. Each winner's value and id are read back from its position,
// and a winner whose value is the metric's worst (+inf for L2, -inf for
// IP) gets id -1; slots past kr + n get the worst value and id -1.
//
// What bounds it: device-memory bytes. Each running and chunk value is
// read once (4 bytes a slot) and each winner's id is gathered and its value
// and id written (12 bytes): B*(kr+n)*4 + B*k*12 bytes. The work a value is
// a key and one compare; only values that can still win go further.
//
// Design. One block of 256 threads takes one (row, segment): segment 0
// the running result and the chunk's unaligned head and tail (one scalar
// step when they fit), and each segment an equal share of the chunk's
// 16-byte vectors, streamed in steps of 2048 positions (two float4 a
// thread, the next step's loads issued before the current one is
// filtered; four blocks a multiprocessor keep about 32 KB in flight).
//  - Threshold from the first position: the largest composite key among
//    the running result's first k positions bounds the row's k-th from the
//    start (k keys lie at or below it). The callers pass a sorted running
//    result, so it is the running k-th itself, and a window's later
//    rounds drop nearly every chunk value at one compare; an all-worst
//    running result drops the dead slots the same way.
//  - A value at or below the threshold is appended to a buffer (shared
//    memory for k <= 1024, the wrapper's global scratch above): a warp
//    takes the room for its kept keys of a vector by one atomicAdd and
//    places them by a prefix over its lanes; order in the buffer does not
//    matter. A step in which no warp filled the buffer past its trigger
//    costs one vote (__syncthreads_or). Past it, a radix select over the
//    64-bit keys (8-bit digits from the first that the buffer's keys do
//    not share, warp-aggregated histograms in shared memory, stopping at
//    the first digit whose bucket is taken whole) keeps exactly k and
//    tightens the threshold.
//  - A row of several segments (small batches: the wrapper sets the count
//    from the card's multiprocessors) shares its threshold: each select
//    publishes it by atomicMin to the row's state in global memory, and
//    every step reads it back. At its end a segment appends its winners
//    at or below the row's threshold to the row's pool and publishes its
//    j-th best key, j = ceil(k / S), by atomicMax: once k / j segments
//    have, that maximum bounds the row's k-th too. The last segment to
//    finish (an atomic counter) streams the pool through the same filter
//    and select, leaves the row's state as it found it, and writes the
//    row. One launch a call.
//  - At a stream's end at most 256 keys are ranked by counting the keys
//    below each, one a thread, with no select and no barrier; more are
//    first cut to k by the select, and k above 256 is ranked by a bitonic
//    sort of the buffer. Each winner's value and id are gathered by its
//    position.
// No host synchronisation and no allocation: the wrapper passes the pool
// and the large-k buffers (per call) and the rows' state (kept by the
// wrapper between calls; every launch leaves it as it was).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 8;                      // positions a thread a step
constexpr int kStep = kThreads * kPer;       // positions a step
constexpr int kMaxSmemK = 1024;              // above: buffers in scratch
constexpr int kCapS = 4096;                  // shared buffer, keys
constexpr int kRankMax = kThreads;           // ranked with no select
constexpr int kBins = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr u64 kNone = ~0ull;                 // no threshold

static_assert(kCapS - kStep >= kMaxSmemK, "a select leaves room for a step");

// The control block, in shared memory on both routes.
struct alignas(16) Ctl {
  int hist[2][kBins];
  u64 red[kWarps];
  u64 red2[kWarps];
  int m;        // keys in the buffer
  int m2;       // keys kept by a select's compaction
  int digit;
  int want;
  int dcount;
  int last;
};

// The candidate buffers of the shared-memory route (k <= kMaxSmemK).
struct Bufs {
  u64 buf[kCapS];
  u64 sel[kMaxSmemK];
};

// A row's state, shared by its segments (several segments a row only).
// Between launches: thr all ones, the rest zero.
struct RowState {
  u64 thr;      // the least published bound of the row's k-th key
  u64 tmax;     // the largest of the segments' j-th best keys
  int done;     // segments finished
  int pool;     // keys in the row's pool
  int contrib;  // segments that published a j-th best key
  int pad;
};

struct Args {
  const float* rv;     // [B, kr] running values
  const int* ri;       // [B, kr] running ids
  const float* sv;     // [B, n] chunk values
  const int* si;       // [B, n] chunk ids
  float* out_v;        // [B, k]
  int* out_i;          // [B, k]
  u64* pool;           // [B, S, k] the segments' candidates (S > 1)
  u64* big;            // [B * S, 3k + kStep] buffers (k > kMaxSmemK)
  RowState* state;     // [B] (S > 1)
  long long kr;
  long long n;
  int k;
  int is_ip;
  int S;               // segments a row
};

__device__ __forceinline__ uint32_t order_key(float v, int is_ip) {
  uint32_t u = __float_as_uint(v);
  if ((u & 0x7fffffffu) > 0x7f800000u) u = 0x7fc00000u;  // NaN: largest
  if (u == 0x80000000u) u = 0u;                           // -0.0 is +0.0
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return is_ip ? ~u : u;
}

__device__ __forceinline__ u64 comp(uint32_t key, long long p) {
  return ((u64)key << 32) | (uint32_t)p;
}

__device__ __forceinline__ float value_at(const Args& a, long long b,
                                          long long p) {
  return p < a.kr ? a.rv[b * a.kr + p] : a.sv[b * a.n + (p - a.kr)];
}

__device__ __forceinline__ int id_at(const Args& a, long long b,
                                     long long p) {
  return p < a.kr ? a.ri[b * a.kr + p] : a.si[b * a.n + (p - a.kr)];
}

__device__ __forceinline__ u64 ld_volatile(const u64* p) {
  return *reinterpret_cast<const volatile u64*>(p);
}

__device__ __forceinline__ int ld_volatile(const int* p) {
  return *reinterpret_cast<const volatile int*>(p);
}

__device__ __forceinline__ u64 min64(u64 x, u64 y) { return x < y ? x : y; }
__device__ __forceinline__ u64 max64(u64 x, u64 y) { return x > y ? x : y; }

// Inclusive prefix sum over the warp's lanes.
__device__ __forceinline__ int warp_inclusive(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += t;
  }
  return v;
}

// The block's maximum (is_max) or minimum of v; every thread calls it.
__device__ u64 block_reduce(u64 v, bool is_max, Ctl& s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const u64 t = __shfl_xor_sync(kFull, v, o);
    v = is_max ? max64(v, t) : min64(v, t);
  }
  if (lane == 0) s.red[warp] = v;
  __syncthreads();
  v = s.red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w)
    v = is_max ? max64(v, s.red[w]) : min64(v, s.red[w]);
  __syncthreads();
  return v;
}

// What a block carries through its stream.
struct Ctx {
  const Args& a;
  long long b;
  u64* buf;
  u64* sel;
  int trig;        // a step that leaves more keys than this selects
  u64 T;           // keys above it cannot win
  RowState* rs;    // the row's state while it is shared, else null
  u64 gthr;        // rs->thr as read at the top of the step
  Ctl& s;
};

// Appends this thread's kept keys (a warp-wide call): one atomicAdd a warp
// for the room, a prefix over the lanes' counts for the places; sets
// `over` when the buffer now holds more than the trigger.
template <int N>
__device__ __forceinline__ void append_n(const bool (&keep)[N],
                                         const u64 (&key)[N], Ctx& c,
                                         bool& over) {
  const int lane = threadIdx.x & 31;
  int cnt = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) cnt += keep[j];
  const int incl = warp_inclusive(cnt, lane);
  const int total = __shfl_sync(kFull, incl, 31);
  if (total == 0) return;
  int off = 0;
  if (lane == 31) off = atomicAdd(&c.s.m, total);
  off = __shfl_sync(kFull, off, 31);
  int at = off + incl - cnt;
#pragma unroll
  for (int j = 0; j < N; ++j)
    if (keep[j]) c.buf[at++] = key[j];
  if (off + total > c.trig) over = true;
}

// The buffer [0, m), m > k unique keys, becomes its k smallest (in no
// order). Returns a bound T with exactly those k keys at or below it.
__device__ u64 select_k(Ctx& c) {
  Ctl& s = c.s;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m = s.m, k = c.a.k;
  // the digits every key shares need no pass: start below them
  u64 mn = kNone, mx = 0;
  for (int i = threadIdx.x; i < m; i += kThreads) {
    mn = min64(mn, c.buf[i]);
    mx = max64(mx, c.buf[i]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    mn = min64(mn, __shfl_xor_sync(kFull, mn, o));
    mx = max64(mx, __shfl_xor_sync(kFull, mx, o));
  }
  if (lane == 0) {
    s.red[warp] = mn;
    s.red2[warp] = mx;
  }
  for (int i = threadIdx.x; i < kBins; i += kThreads) s.hist[0][i] = 0;
  if (threadIdx.x == 0) s.m2 = 0;
  __syncthreads();
  for (int w = 0; w < kWarps; ++w) {
    mn = min64(mn, s.red[w]);
    mx = max64(mx, s.red2[w]);
  }
  const int top = ((63 - __clzll((long long)(mn ^ mx))) >> 3) << 3;
  u64 mask = top >= 56 ? 0ull : ~0ull << (top + 8);
  u64 prefix = mn & mask, T = 0;
  int want = k;  // rank of the k-th among the keys that match the prefix
#pragma unroll 1
  for (int shift = top, pass = 0;; shift -= 8, ++pass) {
    int* h = s.hist[pass & 1];
    for (int base = warp * 32; base < m; base += kThreads) {
      const int i = base + lane;
      const u64 u = i < m ? c.buf[i] : 0ull;
      const bool in = i < m && (u & mask) == prefix;
      const unsigned d = in ? (unsigned)(u >> shift) & 0xffu : 0x100u;
      const unsigned peers = __match_any_sync(kFull, d);
      if (in && lane == __ffs(peers) - 1) atomicAdd(&h[d], __popc(peers));
    }
    __syncthreads();
    if (warp == 0) {
      int cnt[8];
      int sum = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        cnt[j] = h[lane * 8 + j];
        sum += cnt[j];
      }
      const int incl = warp_inclusive(sum, lane);
      const int excl = incl - sum;
      const unsigned hit = __ballot_sync(kFull, excl < want && want <= incl);
      if (lane == __ffs(hit) - 1) {
        int acc = excl;
        for (int j = 0; j < 8; ++j) {
          if (acc + cnt[j] >= want) {
            s.digit = lane * 8 + j;
            s.want = want - acc;
            s.dcount = cnt[j];
            break;
          }
          acc += cnt[j];
        }
      }
    } else if (warp == 1) {
      int* next = s.hist[(pass + 1) & 1];
      for (int j = lane; j < kBins; j += 32) next[j] = 0;
    }
    __syncthreads();
    prefix |= (u64)s.digit << shift;
    mask |= 0xffull << shift;
    want = s.want;
    if (s.dcount == want) {  // the bucket is taken whole: T bounds it
      T = prefix | (shift > 0 ? (1ull << shift) - 1ull : 0ull);
      break;
    }
  }
  // keep the keys at or below T (exactly k) in sel, then at the front
  for (int base = warp * 32; base < m; base += kThreads) {
    const int i = base + lane;
    const u64 u = i < m ? c.buf[i] : kNone;
    const bool keep = i < m && u <= T;
    const unsigned bal = __ballot_sync(kFull, keep);
    if (bal != 0) {
      const int leader = __ffs(bal) - 1;
      int off = 0;
      if (lane == leader) off = atomicAdd(&s.m2, __popc(bal));
      off = __shfl_sync(kFull, off, leader);
      if (keep) c.sel[off + __popc(bal & ((1u << lane) - 1u))] = u;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < k; i += kThreads) c.buf[i] = c.sel[i];
  if (threadIdx.x == 0) s.m = k;
  __syncthreads();
  return T;
}

// The end of a step (every thread): select if a warp filled the buffer
// past its trigger, publish the threshold, take the row's.
__device__ __forceinline__ void step_end(Ctx& c, bool& over) {
  if (__syncthreads_or(over)) {
    c.T = min64(c.T, select_k(c));
    if (c.rs != nullptr && threadIdx.x == 0) atomicMin(&c.rs->thr, c.T);
  }
  over = false;
  if (c.rs != nullptr) c.T = min64(c.T, c.gthr);
}

// Up to kStep positions of the concatenation, one value at a time: the
// virtual positions [lo, hi) of [running | chunk head | chunk tail], where
// virtual position q is position q below `gap` and q + `skip` from it.
__device__ void scalar_step(Ctx& c, long long lo, long long hi,
                            long long gap, long long skip) {
  if (c.rs != nullptr) c.gthr = ld_volatile(&c.rs->thr);
  bool keep[kPer];
  u64 key[kPer];
  bool any = false;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const long long q = lo + j * kThreads + threadIdx.x;
    const long long p = q < gap ? q : q + skip;
    key[j] = q < hi ? comp(order_key(value_at(c.a, c.b, p), c.a.is_ip), p)
                    : kNone;
    keep[j] = q < hi && key[j] <= c.T;
    any |= keep[j];
  }
  bool over = false;
  if (__any_sync(kFull, any)) append_n(keep, key, c, over);
  step_end(c, over);
}

// The keys of the four values of one vector (positions p .. p+3), kept
// where at or below the threshold.
__device__ __forceinline__ bool filter4(const Ctx& c, float4 x, bool valid,
                                        long long p, u64* key, bool* keep) {
  const float v[4] = {x.x, x.y, x.z, x.w};
  bool any = false;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    key[j] = comp(order_key(v[j], c.a.is_ip), p + j);
    keep[j] = valid && key[j] <= c.T;
    any |= keep[j];
  }
  return any;
}

__device__ __forceinline__ float4 load4(const float4* row, long long v,
                                        long long hi) {
  return v < hi ? __ldg(row + v) : make_float4(0.f, 0.f, 0.f, 0.f);
}

// The chunk's vectors [lo, hi) of the row, whose first value is at
// concatenation position pbase: two a thread a step (the first step's,
// x0 and x1, loaded by the caller), the next step's loads in flight while
// the current one is filtered.
__device__ void vector_stream(Ctx& c, const float4* row, long long pbase,
                              long long lo, long long hi, float4 x0,
                              float4 x1) {
  const int t = threadIdx.x;
  for (long long v0 = lo; v0 < hi; v0 += 2 * kThreads) {
    const long long vn = v0 + 2 * kThreads + t;
    const float4 y0 = load4(row, vn, hi), y1 = load4(row, vn + kThreads, hi);
    if (c.rs != nullptr) c.gthr = ld_volatile(&c.rs->thr);
    u64 key[4];
    bool keep[4];
    bool over = false;
    if (__any_sync(kFull, filter4(c, x0, v0 + t < hi, pbase + 4 * (v0 + t),
                                  key, keep)))
      append_n(keep, key, c, over);
    if (__any_sync(kFull, filter4(c, x1, v0 + kThreads + t < hi,
                                  pbase + 4 * (v0 + kThreads + t), key,
                                  keep)))
      append_n(keep, key, c, over);
    step_end(c, over);
    x0 = y0;
    x1 = y1;
  }
}

// Sorts the buffer's first n keys ascending (every thread calls it), by a
// bitonic network over the next power of two, padded with kNone.
__device__ void sort_buffer(Ctx& c, int n) {
  int N = 1;
  while (N < n) N <<= 1;
  for (int i = n + threadIdx.x; i < N; i += kThreads) c.buf[i] = kNone;
  __syncthreads();
  for (int kk = 2; kk <= N; kk <<= 1) {
    for (int j = kk >> 1; j > 0; j >>= 1) {
      for (int p = threadIdx.x; p < N / 2; p += kThreads) {
        const int i = (p / j) * 2 * j + (p % j), l = i + j;
        const u64 x = c.buf[i], y = c.buf[l];
        if ((x > y) == ((i & kk) == 0)) {
          c.buf[i] = y;
          c.buf[l] = x;
        }
      }
      __syncthreads();
    }
  }
}

// A stream's winners: each thread's key and its rank, or the sorted
// buffer's first `won` keys.
struct Ranked {
  u64 key;
  int rank;  // past any k for no key
  bool sorted;
  int won;
};

// The end of a stream: the buffer's m keys cut to the best k and ranked.
// At most kRankMax keys are ranked as they are (thread t: key t, by
// counting the keys below it); more are cut by the select first, and above
// kRankMax ranked by sorting the buffer.
__device__ void cut_and_rank(Ctx& c, Ranked& r) {
  __syncthreads();
  int m = c.s.m;
  const int k = c.a.k;
  if (m > kRankMax && m > k) {
    c.T = min64(c.T, select_k(c));
    m = k;
  }
  r.won = m < k ? m : k;
  r.sorted = m > kRankMax;
  if (r.sorted) {
    sort_buffer(c, m);
    return;
  }
  __syncthreads();
  const bool has = (int)threadIdx.x < m;
  r.key = has ? c.buf[threadIdx.x] : kNone;
  r.rank = 0;
  for (int j = 0; j < m; ++j) r.rank += c.buf[j] < r.key;
  if (!has) r.rank = 0x7fffffff;
}

// Writes row b's winner at `slot` from its key.
__device__ __forceinline__ void write_slot(const Args& a, long long b,
                                           int slot, u64 key, float worst) {
  const long long p = (uint32_t)key;
  const float v = value_at(a, b, p);
  const int id = id_at(a, b, p);
  a.out_v[b * a.k + slot] = v;
  a.out_i[b * a.k + slot] = v == worst ? -1 : id;
}

// Writes row b: the winners at their ranks, then the worst value and id
// -1 past them.
__device__ void write_row(Ctx& c, const Ranked& r) {
  const Args& a = c.a;
  const float worst =
      __int_as_float(a.is_ip ? (int)0xff800000u : 0x7f800000);
  if (!r.sorted && r.rank < a.k) write_slot(a, c.b, r.rank, r.key, worst);
  for (int i = threadIdx.x; i < a.k; i += kThreads) {
    if (r.sorted && i < r.won) write_slot(a, c.b, i, c.buf[i], worst);
    if (i >= r.won) {
      a.out_v[c.b * a.k + i] = worst;
      a.out_i[c.b * a.k + i] = -1;
    }
  }
}

// Appends `key` where `keep` to the row's pool (a warp-wide call).
__device__ __forceinline__ void to_pool(bool keep, u64 key, u64* pool,
                                        RowState* rs) {
  const unsigned bal = __ballot_sync(kFull, keep);
  if (bal == 0) return;
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(bal) - 1;
  int off = 0;
  if (lane == leader) off = atomicAdd(&rs->pool, __popc(bal));
  off = __shfl_sync(kFull, off, leader);
  if (keep) pool[off + __popc(bal & ((1u << lane) - 1u))] = key;
}

template <bool kBig>
__global__ void __launch_bounds__(kThreads, 4) topk_merge_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Ctl& s = *reinterpret_cast<Ctl*>(smem_raw);
  const int S = a.S, k = a.k;
  const long long b = blockIdx.x / S;
  const int seg = blockIdx.x % S;
  u64* buf;
  u64* sel;
  int trig;
  if (kBig) {
    buf = a.big + (long long)blockIdx.x * (3LL * k + kStep);
    sel = buf + 2LL * k + kStep;
    trig = 2 * k;
  } else {
    Bufs& bb = *reinterpret_cast<Bufs*>(smem_raw + sizeof(Ctl));
    buf = bb.buf;
    sel = bb.sel;
    trig = kCapS - kStep;
  }
  Ctx c{a, b, buf, sel, trig, kNone,
        S > 1 ? a.state + b : nullptr, kNone, s};
  if (threadIdx.x == 0) s.m = 0;
  // the chunk: an unaligned head of h values, nv 16-byte vectors, a tail;
  // this segment's first step of vectors is loaded first
  const float* row = a.sv + b * a.n;
  long long h = (long long)(((16u - ((uintptr_t)row & 15u)) & 15u) >> 2);
  if (h > a.n) h = a.n;
  const long long nv = (a.n - h) >> 2;
  const long long per = (nv + S - 1) / S;
  const long long v_lo = per * seg < nv ? per * seg : nv;
  const long long v_hi = v_lo + per < nv ? v_lo + per : nv;
  const float4* vrow = reinterpret_cast<const float4*>(row + h);
  const float4 x0 = load4(vrow, v_lo + threadIdx.x, v_hi);
  const float4 x1 = load4(vrow, v_lo + kThreads + threadIdx.x, v_hi);
  // the running result's first k keys bound the row's k-th
  if (a.kr >= k) {
    u64 mx = 0;
    for (int p = threadIdx.x; p < k; p += kThreads)
      mx = max64(mx, comp(order_key(a.rv[b * a.kr + p], a.is_ip), p));
    c.T = block_reduce(mx, true, s);
  }
  if (c.rs != nullptr) c.T = min64(c.T, ld_volatile(&c.rs->thr));
  __syncthreads();
  if (seg == 0) {  // the running result, the head and the tail
    const long long gap = a.kr + h, skip = 4 * nv;
    const long long nq = a.kr + a.n - skip;
    for (long long q = 0; q < nq; q += kStep)
      scalar_step(c, q, q + kStep < nq ? q + kStep : nq, gap, skip);
  }
  vector_stream(c, vrow, a.kr + h, v_lo, v_hi, x0, x1);
  Ranked r;
  cut_and_rank(c, r);
  if (S == 1) {
    write_row(c, r);
    return;
  }

  // several segments: this one's winners into the row's pool, and its
  // j-th best key into the row's maximum
  RowState* rs = c.rs;
  const u64 te = min64(c.T, ld_volatile(&rs->thr));
  u64* pool = a.pool + b * S * k;
  const int jth = (k + S - 1) / S;
  if (r.sorted) {
    for (int i0 = 0; i0 < r.won; i0 += kThreads) {
      const int i = i0 + threadIdx.x;
      const u64 u = i < r.won ? buf[i] : kNone;
      to_pool(i < r.won && u <= te, u, pool, rs);
    }
    if (threadIdx.x == 0 && r.won >= jth) {
      atomicMax(&rs->tmax, buf[jth - 1]);
      atomicAdd(&rs->contrib, 1);
    }
  } else {
    to_pool(r.rank < k && r.key <= te, r.key, pool, rs);
    if (r.rank == jth - 1) {
      atomicMax(&rs->tmax, r.key);
      atomicAdd(&rs->contrib, 1);
    }
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s.last = atomicAdd(&rs->done, 1) == S - 1;
  __syncthreads();
  if (!s.last) return;

  // the row's last segment: its pool through the same filter and select
  __threadfence();
  const int total = ld_volatile(&rs->pool);
  c.T = ld_volatile(&rs->thr);
  if ((long long)ld_volatile(&rs->contrib) * jth >= k)
    c.T = min64(c.T, ld_volatile(&rs->tmax));
  c.rs = nullptr;
  if (threadIdx.x == 0) s.m = 0;
  __syncthreads();
  for (int i0 = 0; i0 < total; i0 += kStep) {
    bool keep[kPer];
    u64 key[kPer];
    bool any = false;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = i0 + j * kThreads + threadIdx.x;
      key[j] = i < total ? __ldcg(pool + i) : kNone;
      keep[j] = i < total && key[j] <= c.T;
      any |= keep[j];
    }
    bool over = false;
    if (__any_sync(kFull, any)) append_n(keep, key, c, over);
    step_end(c, over);
  }
  cut_and_rank(c, r);
  if (threadIdx.x == 0) {  // as the next launch expects it
    rs->thr = kNone;
    rs->tmax = 0;
    rs->done = 0;
    rs->pool = 0;
    rs->contrib = 0;
  }
  write_row(c, r);
}

constexpr int kMaxDevices = 64;
bool g_smem_set[kMaxDevices][2];

template <bool kBig>
constexpr int smem_bytes() {
  return (int)(sizeof(Ctl) + (kBig ? 0 : sizeof(Bufs)));
}

}  // namespace

// Bytes of per-call scratch: the rows' pools when a row has several
// segments, and each block's candidate buffers when k > 1024.
extern "C" long long topk_merge_scratch_bytes(long long B, int k,
                                              int segments) {
  long long keys = 0;
  if (segments > 1) keys += B * segments * (long long)k;
  if (k > kMaxSmemK) keys += B * segments * (3LL * k + kStep);
  return keys * (long long)sizeof(u64);
}

// Enqueues the merge of B rows on `stream` (a cudaStream_t) of device
// `device`: rv, ri [B, kr], sv, si [B, n] (contiguous; kr + n < 2^31),
// out_v, out_i [B, k], k >= 1, `segments` >= 1 a row (B * segments <
// 2^31), topk_merge_scratch_bytes(B, k, segments) bytes of scratch and,
// when segments > 1, the rows' state: 32 bytes a row (RowState), the first
// 8 all ones and the rest zero, as every launch leaves them.
// Returns the launch's CUDA error: 0 on success. Does not synchronise.
extern "C" int topk_merge_run(const float* rv, const int* ri,
                              const float* sv, const int* si, float* out_v,
                              int* out_i, void* scratch, void* state,
                              long long B, long long kr, long long n, int k,
                              int is_ip, int segments, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0) return 0;
  const bool big = k > kMaxSmemK;
  if (k < 1 || segments < 1 || kr < 0 || n < 0 || kr + n >= (1LL << 31) ||
      B * segments >= (1LL << 31) ||
      (topk_merge_scratch_bytes(B, k, segments) > 0 && scratch == nullptr) ||
      (segments > 1 && state == nullptr) || device < 0 ||
      device >= kMaxDevices)
    return (int)cudaErrorInvalidValue;
  if (!g_smem_set[device][big]) {
    err = big ? cudaFuncSetAttribute(
                    topk_merge_kernel<true>,
                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                    smem_bytes<true>())
              : cudaFuncSetAttribute(
                    topk_merge_kernel<false>,
                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                    smem_bytes<false>());
    if (err != cudaSuccess) return (int)err;
    g_smem_set[device][big] = true;
  }
  Args a;
  a.rv = rv;
  a.ri = ri;
  a.sv = sv;
  a.si = si;
  a.out_v = out_v;
  a.out_i = out_i;
  u64* keys = static_cast<u64*>(scratch);
  a.pool = segments > 1 ? keys : nullptr;
  a.big = big ? keys + (segments > 1 ? B * segments * (long long)k : 0)
              : nullptr;
  a.state = static_cast<RowState*>(state);
  a.kr = kr;
  a.n = n;
  a.k = k;
  a.is_ip = is_ip;
  a.S = segments;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = (unsigned)(B * segments);
  if (big)
    topk_merge_kernel<true><<<grid, kThreads, smem_bytes<true>(), s>>>(a);
  else
    topk_merge_kernel<false><<<grid, kThreads, smem_bytes<false>(), s>>>(a);
  return (int)cudaGetLastError();
}
