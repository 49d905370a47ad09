// All-reduce (sum) of n fp32, bf16 or fp16 partials for Hopper (sm_90a), in
// the ring's order of additions.
//
// Replaces the Pallas TPU kernel `_ring_kernel` / `ring_all_reduce` in
// client_tpu/parallel/kv_shard.py:84. Same function and the same order of
// additions: shard i's result is ((x_i + x_{i-1}) + x_{i-2}) + ... + x_{i+1}
// (indices mod n), the order in which the TPU ring's n - 1 hops deliver
// the other shards' partials. Every shard gets the sum (the result is
// replicated); the Python wrapper's plain version repeats those hops step
// by step, so kernel and plain version agree bit for bit.
//
// Element types. The TPU kernel sums in x.dtype, hop by hop
// (`o_ref[...] += buf_ref[dst]`, :108): in bf16 or fp16 every hop's sum is
// rounded to that type. Here a bf16 or fp16 hop is one native add in the
// type, two elements at a time (PTX add.rn.bf16x2 / add.rn.f16x2, SASS
// HADD2; add.rn.bf16 / add.rn.f16 for one element), rounded to nearest
// even. The plain version adds in fp32 and rounds the sum to the type,
// which is the same bits: fp32's 24-bit significand is at least 2p + 2 for
// p = 8 (bf16) and p = 11 (fp16), so rounding the exact sum to fp32 and
// then to the type gives the correctly rounded sum for every pair that is
// not NaN, overflow to +-inf and subnormals included (the build has no
// fast-math flag, so nothing flushes). fp32 hops are FADD (Hopper has no
// packed fp32 add). A 16-byte group holds 4 fp32 or 8 bf16 / fp16
// elements; elements that do not fill one, and every element when a
// pointer is not 16-byte aligned, take a scalar path of the same kernels.
//
// Design. On the TPU every device runs its own copy of the kernel and a
// start() + wait() per hop keeps the devices in lockstep. Here every shard
// lives on one card, so one ordinary launch plays all the hops.
//
// - n <= 8 (one_shot_kernel<T, n>): each thread loads its group of every
//   partial into registers once and writes each shard's sum in that
//   shard's ring order.
//
// - n >= 9: a register-blocked walk along the ring. A thread owns one lane
//   (4, 8 or 16 bytes of elements) and R consecutive shards i .. i+R-1 (R
//   accumulators). Shard i+1 adds at hop j+1 exactly the partial shard i
//   adds at hop j, so the thread walks the partials once, in descending
//   ring order from x_{i+R-1}, and adds each partial it reads to every
//   chain that has started and not finished: n + R - 1 reads for R * n
//   additions, R independent chains in flight. Each chain starts from -0.0
//   (the additive identity: -0 + x is x, bits and all), so the first
//   partial of a chain is an add like the rest and the walk has one shape:
//   R - 1 steps of ramp at each end where only some chains add, and
//   n - R + 1 steps where all do, unrolled.
//
//   9 to 16 shards (direct_kernel<T, V, 2, P>): R = 2, and each lane loads
//   its n + 1 partials straight into registers, all in flight at once, with
//   no shared memory and no barrier; its time is one load's latency, so the
//   plan takes the widest lane that still gives the card two CTAs an SM.
//
//   17 shards and up (walk_kernel<T, V, R, P>): a CTA is W <= 4 warps over
//   32 lanes and W * R consecutive shards (R a warp). Its warps need the
//   same 32 lanes of every partial, warp k R rows behind warp k + 1, so the
//   CTA stages rows (the 32 lanes of one partial) once into shared memory
//   with cp.async: every row at once when they fit 48 KB, else through a
//   ring of rows, C rows a chunk (C = 8, or 4 when R = 4), four chunks
//   ahead of the walk, one barrier a chunk; no CTA holds all n partials.
//   The grid covers (32-lane tiles) x (shard blocks of W * R), so the
//   decode wave's [16, 4, 64] spreads over more CTAs than the card has SMs
//   in every dtype; other shard blocks' re-reads of a tile come from L2
//   (all partials at bf16 n = 1,024 and [16, 4, 64] are 8 MB). The plan
//   (lane width, R of 2 to 16, W) is the one that costs least in issued
//   instructions on the busiest scheduler (plan()).
//
// Pointer tables. They go by value with the launch: 2 x n pointers for the
// unrolled kernels, 2 x 16 for the direct walk, 2 x 64 (1 KB) for the
// staged walk up to 64 shards, and 2 x 1,816 (29 KB) above that. Since
// CUDA 12.1 a kernel on sm_70 and later may take up to 32,764 bytes of
// parameters, so no shard count needs a table in device memory (nor a copy
// of one before the launch). The range, 2 to 1,816 shards, is the one the
// staged kernel this replaced took.
//
// What bounds it on an H100: it reads n * numel * size bytes and writes the
// same (3.35 TB/s), and does (n - 1) * n * numel additions: packed bf16 /
// fp16 at 66.9e12 a second (HADD2: 132 SMs x 128 lanes x 2 x 1.98 GHz) and
// fp32 at 33.45e12 (one FADD a lane a clock). At the decode wave's
// [16, 4, 64] that is bytes up to about n = 40 and the additions above: in
// bf16 0.0040 ms at n = 256 and 0.064 ms at n = 1,024, twice that in fp32.
// Every add issues one instruction, so the walk's other instructions (one
// shared-memory load per R adds, staging, a barrier a chunk) are what
// stands between it and that bound. Below n = 17 the time is that of one
// launch and one load. No kernel that keeps the ring's n orders can come
// near torch.stack(x).sum(0) at large n: that call adds n times less.
//
// Across cards the same loads would go through peer pointers over NVLink
// (queue item Q1.8); that is not built: the Python mesh (kv_mesh) raises
// NotImplementedError for distinct cards, so every pointer here is in one
// card's memory.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxCtas = 1024;
constexpr int kSmallTable = 64;    // shards of the walk's small table
constexpr int kMaxShards = 1816;   // shards of its large table (29 KB)
constexpr int kLanes = 32;         // groups of a staged row: one a lane
constexpr int kMaxWarps = 4;       // warps of a walk CTA

// One 16-byte group of elements.
template <typename T>
struct alignas(16) Group {
  static constexpr int kElems = 16 / sizeof(T);
  T e[kElems];
};

// s += y, one hop, rounded to nearest even in the element's type.
__device__ __forceinline__ void add_to(float& s, const float& y) {
  s = s + y;
}
__device__ __forceinline__ void add_to(__nv_bfloat16& s,
                                       const __nv_bfloat16& y) {
  unsigned short d;
  asm("add.rn.bf16 %0, %1, %2;"
      : "=h"(d)
      : "h"(__bfloat16_as_ushort(s)), "h"(__bfloat16_as_ushort(y)));
  s = __ushort_as_bfloat16(d);
}
__device__ __forceinline__ void add_to(__half& s, const __half& y) {
  unsigned short d;
  asm("add.rn.f16 %0, %1, %2;"
      : "=h"(d)
      : "h"(__half_as_ushort(s)), "h"(__half_as_ushort(y)));
  s = __ushort_as_half(d);
}

// Two elements a 32-bit word.
__device__ __forceinline__ uint32_t add2(uint32_t a, uint32_t b,
                                         __nv_bfloat16) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t add2(uint32_t a, uint32_t b, __half) {
  uint32_t d;
  asm("add.rn.f16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

template <typename T>
__device__ __forceinline__ void add_to(Group<T>& s, const Group<T>& y) {
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int k = 0; k < Group<T>::kElems; ++k) add_to(s.e[k], y.e[k]);
  } else {
    uint32_t* a = reinterpret_cast<uint32_t*>(s.e);
    const uint32_t* b = reinterpret_cast<const uint32_t*>(y.e);
#pragma unroll
    for (int k = 0; k < 4; ++k) a[k] = add2(a[k], b[k], T());
  }
}

// A walk's lane: K 32-bit words of elements (4, 8 or 16 bytes).
template <typename T, int K>
struct alignas(4 * K) Lane {
  uint32_t w[K];
};

template <typename T, int K>
__device__ __forceinline__ void add_to(Lane<T, K>& s, const Lane<T, K>& y) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if constexpr (sizeof(T) == 4) {
      s.w[k] = __float_as_uint(__uint_as_float(s.w[k]) +
                               __uint_as_float(y.w[k]));
    } else {
      s.w[k] = add2(s.w[k], y.w[k], T());
    }
  }
}

// -0.0 in every element: a chain's start.
__device__ __forceinline__ void set_negative_zero(float& v) { v = -0.0f; }
__device__ __forceinline__ void set_negative_zero(__nv_bfloat16& v) {
  v = __ushort_as_bfloat16(0x8000);
}
__device__ __forceinline__ void set_negative_zero(__half& v) {
  v = __ushort_as_half(0x8000);
}
template <typename T, int K>
__device__ __forceinline__ void set_negative_zero(Lane<T, K>& v) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    v.w[k] = sizeof(T) == 4 ? 0x80000000u : 0x80008000u;
  }
}

// The pointer tables, by value, for up to N shards.
template <typename T, int N>
struct Ptrs {
  const T* x[N];  // the partials, one per shard
  T* out[N];      // the replicated sums
};
// The walk's parameters (the largest table, n, ring, first, count) fit
// the 32,764 bytes a launch may carry.
static_assert(sizeof(Ptrs<float, kMaxShards>) + 32 <= 32764,
              "kernel parameters past CUDA's limit");

// Shard i's sum of x[0..N) in ring order: x_i, then x_{i-1}, x_{i-2}, ...
template <int N, typename V>
__device__ __forceinline__ V ring_sum(const V (&x)[N], int i) {
  V s = x[i];
#pragma unroll
  for (int j = 1; j < N; ++j) add_to(s, x[(i - j + N) % N]);
  return s;
}

// Elements [0, kElems * n_vec) in 16-byte groups, then [kElems * n_vec,
// numel) one at a time; a grid-stride loop over each.
template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
    one_shot_kernel(Ptrs<T, N> p, int64_t n_vec, int64_t numel) {
  typedef Group<T> G;
  const int64_t first = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t e = first; e < n_vec; e += stride) {
    G x[N];
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = reinterpret_cast<const G*>(p.x[i])[e];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      reinterpret_cast<G*>(p.out[i])[e] = ring_sum<N>(x, i);
    }
  }
  for (int64_t e = G::kElems * n_vec + first; e < numel; e += stride) {
    T x[N];
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = p.x[i][e];
#pragma unroll
    for (int i = 0; i < N; ++i) p.out[i][e] = ring_sum<N>(x, i);
  }
}

// An asynchronous copy of B = 4, 8 or 16 bytes into shared memory (16
// bypasses L1: each row is staged once a CTA).
template <int B>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (B == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s),
                 "l"(src)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(s),
                 "l"(src), "n"(B)
                 : "memory");
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Chunk of a walk: C steps unrolled, and while the walk streams, one
// barrier and one batch of copies a chunk. C divides R when R >= 4, so
// every warp's rows of a chunk are consecutive slots of the ring; R 2 only
// runs with every row staged at once (no wrap).
template <int R>
__host__ __device__ constexpr int chunk_rows() {
  return R == 4 ? 4 : 8;
}
// Chunks staged ahead of the walk while it streams: 32 rows, about a
// microsecond of the walk's adds at R = 4 and more above, to cover L2's
// latency.
template <int R>
__host__ __device__ constexpr int ahead_chunks() {
  return 32 / chunk_rows<R>();
}

// n >= 9 shards: groups [0, count) of V (a 16-byte group or one element of
// T) starting at element `first` of every partial. blockIdx.x picks 32
// groups (one a lane), blockIdx.y W * R shards (warp k the R shards from
// b0 + k * R), W = blockDim.x / 32. CTA row t is partial (b0 + S - 1 - t)
// mod n, S = W * R: warp k at step t of its walk reads row t + (W - 1 - k)
// * R, so its chain r (shard b0 + k * R + r) adds rows' partials from x of
// its own shard down the ring, n of them, at steps R - 1 - r to
// n + R - 2 - r. `ring` rows of shared memory: at least every row the
// warps read (the CTA's rows, rounded up to whole chunks) when all of them
// are staged at once, else (ahead_chunks + 1) chunks and (W - 1) * R rows,
// streamed.
template <typename T, typename V, int R, typename P>
__global__ void __launch_bounds__(kLanes * kMaxWarps)
    walk_kernel(P p, int n, int ring, int64_t first, int64_t count) {
  constexpr int C = chunk_rows<R>();
  constexpr int kAhead = ahead_chunks<R>();
  extern __shared__ float4 smem[];  // float4: aligned for either V
  V* tile = reinterpret_cast<V*>(smem);  // [ring][kLanes]
  const int lane = threadIdx.x % kLanes, warp = threadIdx.x / kLanes;
  const int warps = blockDim.x / kLanes;
  const int S = warps * R;
  const int b0 = blockIdx.y * S;
  const int64_t g = (int64_t)blockIdx.x * kLanes + lane;
  const bool live = g < count;
  const int rows = n + S - 1;           // the CTA's rows
  const int lead = (warps - 1) * R;     // warp 0's rows ahead of warp W-1's
  const int steps = n + R - 1;          // each warp's walk
  const int chunks = (steps + C - 1) / C;
  const bool whole = ring >= rows;      // every row staged at once

  // This warp stages CTA rows warp, warp + W, ... (its rows 0, 1, ...)
  // in order. A row's pointer is a read of the launch's table, which waits
  // on the constant cache, so the warp reads 32 rows' pointers at once,
  // lane j row i0 + j's, 32 rows before it stages them, and hands each to
  // every lane with a shuffle. `i` is the next row, `slot` its slot.
  auto pointers = [&](int i0) {
    int t = warp + warps * (i0 + lane);
    t = t < rows ? t : rows - 1;
    return p.x[(b0 + S - 1 - t + n) % n];
  };
  int i = 0, slot = warp;
  const T* cur = pointers(0);
  const T* nxt = pointers(kLanes);
  auto stage = [&](int hi) {  // rows up to hi (exclusive)
    hi = hi < rows ? hi : rows;
    for (int t = warp + warps * i; t < hi; t += warps, ++i) {
      const int j = i % kLanes;
      const T* src = reinterpret_cast<const T*>(__shfl_sync(
          0xffffffffu, reinterpret_cast<unsigned long long>(cur), j));
      if (live) {
        const V* from = reinterpret_cast<const V*>(src + first) + g;
        V* to = tile + slot * kLanes + lane;
        if constexpr (sizeof(V) >= 4) {
          cp_async<sizeof(V)>(to, from);
        } else {
          *to = *from;
        }
      }
      slot += warps;
      slot -= slot >= ring ? ring : 0;
      if (j == kLanes - 1) {
        cur = nxt;
        nxt = pointers(i + 1 + kLanes);
      }
    }
  };
  if (whole) {
    stage(rows);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  } else {
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      stage((j + 1) * C + lead);
      cp_async_commit();
    }
  }

  V s[R];
#pragma unroll
  for (int r = 0; r < R; ++r) set_negative_zero(s[r]);
  int base = (warps - 1 - warp) * R;  // this warp's slot at step 0
  for (int c = 0; c < chunks; ++c) {
    if (!whole) {
      cp_async_wait<kAhead - 1>();
      __syncthreads();  // chunk c's rows are in; chunk c - 1's reads done
      stage((c + kAhead + 1) * C + lead);
      cp_async_commit();
    }
    // The chunk's C rows first, then the adds: a load a step would leave
    // each step waiting on shared memory when R is small.
    const V* row = tile + base * kLanes + lane;
    V x[C];
#pragma unroll
    for (int u = 0; u < C; ++u) x[u] = row[u * kLanes];
    const int t0 = c * C;
    if (t0 >= R - 1 && t0 + C <= n) {  // every chain adds every row
#pragma unroll
      for (int u = 0; u < C; ++u) {
#pragma unroll
        for (int r = 0; r < R; ++r) add_to(s[r], x[u]);
      }
    } else {  // the ramps: chain r adds at steps R - 1 - r to n + R - 2 - r
#pragma unroll
      for (int u = 0; u < C; ++u) {
        const int lo = R - 1 - (t0 + u), hi = n + R - 2 - (t0 + u);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (r >= lo && r <= hi) add_to(s[r], x[u]);
        }
      }
    }
    base += C;
    base -= base >= ring ? ring : 0;
  }

  const int i0 = b0 + warp * R;
  if (live) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (i0 + r < n) reinterpret_cast<V*>(p.out[i0 + r] + first)[g] = s[r];
    }
  }
}

// n = 9 to kDirectShards: the walk with no shared memory. Each warp
// is 32 lanes of groups V and R shards, i0 .. i0 + R - 1 with i0 = R *
// (blockIdx.y * W + warp); every lane loads its group of the n + R - 1
// partials its chains add, x_{i0+R-1} down the ring to x_{i0}, straight
// into registers (R - 1 loads repeat and hit L1), then adds them, chain r
// at steps R - 1 - r to n + R - 2 - r. With so few partials a staged walk
// spends its time in the copy to shared memory and the barrier; here a
// lane's loads are all in flight at once and nothing waits on another warp.
constexpr int kDirectShards = 16;

template <typename T, typename V, int R, typename P>
__global__ void __launch_bounds__(kLanes * kMaxWarps)
    direct_kernel(P p, int n, int64_t first, int64_t count) {
  constexpr int kRows = kDirectShards + R - 1;
  const int lane = threadIdx.x % kLanes, warp = threadIdx.x / kLanes;
  const int i0 = R * (blockIdx.y * (blockDim.x / kLanes) + warp);
  const int64_t g = (int64_t)blockIdx.x * kLanes + lane;
  if (i0 >= n || g >= count) return;
  const int rows = n + R - 1;
  int m = (i0 + R - 1) % n;  // row t's partial, x_{i0+R-1-t} mod n
  V x[kRows];
#pragma unroll
  for (int t = 0; t < kRows; ++t) {
    if (t < rows) {
      x[t] = reinterpret_cast<const V*>(p.x[m] + first)[g];
      m = m == 0 ? n - 1 : m - 1;
    }
  }
  V s[R];
#pragma unroll
  for (int r = 0; r < R; ++r) set_negative_zero(s[r]);
#pragma unroll
  for (int t = 0; t < kRows; ++t) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r >= R - 1 - t && r <= n + R - 2 - t) add_to(s[r], x[t]);
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (i0 + r < n) reinterpret_cast<V*>(p.out[i0 + r] + first)[g] = s[r];
  }
}

// The walk's plan for one pass: lanes of `bytes` (4, 8 or 16; 2 for one
// bf16 / fp16 element), R chains a thread (2, 4, 8 or 16), W warps a CTA
// (no more than the shards need), the CTA's shard blocks and its ring's
// rows. A plan is costed in cycles of the busiest scheduler (132 SMs x 4):
// its warps there times a warp's instructions (adds, a shared-memory load
// and index a step, the ramps' predicates, staging, a barrier a chunk when
// the walk streams) over the share of cycles they issue in, which on the
// card grows by about 0.45 a warp up to 0.9 (the chains, the loads and the
// barriers leave a lone warp idle about half the time); plus, when every
// row is staged at once, the wait for them. The cheapest wins.
// R 2 only when every row fits at once.
struct Plan {
  int bytes, r, warps, blocks, ring;
  int64_t lanes, tiles;
  double cost;
};

constexpr int kSms = 132;
constexpr int kRingBytes = 48 * 1024;  // a block's shared memory unopted

Plan plan(int n, int64_t lanes, int bytes) {
  const int words = bytes / 4 > 0 ? bytes / 4 : 1;  // a chain's adds a row
  const int64_t tiles = (lanes + kLanes - 1) / kLanes;
  Plan best{};
  for (int r = 16; r >= 2; r /= 2) {
    const int c = r == 4 ? 4 : 8;
    const int per = (n + r - 1) / r;
    const int warps = per < kMaxWarps ? per : kMaxWarps;
    const int blocks = (n + warps * r - 1) / (warps * r);
    const int steps = n + r - 1, chunks = (steps + c - 1) / c;
    const int lead = (warps - 1) * r;
    const int rows = n + warps * r - 1;
    const int whole_ring = chunks * c + lead;
    const bool whole = (int64_t)whole_ring * kLanes * bytes <= kRingBytes;
    if (!whole && r < 4) continue;
    const int ring = whole ? whole_ring : (32 / c + 1) * c + lead;
    const int64_t ctas = tiles * blocks;
    const int64_t per_sm = (ctas + kSms - 1) / kSms;
    const int64_t load = (per_sm * warps + 3) / 4;  // warps a scheduler
    const double warp_instr = (double)steps * (r * words + 2) +
                              4.0 * r * r +                 // the ramps
                              (double)rows / warps * 6 +    // staging
                              (whole ? 0.0 : chunks * 30.0);
    const double share = load >= 2 ? 0.9 : 0.45;
    const double cost = (double)load * warp_instr / share +
                        (whole ? 1000.0 : 0.0);
    if (best.r == 0 || cost < best.cost) {
      best = Plan{bytes, r, warps, blocks, ring, lanes, tiles, cost};
    }
  }
  return best;
}

// The direct walk's plan for one pass (n <= kDirectShards): R 2, four
// warps a CTA, no shared memory (ring 0).
Plan plan_direct(int n, int64_t lanes, int bytes) {
  const int64_t tiles = (lanes + kLanes - 1) / kLanes;
  const int blocks = (n + 2 * kMaxWarps - 1) / (2 * kMaxWarps);
  return Plan{bytes, 2, kMaxWarps, blocks, 0, lanes, tiles, 0.0};
}

// Its main pass: the widest lane that still gives the card kDirectCtas
// CTAs (two an SM), else 4-byte lanes. Its time is about one load's
// latency; on an H100, four warps a CTA beat one at 9 and 16 shards, so
// the CTAs are not spread thinner to reach more SMs.
constexpr int kDirectCtas = 2 * kSms;

template <typename T>
Plan plan_direct_main(int n, int64_t numel, int align) {
  Plan pl{};
  for (int bytes = 16; bytes >= 4; bytes /= 2) {
    const int64_t lanes = numel * (int64_t)sizeof(T) / bytes;
    if (align < bytes || lanes == 0) continue;
    pl = plan_direct(n, lanes, bytes);
    if (pl.tiles * pl.blocks >= kDirectCtas) break;
  }
  return pl;
}

// Both passes for n partials of `numel` elements of T whose pointers are
// all `align`-byte aligned: over the elements that fill whole lanes, the
// widest-lane plan that costs least (the direct walk's above, up to
// kDirectShards), then the rest one element (2-byte types) or one word
// (fp32) a lane.
struct Plans {
  Plan main, tail;
};

template <typename T>
Plans plans(int n, int64_t numel, int align) {
  const bool direct = n <= kDirectShards;
  Plans out{};
  if (direct) {
    out.main = plan_direct_main<T>(n, numel, align);
  } else {
    for (int bytes = 16; bytes >= 4; bytes /= 2) {
      const int64_t lanes = numel * (int64_t)sizeof(T) / bytes;
      if (align < bytes || lanes == 0) continue;
      const Plan pl = plan(n, lanes, bytes);
      if (out.main.r == 0 || pl.cost < out.main.cost) out.main = pl;
    }
  }
  const int64_t done = out.main.lanes * out.main.bytes / (int64_t)sizeof(T);
  if (done < numel) {
    out.tail = direct ? plan_direct(n, numel - done, (int)sizeof(T))
                      : plan(n, numel - done, (int)sizeof(T));
  }
  return out;
}

// The direct walk's table: no more shards than it takes.
template <typename T>
using DirectPtrs = Ptrs<T, kDirectShards>;
template <typename T, typename P>
constexpr bool kDirect = std::is_same<P, DirectPtrs<T>>::value;

template <typename T, typename V, int R, typename P>
cudaError_t launch_walk(const P& p, const Plan& pl, int n, int64_t first,
                        cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(pl.tiles), pl.blocks);
  if constexpr (kDirect<T, P>) {
    direct_kernel<T, V, R, P>
        <<<grid, pl.warps * kLanes, 0, stream>>>(p, n, first, pl.lanes);
  } else {
    const size_t smem = (size_t)pl.ring * kLanes * sizeof(V);
    walk_kernel<T, V, R, P><<<grid, pl.warps * kLanes, smem, stream>>>(
        p, n, pl.ring, first, pl.lanes);
  }
  return cudaSuccess;
}

template <typename T, typename V, typename P>
cudaError_t launch_lane(const P& p, const Plan& pl, int n, int64_t first,
                        cudaStream_t stream) {
  if constexpr (kDirect<T, P>) {  // planned at R 2 only
    return launch_walk<T, V, 2>(p, pl, n, first, stream);
  } else {
    switch (pl.r) {
      case 16: return launch_walk<T, V, 16>(p, pl, n, first, stream);
      case 8: return launch_walk<T, V, 8>(p, pl, n, first, stream);
      case 4: return launch_walk<T, V, 4>(p, pl, n, first, stream);
      default: return launch_walk<T, V, 2>(p, pl, n, first, stream);
    }
  }
}

// The streaming ring of R 16 and four warps, the largest, fits the 48 KB a
// block takes without opting in (whole rings are planned under it).
static_assert(((ahead_chunks<16>() + 1) * chunk_rows<16>() +
               (kMaxWarps - 1) * 16) * kLanes * 16 <= kRingBytes,
              "the walk's ring past 48 KB");

template <typename T>
int64_t n_ctas(int64_t n_vec, int64_t numel) {
  const int64_t tail = numel - Group<T>::kElems * n_vec;
  const int64_t items = n_vec > tail ? n_vec : tail;
  const int64_t ctas = (items + kThreads - 1) / kThreads;
  return ctas > kMaxCtas ? kMaxCtas : ctas;
}

template <typename T, int N>
void launch(const T* const* x, T* const* out, int64_t n_vec, int64_t numel,
            cudaStream_t stream) {
  Ptrs<T, N> p;  // the first N entries: a small parameter block
  for (int i = 0; i < N; ++i) {
    p.x[i] = x[i];
    p.out[i] = out[i];
  }
  one_shot_kernel<T, N><<<static_cast<int>(n_ctas<T>(n_vec, numel)),
                          kThreads, 0, stream>>>(p, n_vec, numel);
}

// The walk with its pointer tables by value (the first n entries of a
// Ptrs of N shards): the main pass, then the tail.
template <typename T, int N>
cudaError_t launch_walk_ptrs(const T* const* x, T* const* out, int n,
                             const Plans& pl, cudaStream_t stream) {
  Ptrs<T, N> p;
  for (int i = 0; i < n; ++i) {
    p.x[i] = x[i];
    p.out[i] = out[i];
  }
  if (pl.main.tiles > 0x7fffffff || pl.tail.tiles > 0x7fffffff) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSuccess;
  switch (pl.main.bytes) {
    case 16: err = launch_lane<T, Lane<T, 4>>(p, pl.main, n, 0, stream); break;
    case 8: err = launch_lane<T, Lane<T, 2>>(p, pl.main, n, 0, stream); break;
    case 4: err = launch_lane<T, Lane<T, 1>>(p, pl.main, n, 0, stream); break;
    default: break;  // no element fills a lane: the tail takes them all
  }
  if (err != cudaSuccess || pl.tail.r == 0) return err;
  const int64_t first = pl.main.lanes * pl.main.bytes / (int64_t)sizeof(T);
  if constexpr (sizeof(T) == 4) {
    return launch_lane<T, Lane<T, 1>>(p, pl.tail, n, first, stream);
  } else {
    return launch_lane<T, T>(p, pl.tail, n, first, stream);
  }
}

// The largest power of two up to 16 that divides every pointer.
template <typename T>
int alignment(const T* const* x, T* const* out, int n) {
  uintptr_t bits = 16;
  for (int i = 0; i < n; ++i) {
    bits |= reinterpret_cast<uintptr_t>(x[i]) |
            reinterpret_cast<uintptr_t>(out[i]);
  }
  return static_cast<int>(bits & (~bits + 1));
}

template <typename T>
int run(const void* const* x_raw, void* const* out_raw, int n, int64_t numel,
        cudaStream_t s) {
  const T* const* x = reinterpret_cast<const T* const*>(x_raw);
  T* const* out = reinterpret_cast<T* const*>(out_raw);
  const int align = alignment(x, out, n);
  const int64_t n_vec = align >= 16 ? numel / Group<T>::kElems : 0;
  cudaError_t err = cudaSuccess;
  switch (n) {
    case 2: launch<T, 2>(x, out, n_vec, numel, s); break;
    case 3: launch<T, 3>(x, out, n_vec, numel, s); break;
    case 4: launch<T, 4>(x, out, n_vec, numel, s); break;
    case 5: launch<T, 5>(x, out, n_vec, numel, s); break;
    case 6: launch<T, 6>(x, out, n_vec, numel, s); break;
    case 7: launch<T, 7>(x, out, n_vec, numel, s); break;
    case 8: launch<T, 8>(x, out, n_vec, numel, s); break;
    default: {
      const Plans pl = plans<T>(n, numel, align);
      err = n <= kDirectShards
                ? launch_walk_ptrs<T, kDirectShards>(x, out, n, pl, s)
            : n <= kSmallTable
                ? launch_walk_ptrs<T, kSmallTable>(x, out, n, pl, s)
                : launch_walk_ptrs<T, kMaxShards>(x, out, n, pl, s);
      break;
    }
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream` for n shards (1 < n <= 1,816, kMaxShards):
// x and out are host arrays of n device pointers, all on the current
// device, contiguous partials of `numel` elements of `dtype` (0 fp32, 1
// bf16, 2 fp16; the Python wrapper checks). Returns cudaGetLastError()
// after the launch (0 = launched).
extern "C" int client_tpu_ring_all_reduce(const void* const* x,
                                          void* const* out, int n,
                                          int64_t numel, int dtype,
                                          void* stream) {
  if (n < 2 || n > kMaxShards || numel < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return run<float>(x, out, n, numel, s);
    case 1: return run<__nv_bfloat16>(x, out, n, numel, s);
    case 2: return run<__half>(x, out, n, numel, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The walk's plan for n > 8 shards of `numel` elements of `dtype` whose
// pointers are all `align`-byte aligned, as client_tpu_ring_all_reduce
// launches it: out[0..6] the main pass's lane bytes (0: none), R, warps,
// shard blocks, ring rows, 1 when every row is staged at once, and 1 when
// it stages (0: the direct walk); out[7..13] the tail pass's (R 0: none).
// Returns 0, or cudaErrorInvalidValue for n <= 8 (one launch of the
// unrolled kernel) or out of range.
extern "C" int client_tpu_ring_all_reduce_plan(int n, int64_t numel,
                                               int dtype, int align,
                                               int* out) {
  if (n <= 8 || n > kMaxShards || numel < 1 || dtype < 0 || dtype > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Plans pl = dtype == 0 ? plans<float>(n, numel, align)
                              : plans<__half>(n, numel, align);
  const Plan* both[2] = {&pl.main, &pl.tail};
  for (int i = 0; i < 2; ++i) {
    const Plan& q = *both[i];
    const int rows = n + q.warps * q.r - 1;
    const int fields[7] = {q.bytes, q.r, q.warps, q.blocks, q.ring,
                           q.r != 0 && q.ring >= rows,
                           q.r != 0 && q.ring > 0};
    for (int j = 0; j < 7; ++j) out[7 * i + j] = fields[j];
  }
  return 0;
}

extern "C" const char* client_tpu_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
