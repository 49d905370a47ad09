// All-reduce (sum) of n fp32 partials for Hopper (sm_90a), in the ring's
// order of additions.
//
// Replaces the Pallas TPU kernel `_ring_kernel` / `ring_all_reduce` in
// client_tpu/parallel/kv_shard.py:84. Same function and the same order of
// additions: shard i's result is ((x_i + x_{i-1}) + x_{i-2}) + ... + x_{i+1}
// (indices mod n), the order in which the TPU ring's n - 1 hops deliver
// the other shards' partials. Every shard gets the sum (the result is
// replicated); the Python wrapper's plain version repeats those hops step
// by step, so kernel and plain version agree bit for bit.
//
// Design: one-shot. On the TPU every device runs its own copy of the
// kernel and a start() + wait() per hop keeps the devices in lockstep,
// which suits a link that carries one neighbour's block at a time. Here
// every shard lives on one card, so one ordinary launch of a few small
// CTAs plays them all: each thread owns a few 16-byte groups of elements,
// loads them from all n partials once, and writes each shard's sum in that
// shard's own ring order. There is no barrier, no receive buffer and no
// cooperative launch. Elements that do not fill a 16-byte group, and every
// element when a pointer is not 16-byte aligned, take a scalar path.
//
// Shard counts: any n from 2 to 64 (a kv_shards or emb_shards that divides
// the rows). For n <= 8 the kernel is unrolled (one_shot_kernel<n>): each
// thread holds its group of every partial in registers. For a larger n
// the registers cannot hold them all, so staged_kernel stages them in
// shared memory: a CTA loads kStaged groups (16-byte groups, or single
// elements on the scalar path) of each of the n partials once, coalesced,
// into an [n][kStaged] tile (8 KB of float4s at n = 64), then each of
// its threads writes whole sums, one (shard, group) pair at a time, each
// a loop over the tile in that shard's ring order. Every element is read
// from memory once and every sum makes the same additions in the same
// order, so every sum is still the plain version's bit for bit. The n * n
// reads per group come from shared memory, where a warp reads 128
// contiguous bytes of each of 4 shards' rows. Small tiles (kStaged = 8)
// spread even the decode wave's [16, 4, 64] over 128 CTAs. The pointer
// tables go by value with the launch: 2 x n pointers for the unrolled
// kernels, 2 x 64 (1 KB, within a launch's 4 KB of parameters) for the
// staged one.
//
// What bounds it on an H100: it reads n * numel * 4 bytes and writes the
// same, and does (n - 1) * n * numel additions, so it is bound by bytes; at
// the decode wave's [16, 4, 64] fp32 (16 KB a shard) the time is that of
// one launch. The ring this replaced (one cooperative launch, a grid
// barrier per hop, a copy through receive slots per hop) paid n - 1
// barriers on top, for the same sums.
//
// Across cards the same loads would go through peer pointers over NVLink
// (queue item Q1.8); that is not built: the Python mesh (kv_mesh) raises
// NotImplementedError for distinct cards, so every pointer here is in one
// card's memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxShards = 64;
constexpr int kThreads = 128;
constexpr int kMaxCtas = 1024;
constexpr int kStaged = 8;  // groups of each partial a staged CTA holds

// The pointer tables a launch takes by value, sized for N shards.
template <int N>
struct Ptrs {
  const float* x[N];  // the partials, one per shard
  float* out[N];      // the replicated sums
};

// Shard i's sum of x[0..N) in ring order: x_i, then x_{i-1}, x_{i-2}, ...
template <int N>
__device__ __forceinline__ float ring_sum(const float (&x)[N], int i) {
  float s = x[i];
#pragma unroll
  for (int j = 1; j < N; ++j) s += x[(i - j + N) % N];
  return s;
}

template <int N>
__device__ __forceinline__ float4 ring_sum(const float4 (&x)[N], int i) {
  float4 s = x[i];
#pragma unroll
  for (int j = 1; j < N; ++j) {
    const float4 y = x[(i - j + N) % N];
    s.x += y.x;
    s.y += y.y;
    s.z += y.z;
    s.w += y.w;
  }
  return s;
}

// Elements [0, 4 * n_vec) in 16-byte groups, then [4 * n_vec, numel) one
// at a time; a grid-stride loop over each.
template <int N>
__global__ void __launch_bounds__(kThreads)
    one_shot_kernel(Ptrs<N> p, int64_t n_vec, int64_t numel) {
  const int64_t first = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t e = first; e < n_vec; e += stride) {
    float4 x[N];
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = reinterpret_cast<const float4*>(p.x[i])[e];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      reinterpret_cast<float4*>(p.out[i])[e] = ring_sum<N>(x, i);
    }
  }
  for (int64_t e = 4 * n_vec + first; e < numel; e += stride) {
    float x[N];
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = p.x[i][e];
#pragma unroll
    for (int i = 0; i < N; ++i) p.out[i][e] = ring_sum<N>(x, i);
  }
}

__device__ __forceinline__ void add_to(float4& s, const float4& y) {
  s.x += y.x;
  s.y += y.y;
  s.z += y.z;
  s.w += y.w;
}

__device__ __forceinline__ void add_to(float& s, const float& y) { s += y; }

// n > 8 shards: groups [0, count) of V (float4 or float) starting at
// element `first` of every partial. A CTA stages its kStaged groups of all
// n partials in shared memory, then writes the n sums of each, shard i's
// as x_i + x_{i-1} + ... in ring order.
template <typename V>
__global__ void __launch_bounds__(kThreads)
    staged_kernel(Ptrs<kMaxShards> p, int n, int64_t first, int64_t count) {
  extern __shared__ float4 smem[];  // float4: aligned for either V
  V* tile = reinterpret_cast<V*>(smem);  // [n][kStaged]
  const int64_t g0 = (int64_t)blockIdx.x * kStaged;
  const int groups = count - g0 < kStaged ? (int)(count - g0) : kStaged;
  for (int t = threadIdx.x; t < n * kStaged; t += kThreads) {
    const int src = t / kStaged, g = t % kStaged;
    if (g < groups) {
      tile[t] = reinterpret_cast<const V*>(p.x[src] + first)[g0 + g];
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < n * kStaged; t += kThreads) {
    const int i = t / kStaged, g = t % kStaged;
    if (g >= groups) continue;
    V s = tile[t];
    for (int j = 1; j < n; ++j) {
      add_to(s, tile[(i - j < 0 ? i - j + n : i - j) * kStaged + g]);
    }
    reinterpret_cast<V*>(p.out[i] + first)[g0 + g] = s;
  }
}

template <typename V>
void launch_staged(const Ptrs<kMaxShards>& p, int n, int64_t first,
                   int64_t count, cudaStream_t stream) {
  if (count == 0) return;
  staged_kernel<V><<<static_cast<int>((count + kStaged - 1) / kStaged),
                     kThreads, n * kStaged * sizeof(V), stream>>>(
      p, n, first, count);
}

int64_t n_ctas(int64_t n_vec, int64_t numel) {
  const int64_t items = n_vec > numel - 4 * n_vec ? n_vec : numel - 4 * n_vec;
  const int64_t ctas = (items + kThreads - 1) / kThreads;
  return ctas > kMaxCtas ? kMaxCtas : ctas;
}

template <int N>
void launch(const Ptrs<kMaxShards>& all, int64_t n_vec, int64_t numel,
            cudaStream_t stream) {
  Ptrs<N> p;  // the first N entries: a small parameter block
  for (int i = 0; i < N; ++i) {
    p.x[i] = all.x[i];
    p.out[i] = all.out[i];
  }
  one_shot_kernel<N><<<static_cast<int>(n_ctas(n_vec, numel)), kThreads, 0,
                       stream>>>(p, n_vec, numel);
}

}  // namespace

// Launch on `stream` for n shards (1 < n <= 64): x and out are arrays of n
// device pointers, all on the current device, contiguous fp32 (the Python
// wrapper checks). Returns cudaGetLastError() after the launch (0 =
// launched).
extern "C" int client_tpu_ring_all_reduce(const void* const* x,
                                          void* const* out, int n,
                                          int64_t numel, void* stream) {
  if (n < 2 || n > kMaxShards || numel < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Ptrs<kMaxShards> p;
  bool aligned = true;
  for (int i = 0; i < n; ++i) {
    p.x[i] = static_cast<const float*>(x[i]);
    p.out[i] = static_cast<float*>(out[i]);
    aligned = aligned && reinterpret_cast<uintptr_t>(x[i]) % 16 == 0 &&
              reinterpret_cast<uintptr_t>(out[i]) % 16 == 0;
  }
  const int64_t n_vec = aligned ? numel / 4 : 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 2: launch<2>(p, n_vec, numel, s); break;
    case 3: launch<3>(p, n_vec, numel, s); break;
    case 4: launch<4>(p, n_vec, numel, s); break;
    case 5: launch<5>(p, n_vec, numel, s); break;
    case 6: launch<6>(p, n_vec, numel, s); break;
    case 7: launch<7>(p, n_vec, numel, s); break;
    case 8: launch<8>(p, n_vec, numel, s); break;
    default:
      launch_staged<float4>(p, n, 0, n_vec, s);
      launch_staged<float>(p, n, 4 * n_vec, numel - 4 * n_vec, s);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* client_tpu_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
