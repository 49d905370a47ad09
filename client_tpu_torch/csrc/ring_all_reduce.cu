// Ring all-reduce (sum) of n fp32 partials for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_ring_kernel` / `ring_all_reduce` in
// client_tpu/parallel/kv_shard.py:84. Same function and the same order of
// additions: shard i's result is ((x_i + x_{i-1}) + x_{i-2}) + ... + x_{i+1}
// (indices mod n), because hop s delivers x_{i-1-s} from the left
// neighbour and it is added as it arrives. Every shard gets the sum (the
// result is replicated); the Python wrapper's plain version repeats these
// hops step by step, so kernel and plain version agree bit for bit.
//
// Design. On the TPU every device runs its own copy of the kernel and a
// start() + wait() per hop keeps the devices in lockstep. Here one
// cooperative launch plays all n shards: CTA group g is shard g and each of
// its CTAs owns a strided chunk of the vector. For hop s a CTA copies its
// current slot into the right neighbour's other slot (the only write to
// another shard's memory), then the whole grid meets at
// cooperative_groups' grid barrier, then each CTA adds the slot it received
// into its own output. One barrier per hop keeps the double buffer safe: a
// slot is rewritten two hops after it was last read, and every read of it
// lies before the barrier in between. Hop 0 sends x_g itself, so slot 0 is
// first written at hop 1. cudaLaunchCooperativeKernel refuses a grid that
// cannot be resident at once instead of hanging in the barrier; the CTAs
// per shard are capped so that it always fits.
//
// The pointers are device addresses (UVA). This build runs every shard on
// one card (the Python mesh refuses distinct cards), so all traffic stays
// in that card's memory and no system-scope fence is needed.
//
// What bounds it on an H100: it moves n * numel * 4 bytes in and the same
// out (plus (n - 1) slot copies that the L2 absorbs) and does
// (n - 1) * n * numel additions, so it is bound by bytes, and at the decode
// wave's [16, 4, 64] fp32 (16 KB per shard) by the launch and the n - 1
// grid barriers, not by either.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxShards = 8;
constexpr int kThreads = 256;

struct RingPtrs {
  const float* x[kMaxShards];  // the partials, one per shard
  float* out[kMaxShards];      // the replicated sums
  float* buf[kMaxShards];      // two receive slots of numel floats each
};

__global__ void __launch_bounds__(kThreads)
    ring_all_reduce_kernel(RingPtrs p, int n, int64_t numel, int ctas) {
  cg::grid_group grid = cg::this_grid();
  const int g = blockIdx.x / ctas;
  const int right = (g + 1) % n;
  const int64_t first = (int64_t)(blockIdx.x % ctas) * kThreads + threadIdx.x;
  const int64_t stride = (int64_t)ctas * kThreads;

  for (int64_t e = first; e < numel; e += stride) p.out[g][e] = p.x[g][e];
  for (int step = 0; step < n - 1; ++step) {
    const int src = step % 2, dst = (step + 1) % 2;
    const float* from = step == 0 ? p.x[g] : p.buf[g] + src * numel;
    float* to = p.buf[right] + dst * numel;
    for (int64_t e = first; e < numel; e += stride) to[e] = from[e];
    grid.sync();
    const float* got = p.buf[g] + dst * numel;
    for (int64_t e = first; e < numel; e += stride) p.out[g][e] += got[e];
  }
}

// Most CTAs that can be resident at once on `device` (cached per device).
int max_resident_ctas(int device) {
  static int cached[64] = {0};
  if (device < 0 || device >= 64) return 0;
  if (cached[device] == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                               device) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, ring_all_reduce_kernel, kThreads, 0) != cudaSuccess) {
      return 0;
    }
    cached[device] = sms * per_sm;
  }
  return cached[device];
}

}  // namespace

// Launch on `stream` for n shards (1 < n <= 8): x, out and buf are arrays
// of n device pointers (buf[i] holds 2 * numel floats), all on the current
// device, contiguous fp32 (the Python wrapper checks). Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int client_tpu_ring_all_reduce(const void* const* x,
                                          void* const* out,
                                          void* const* buf, int n,
                                          int64_t numel, void* stream) {
  if (n < 2 || n > kMaxShards || numel < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  RingPtrs p;
  for (int i = 0; i < n; ++i) {
    p.x[i] = static_cast<const float*>(x[i]);
    p.out[i] = static_cast<float*>(out[i]);
    p.buf[i] = static_cast<float*>(buf[i]);
  }
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int resident = max_resident_ctas(device);
  if (resident < n) {
    err = cudaGetLastError();
    return static_cast<int>(err != cudaSuccess
                                ? err
                                : cudaErrorCooperativeLaunchTooLarge);
  }
  const int64_t wanted = (numel + kThreads - 1) / kThreads;
  int ctas = static_cast<int>(wanted < resident / n ? wanted : resident / n);
  void* args[] = {&p, &n, &numel, &ctas};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(ring_all_reduce_kernel), dim3(n * ctas),
      dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

extern "C" const char* client_tpu_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
