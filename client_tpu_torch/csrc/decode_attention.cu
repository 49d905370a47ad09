// Fused decode wave for Hopper (sm_90a): KV scatter plus single-query
// attention over the KV arena, fp32 throughout.
//
// Replaces the Pallas TPU kernel `_decode_kernel` / `decode_wave_attention`
// in client_tpu/ops/decode_kernel.py. Same function, for one layer of one
// decode wave: lane b writes k_new[b] / v_new[b] ([H, D]) into
// arena[layer, rows[b], lens[b]] in place and returns the softmax
// attention of q[b] over positions 0 .. lens[b]: the old prefix (positions
// strictly below lens[b], read from the arena) plus the new token, folded
// in from registers, so the kernel never reads its own store. A lane with
// lens[b] == 0 attends to the new token alone and yields exactly v_new[b].
// The -1e30 guards are the TPU kernel's.
//
// Design. The Pallas grid walked (lane, key block) in order and carried
// the online softmax in VMEM scratch; it copied every visited arena block
// through VMEM because TPU output aliasing writes whole blocks. Here one
// CTA owns one (lane, head) and reads rows[b] / lens[b] from device memory
// itself (no scalar prefetch, no host sync). It stores only the one
// scattered slot, so rows the wave does not touch are never written. Its
// 256 threads form 32 groups of 8 lanes; a group takes one key at a time,
// each lane 8 of the 64 dims (two 16-byte loads of K and two of V), so a
// warp reads four neighbouring keys per step. Each group keeps its own
// online softmax (one expf per key: whichever of the score and the running
// max is larger gets the factor 1); the groups are merged through warp
// shuffles and then, across the 8 warps, in shared memory. expf, not
// __expf: greedy decoding is held token for token against the plain
// version, which needs full fp32 accuracy.
//
// What bounds it on an H100: per lane and layer it reads the valid prefix
// of K and V once (2 * lens * H * D * 4 bytes) and does ~4 FLOP per byte,
// far below the card's ridge, so it is bound by memory bandwidth. The
// design reads each prefix byte once and nothing past lens. It launches
// B * H CTAs (64 for 16 lanes of 4 heads), fewer than the 132 SMs: splitting
// the sequence across CTAs (flash-decoding) is the lever for a later
// change.
//
// Bounds. The Python wrapper checks on the host, before staging, that
// every rows value is in [0, R) and every lens value in [0, S). The kernel
// checks again and, for a bad lane, writes NaN to o and touches no arena
// memory. Padded lanes all point at the dummy row with lens == 0: they read
// nothing, and their concurrent stores to one junk slot race harmlessly,
// since no lane ever reads the dummy row.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHeadDim = 64;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroupLanes = 8;                        // lanes sharing one key
constexpr int kDims = kHeadDim / kGroupLanes;         // dims per lane
constexpr int kGroups = kThreads / kGroupLanes;       // keys per CTA step
constexpr int kGroupsPerWarp = 32 / kGroupLanes;
constexpr float kNegInf = -1e30f;                     // the TPU kernel's mask

__device__ __forceinline__ void load8(float dst[kDims], const float* src) {
  const float4 a = reinterpret_cast<const float4*>(src)[0];
  const float4 b = reinterpret_cast<const float4*>(src)[1];
  dst[0] = a.x; dst[1] = a.y; dst[2] = a.z; dst[3] = a.w;
  dst[4] = b.x; dst[5] = b.y; dst[6] = b.z; dst[7] = b.w;
}

__global__ void __launch_bounds__(kThreads)
    decode_wave_kernel(float* k_arena, float* v_arena,
                       const float* __restrict__ q,
                       const float* __restrict__ k_new,
                       const float* __restrict__ v_new,
                       const int* __restrict__ rows,
                       const int* __restrict__ lens, float* __restrict__ o,
                       int layer, int n_rows, int seq, int heads,
                       float sm_scale) {
  __shared__ float sM[kWarps];
  __shared__ float sL[kWarps];
  __shared__ float sAcc[kWarps][kHeadDim];
  __shared__ float sScoreNew;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int d0 = (lane % kGroupLanes) * kDims;

  const int64_t lane_off = ((int64_t)b * heads + h) * kHeadDim;
  float* ob = o + lane_off;
  const int row = rows[b];
  const int len = lens[b];
  if (row < 0 || row >= n_rows || len < 0 || len >= seq) {
    if (tid < kHeadDim) ob[tid] = __int_as_float(0x7fc00000);  // NaN
    return;
  }

  // [L, R, S, H, D], contiguous: one position of one head is 64 floats.
  const int64_t pos_stride = (int64_t)heads * kHeadDim;
  const int64_t row_off =
      ((int64_t)layer * n_rows + row) * seq * pos_stride + (int64_t)h * kHeadDim;
  const float* kb = k_arena + row_off;
  const float* vb = v_arena + row_off;

  // The scatter: the one slot (layer, row, len, h, :). Positions < len,
  // the only ones read below, are never written by this launch.
  if (tid < kHeadDim / 4) {
    reinterpret_cast<float4*>(k_arena + row_off + len * pos_stride)[tid] =
        reinterpret_cast<const float4*>(k_new + lane_off)[tid];
  } else if (tid < kHeadDim / 2) {
    reinterpret_cast<float4*>(v_arena + row_off + len * pos_stride)[tid - 16] =
        reinterpret_cast<const float4*>(v_new + lane_off)[tid - 16];
  }

  float qr[kDims];
  load8(qr, q + lane_off + d0);

  if (warp == 0) {  // the new token's score, q . k_new
    float s = q[lane_off + 2 * lane] * k_new[lane_off + 2 * lane] +
              q[lane_off + 2 * lane + 1] * k_new[lane_off + 2 * lane + 1];
#pragma unroll
    for (int off = 16; off > 0; off /= 2) {
      s += __shfl_xor_sync(0xffffffffu, s, off);
    }
    if (lane == 0) sScoreNew = s * sm_scale;
  }

  // The old prefix, positions < len. Every lane of a warp runs the same
  // iterations (the bound depends on the warp only), so the shuffles see
  // all 32 lanes; a lane past the prefix computes nothing.
  float m = kNegInf, l = 0.0f;
  float acc[kDims];
#pragma unroll
  for (int i = 0; i < kDims; ++i) acc[i] = 0.0f;
  for (int base = warp * kGroupsPerWarp; base < len; base += kGroups) {
    const int p = base + lane / kGroupLanes;
    const bool valid = p < len;
    float kr[kDims], vr[kDims];
    if (valid) {
      load8(kr, kb + p * pos_stride + d0);
      load8(vr, vb + p * pos_stride + d0);
    }
    float s = 0.0f;
    if (valid) {
#pragma unroll
      for (int i = 0; i < kDims; ++i) s = fmaf(qr[i], kr[i], s);
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    s += __shfl_xor_sync(0xffffffffu, s, 4);
    if (valid) {
      s *= sm_scale;
      float corr, p_s;
      if (s > m) {
        corr = expf(m - s);  // 0 while m is still the -1e30 start
        p_s = 1.0f;
        m = s;
      } else {
        corr = 1.0f;
        p_s = expf(s - m);
      }
      l = l * corr + p_s;
#pragma unroll
      for (int i = 0; i < kDims; ++i) acc[i] = fmaf(acc[i], corr, p_s * vr[i]);
    }
  }

  // Merge the warp's four groups (lanes 8 and 16 apart hold the same dims).
  float mw = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 8));
  mw = fmaxf(mw, __shfl_xor_sync(0xffffffffu, mw, 16));
  const float c = m <= kNegInf ? 0.0f : expf(m - mw);
  l *= c;
  l += __shfl_xor_sync(0xffffffffu, l, 8);
  l += __shfl_xor_sync(0xffffffffu, l, 16);
#pragma unroll
  for (int i = 0; i < kDims; ++i) {
    float a = acc[i] * c;
    a += __shfl_xor_sync(0xffffffffu, a, 8);
    a += __shfl_xor_sync(0xffffffffu, a, 16);
    acc[i] = a;
  }
  if (lane < kGroupLanes) {
#pragma unroll
    for (int i = 0; i < kDims; ++i) sAcc[warp][d0 + i] = acc[i];
  }
  if (lane == 0) {
    sM[warp] = mw;
    sL[warp] = l;
  }
  __syncthreads();

  // Merge the warps, then fold in the new token (position len, value
  // k_new / v_new): it is always attended, so the denominator is > 0.
  if (tid < kHeadDim) {
    float mm = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, sM[w]);
    float ll = 0.0f, aa = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float cw = sM[w] <= kNegInf ? 0.0f : expf(sM[w] - mm);
      ll = fmaf(sL[w], cw, ll);
      aa = fmaf(sAcc[w][tid], cw, aa);
    }
    const float s_new = sScoreNew;
    const float m_fin = fmaxf(mm, s_new);
    const float p_new = expf(s_new - m_fin);
    const float corr = mm <= kNegInf ? 0.0f : expf(mm - m_fin);
    const float l_fin = ll * corr + p_new;
    const float a_fin = aa * corr + p_new * v_new[lane_off + tid];
    ob[tid] = a_fin / l_fin;
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 = launched). The arena
// is [L, R, S, H, 64] fp32, q / k_new / v_new / o [B, H, 64] fp32, rows and
// lens [B] int32, all contiguous on the card (the Python wrapper checks).
extern "C" int client_tpu_decode_wave_fwd(
    void* k_arena, void* v_arena, const void* q, const void* k_new,
    const void* v_new, const void* rows, const void* lens, void* o,
    int batch, int heads, int layer, int n_rows, int seq, float sm_scale,
    void* stream) {
  dim3 grid(heads, batch);
  decode_wave_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(k_arena), static_cast<float*>(v_arena),
      static_cast<const float*>(q), static_cast<const float*>(k_new),
      static_cast<const float*>(v_new), static_cast<const int*>(rows),
      static_cast<const int*>(lens), static_cast<float*>(o), layer, n_rows,
      seq, heads, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* client_tpu_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
