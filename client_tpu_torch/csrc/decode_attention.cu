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
// What bounds it on an H100: per lane and layer it reads the valid prefix
// of K and V once (2 * lens * H * D * 4 bytes) and does ~1 FLOP per byte,
// far below the card's ridge, so it is bound by memory bandwidth: at a
// 16-lane wave of tiny_gpt_long (one lane at 2047 positions) 16 MB, about
// 5 us at 3.35 TB/s. Reaching that needs many bytes in flight on every SM
// (about 3.35 TB/s x 0.7 us of latency, 2.3 MB across the card), and
// enough CTAs that the longest lane does not run alone.
//
// Design: split-KV (flash-decoding) over a thread-block cluster. The
// Pallas grid walked (lane, key block) in order and carried the online
// softmax in VMEM scratch. Here the grid is (n_split, H, B) with clusters
// of (n_split, 1, 1): the n_split CTAs of one (lane, head) form a cluster,
// and CTA r takes the r-th share of positions [0, lens[b]), in whole
// 32-key tiles. The host picks n_split per wave from the lanes' lengths
// (at most 8, the portable cluster size: the kernel is never opted in to
// more, so the runtime refuses a larger cluster; ops/decode_attention.py
// `split_plan`), so the longest share stays near 256 keys. Each CTA
// streams its share through a ring of kStages shared-memory tiles of 32
// positions, each filled by two TMA boxes (the arena seen as a 2-D
// [L * R * S, H * D] fp32 tensor, a box of 32 positions of one head from
// K and one from V, 16 KB at D = 64) that complete on the stage's
// mbarrier; thread 0 issues them, with no registers held for the copies.
// Its 256 threads form 32 groups of 8 lanes, one key of the tile per
// group, each lane D / 8 of the D dims (D / 32 16-byte shared loads: the
// 8 lanes of a group read one 128-byte stretch of the key's row at a time,
// conflict free); each group keeps
// its own online softmax (one expf per key: whichever of the score and the
// running max is larger gets the factor 1). Groups merge through warp
// shuffles, warps through shared memory, and every CTA stores its partial
// (m, l, acc[D]) into rank 0's shared memory over distributed shared
// memory, behind a cluster barrier that says every CTA has started. After
// a second barrier rank 0 merges the partials in rank order (so the result
// does not depend on timing), folds in the new token (score q . k_new,
// value v_new), and writes o; the other CTAs exit without waiting. One
// launch, no global scratch. expf, not __expf: greedy decoding is held
// token for token against the plain version, which needs full fp32
// accuracy.
//
// Bounds and races. The Python wrapper checks on the host, before staging,
// that every rows value is in [0, R) and every lens value in [0, S). The
// kernel checks again and, for a bad lane, writes NaN to o and touches no
// arena memory. Rank 0 alone stores the one scattered slot (layer, row,
// lens[b]), so rows the wave does not touch are never written. A box that
// runs past its CTA's share reads later positions of the row (the new slot
// among them, perhaps while it is being stored), the next row, or TMA's
// zeros past the tensor's end: a group whose key lies past the share
// computes nothing from its stage row, so no such value reaches o. Padded
// lanes all point at the dummy row with lens == 0: they read nothing, and
// their concurrent stores to one junk slot race harmlessly, since no lane
// ever reads the dummy row.
//
// Head dim. D is a template parameter, instantiated for 32 and 64 (the
// served GPTs' head dims: tiny_gpt and tiny_gpt_long at 64; tiny_gpt_mc
// and moe_gpt_mc at 32); the entry point refuses any other. D fixes the
// shared-memory tiles, the float4s each lane holds (D / 32), the TMA box
// and the DSMEM partials; the 8-lane key groups and the 32-key tiles stay,
// so at D = 32 a stage is 8 KB and each lane reads one float4 of a key.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroupLanes = 8;                   // lanes sharing one key
constexpr int kTileKeys = kThreads / kGroupLanes;  // one key per group
constexpr int kStages = 2;
constexpr int kMaxSplit = 8;                     // the portable cluster size
constexpr float kNegInf = -1e30f;                // the TPU kernel's mask

template <int kHeadDim>
struct Smem {  // at a 128-byte boundary, as TMA's destination needs
  float k[kStages][kTileKeys][kHeadDim];
  float v[kStages][kTileKeys][kHeadDim];
  float warp_acc[kWarps][kHeadDim];
  float warp_m[kWarps];
  float warp_l[kWarps];
  // Rank 0's: every CTA's partial, stored there over DSMEM.
  float part_acc[kMaxSplit][kHeadDim];
  float part_m[kMaxSplit];
  float part_l[kMaxSplit];
  float score_new;
  uint64_t full[kStages];
};
template <int kHeadDim>
constexpr int kSmemBytes = sizeof(Smem<kHeadDim>) + 128;  // + room to align

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 2-D tensor map, at column `col` and row `row`, into `dst`;
// completion is counted on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col),
      "r"(row)
      : "memory");
}

// The cluster barrier in two halves: every thread of every CTA of the
// cluster arrives (release: its earlier stores are visible to the
// cluster), and a thread that waits (acquire) returns once all have.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// q . k over a lane's kVecs float4s, accumulated in dim order.
template <int kVecs>
__device__ __forceinline__ float dot(const float4 (&q)[kVecs],
                                     const float4 (&k)[kVecs]) {
  float s = q[0].x * k[0].x;
  s = fmaf(q[0].y, k[0].y, s);
  s = fmaf(q[0].z, k[0].z, s);
  s = fmaf(q[0].w, k[0].w, s);
#pragma unroll
  for (int j = 1; j < kVecs; ++j) {
    s = fmaf(q[j].x, k[j].x, s);
    s = fmaf(q[j].y, k[j].y, s);
    s = fmaf(q[j].z, k[j].z, s);
    s = fmaf(q[j].w, k[j].w, s);
  }
  return s;
}

__device__ __forceinline__ float4 scale_add(float4 acc, float c, float p,
                                            float4 v) {
  return make_float4(fmaf(acc.x, c, p * v.x), fmaf(acc.y, c, p * v.y),
                     fmaf(acc.z, c, p * v.z), fmaf(acc.w, c, p * v.w));
}

__device__ __forceinline__ float4 shfl_add(float4 a, int off) {
  a.x += __shfl_xor_sync(0xffffffffu, a.x, off);
  a.y += __shfl_xor_sync(0xffffffffu, a.y, off);
  a.z += __shfl_xor_sync(0xffffffffu, a.z, off);
  a.w += __shfl_xor_sync(0xffffffffu, a.w, off);
  return a;
}

__device__ __forceinline__ float4 scale(float4 a, float c) {
  return make_float4(a.x * c, a.y * c, a.z * c, a.w * c);
}

__device__ __forceinline__ void store4(float* dst, float4 a) {
  dst[0] = a.x; dst[1] = a.y; dst[2] = a.z; dst[3] = a.w;
}

template <int kHeadDim>
__global__ void __launch_bounds__(kThreads)
    decode_wave_kernel(const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       float* k_arena, float* v_arena,
                       const float* __restrict__ q,
                       const float* __restrict__ k_new,
                       const float* __restrict__ v_new,
                       const int* __restrict__ rows,
                       const int* __restrict__ lens, float* __restrict__ o,
                       int layer, int n_rows, int seq, int heads,
                       float sm_scale) {
  constexpr int kVecs = kHeadDim / 32;  // float4s a lane holds of a key
  constexpr int kVec4s = kHeadDim / 4;  // float4s of one position
  constexpr uint32_t kRowBytes = kHeadDim * 4;  // one position of one head
  extern __shared__ unsigned char smem_raw[];
  Smem<kHeadDim>& sm = *reinterpret_cast<Smem<kHeadDim>*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t(127));
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int n_split = static_cast<int>(cluster.num_blocks());

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int group = tid / kGroupLanes;
  // Dims 32 * j + d0 .. 32 * j + d0 + 3 for j < kVecs.
  const int d0 = (tid % kGroupLanes) * 4;

  const int64_t lane_off = ((int64_t)b * heads + h) * kHeadDim;
  float* ob = o + lane_off;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&sm.full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // Loads that do not depend on the lane's row are issued before it is
  // known, so their latency overlaps that of rows[b] and lens[b]. Rank 0
  // also takes the new token: thread 32 + i holds float4 i of k_new (i <
  // D / 4) or of v_new (D / 4 <= i < D / 2) for the scatter, warp 2 D / 32
  // dims of q and of k_new for the score, and thread d < D v_new[d] for
  // the fold.
  float4 qv[kVecs];
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    qv[j] = *reinterpret_cast<const float4*>(q + lane_off + 32 * j + d0);
  }
  float4 slot = make_float4(0.f, 0.f, 0.f, 0.f);
  float score_new = 0.0f, v_fold = 0.0f;
  if (rank == 0) {
    if (warp == 1) {
      if (lane < 2 * kVec4s) {
        slot = reinterpret_cast<const float4*>(
            lane < kVec4s ? k_new + lane_off : v_new + lane_off)[lane % kVec4s];
      }
    } else if (warp == 2) {
      const int64_t e0 = lane_off + kVecs * lane;
      score_new = q[e0] * k_new[e0];
#pragma unroll
      for (int j = 1; j < kVecs; ++j) score_new += q[e0 + j] * k_new[e0 + j];
    }
    if (tid < kHeadDim) v_fold = v_new[lane_off + tid];
  }
  const int row = rows[b];
  const int len = lens[b];
  if (row < 0 || row >= n_rows || len < 0 || len >= seq) {
    // Every CTA of the cluster sees the same lane, so all return here and
    // none waits at a cluster barrier.
    if (rank == 0 && tid < kHeadDim) ob[tid] = __int_as_float(0x7fc00000);
    return;
  }

  // This CTA's share of the old prefix [0, len): whole tiles, so that only
  // a lane's last share ends inside a tile and the TMA boxes fetch few
  // positions past it.
  const int chunk =
      ((len + n_split - 1) / n_split + kTileKeys - 1) / kTileKeys * kTileKeys;
  const int start = min(len, rank * chunk);
  const int end = min(len, start + chunk);
  const int n_tiles = (end - start + kTileKeys - 1) / kTileKeys;

  // Thread 0 fills stage t % kStages with tile t: one TMA box of 32
  // positions of this head from K and one from V (rows past the share are
  // read but never used).
  const int pos0 = (layer * n_rows + row) * seq + start;
  auto issue = [&](int t) {
    const int s = t % kStages;
    mbar_arrive_expect_tx(&sm.full[s], 2u * kTileKeys * kRowBytes);
    tma_load(sm.k[s], &tm_k, &sm.full[s], h * kHeadDim, pos0 + t * kTileKeys);
    tma_load(sm.v[s], &tm_v, &sm.full[s], h * kHeadDim, pos0 + t * kTileKeys);
  };
  if (tid == 0) {
    for (int t = 0; t < min(kStages, n_tiles); ++t) issue(t);
  }

  if (rank == 0) {
    if (warp == 1 && lane < 2 * kVec4s) {
      // The scatter: the one slot (layer, row, len, h, :) of K (lanes 0 to
      // D / 4 - 1) and of V. Positions < len, the only ones used, are
      // never written by this launch.
      float* arena = lane < kVec4s ? k_arena : v_arena;
      const int64_t slot_off =
          (((int64_t)layer * n_rows + row) * seq + len) * heads * kHeadDim +
          (int64_t)h * kHeadDim;
      reinterpret_cast<float4*>(arena + slot_off)[lane % kVec4s] = slot;
    } else if (warp == 2) {  // the new token's score, q . k_new
#pragma unroll
      for (int off = 16; off > 0; off /= 2) {
        score_new += __shfl_xor_sync(0xffffffffu, score_new, off);
      }
      if (lane == 0) sm.score_new = score_new * sm_scale;
    }
  }
  __syncthreads();  // the mbarriers are initialised before anyone waits
  // Phase 0 of the cluster barrier: this CTA has started. It is waited for
  // only before the first store into rank 0's shared memory.
  cluster_arrive_relaxed();

  float m = kNegInf, l = 0.0f;
  float4 acc[kVecs];
#pragma unroll
  for (int j = 0; j < kVecs; ++j) acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    mbar_wait(&sm.full[s], (t / kStages) & 1);
    // A group past the share's last key reads nothing and computes nothing:
    // its stage row holds positions at or past the share's end.
    const bool valid = group < min(kTileKeys, end - start - t * kTileKeys);
    float score = 0.0f;
    float4 vv[kVecs];
    if (valid) {
      const float* kr = sm.k[s][group];
      const float* vr = sm.v[s][group];
      float4 kv[kVecs];
#pragma unroll
      for (int j = 0; j < kVecs; ++j) {
        kv[j] = *reinterpret_cast<const float4*>(kr + 32 * j + d0);
      }
      score = dot<kVecs>(qv, kv);
#pragma unroll
      for (int j = 0; j < kVecs; ++j) {
        vv[j] = *reinterpret_cast<const float4*>(vr + 32 * j + d0);
      }
    }
    score += __shfl_xor_sync(0xffffffffu, score, 1);
    score += __shfl_xor_sync(0xffffffffu, score, 2);
    score += __shfl_xor_sync(0xffffffffu, score, 4);
    if (valid) {
      score *= sm_scale;
      float corr, p;
      if (score > m) {
        corr = expf(m - score);  // 0 while m is still the -1e30 start
        p = 1.0f;
        m = score;
      } else {
        corr = 1.0f;
        p = expf(score - m);
      }
      l = l * corr + p;
#pragma unroll
      for (int j = 0; j < kVecs; ++j) acc[j] = scale_add(acc[j], corr, p, vv[j]);
    }
    __syncthreads();  // every thread is done with stage s
    if (tid == 0 && t + kStages < n_tiles) issue(t + kStages);
  }

  // Merge the warp's four groups (lanes 8 and 16 apart hold the same dims).
  float mw = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 8));
  mw = fmaxf(mw, __shfl_xor_sync(0xffffffffu, mw, 16));
  const float c = m <= kNegInf ? 0.0f : expf(m - mw);
  l *= c;
  l += __shfl_xor_sync(0xffffffffu, l, 8);
  l += __shfl_xor_sync(0xffffffffu, l, 16);
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    acc[j] = shfl_add(shfl_add(scale(acc[j], c), 8), 16);
  }
  if (lane < kGroupLanes) {
#pragma unroll
    for (int j = 0; j < kVecs; ++j) store4(&sm.warp_acc[warp][32 * j + d0], acc[j]);
  }
  if (lane == 0) {
    sm.warp_m[warp] = mw;
    sm.warp_l[warp] = l;
  }
  __syncthreads();

  // Merge the warps into this CTA's partial and store it into rank 0's
  // shared memory, once every CTA of the cluster has started.
  cluster_wait();
  if (tid < kHeadDim) {
    float mm = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, sm.warp_m[w]);
    float ll = 0.0f, aa = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float cw = sm.warp_m[w] <= kNegInf ? 0.0f : expf(sm.warp_m[w] - mm);
      ll = fmaf(sm.warp_l[w], cw, ll);
      aa = fmaf(sm.warp_acc[w][tid], cw, aa);
    }
    Smem<kHeadDim>* root = cluster.map_shared_rank(&sm, 0);
    root->part_acc[rank][tid] = aa;
    if (tid == 0) {
      root->part_m[rank] = mm;
      root->part_l[rank] = ll;
    }
  }
  // Phase 1: every partial is stored. The peers are done and exit; rank 0,
  // whose shared memory they wrote, waits for them.
  cluster_arrive();
  if (rank != 0) return;
  cluster_wait();

  // Rank 0 merges the cluster's partials in rank order, then folds in the
  // new token (position len, value k_new / v_new): it is always attended,
  // so the denominator is > 0.
  if (tid < kHeadDim) {
    float mm = kNegInf;
    for (int r = 0; r < n_split; ++r) mm = fmaxf(mm, sm.part_m[r]);
    float ll = 0.0f, aa = 0.0f;
    for (int r = 0; r < n_split; ++r) {
      const float cr = sm.part_m[r] <= kNegInf ? 0.0f : expf(sm.part_m[r] - mm);
      ll = fmaf(sm.part_l[r], cr, ll);
      aa = fmaf(sm.part_acc[r][tid], cr, aa);
    }
    const float s_new = sm.score_new;
    const float m_fin = fmaxf(mm, s_new);
    const float p_new = expf(s_new - m_fin);
    const float corr = mm <= kNegInf ? 0.0f : expf(mm - m_fin);
    const float l_fin = ll * corr + p_new;
    const float a_fin = aa * corr + p_new * v_fold;
    ob[tid] = a_fin / l_fin;
  }
}

// Error codes of this file beyond cudaError_t's range.
constexpr int kErrNoEncoder = 100001;  // no cuTensorMapEncodeTiled
constexpr int kErrTensorMap = 100002;  // it refused a tensor map
constexpr int kErrHeadDim = 100003;    // a head dim not instantiated

PFN_cuTensorMapEncodeTiled tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled fn = []() -> PFN_cuTensorMapEncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess) {
      return nullptr;
    }
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled>(p);
  }();
  return fn;
}

// The arena [L, R, S, H, D] fp32 as a 2-D [L * R * S, H * D] tensor,
// boxes of 32 positions of one head, no swizzle.
template <int kHeadDim>
bool encode_arena_map(CUtensorMap* map, const void* base, int64_t positions,
                      int heads) {
  cuuint64_t dims[2] = {(cuuint64_t)heads * kHeadDim, (cuuint64_t)positions};
  cuuint64_t strides[1] = {(cuuint64_t)heads * kHeadDim * 4};
  cuuint32_t box[2] = {kHeadDim, kTileKeys};
  cuuint32_t elem_strides[2] = {1, 1};
  return tensor_map_encoder()(
             map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(base),
             dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Opt the kernel in to its dynamic shared memory, once per device and head
// dim (two threads may both do it; that is harmless).
template <int kHeadDim>
cudaError_t opt_in() {
  static std::atomic<bool> done[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev].load())) return err;
  err = cudaFuncSetAttribute(decode_wave_kernel<kHeadDim>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes<kHeadDim>);
  if (err == cudaSuccess && dev < 64) done[dev].store(true);
  return err;
}

// The launch: B * H clusters of n_split CTAs along x. `attr` outlives it.
template <int kHeadDim>
cudaLaunchConfig_t launch_config(int batch, int heads, int n_split,
                                 cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_split, heads, batch);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmemBytes<kHeadDim>;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = n_split;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int kHeadDim>
int launch(void* k_arena, void* v_arena, const void* q, const void* k_new,
           const void* v_new, const void* rows, const void* lens, void* o,
           int batch, int heads, int n_layers, int layer, int n_rows, int seq,
           int n_split, float sm_scale, void* stream) {
  if (tensor_map_encoder() == nullptr) return kErrNoEncoder;
  const int64_t positions = (int64_t)n_layers * n_rows * seq;
  CUtensorMap tm_k, tm_v;
  if (positions > INT32_MAX ||
      !encode_arena_map<kHeadDim>(&tm_k, k_arena, positions, heads) ||
      !encode_arena_map<kHeadDim>(&tm_v, v_arena, positions, heads)) {
    return kErrTensorMap;
  }
  cudaError_t err = opt_in<kHeadDim>();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config<kHeadDim>(
      batch, heads, n_split, static_cast<cudaStream_t>(stream), &attr);
  err = cudaLaunchKernelEx(
      &cfg, decode_wave_kernel<kHeadDim>, tm_k, tm_v,
      static_cast<float*>(k_arena), static_cast<float*>(v_arena),
      static_cast<const float*>(q), static_cast<const float*>(k_new),
      static_cast<const float*>(v_new), static_cast<const int*>(rows),
      static_cast<const int*>(lens), static_cast<float*>(o), layer, n_rows,
      seq, heads, sm_scale);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

template <int kHeadDim>
int occupancy(int batch, int heads, int n_split, int* smem_bytes,
              int* max_clusters) {
  cudaError_t err = opt_in<kHeadDim>();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      launch_config<kHeadDim>(batch, heads, n_split, nullptr, &attr);
  *smem_bytes = kSmemBytes<kHeadDim>;
  return static_cast<int>(cudaOccupancyMaxActiveClusters(
      max_clusters, decode_wave_kernel<kHeadDim>, &cfg));
}

}  // namespace

// Launch on `stream` as B * H clusters of n_split CTAs; returns 0 when
// launched, else the runtime's error (a cluster size the card refuses
// included) or one of this file's codes (client_tpu_cuda_error_string
// names both; a head dim other than 32 or 64 is one). The arena is [L, R,
// S, H, D] fp32 at a 16-byte aligned address with L * R * S < 2^31, q /
// k_new / v_new / o [B, H, D] fp32, rows and lens [B] int32, all
// contiguous on the card (the Python wrapper checks).
extern "C" int client_tpu_decode_wave_fwd(
    void* k_arena, void* v_arena, const void* q, const void* k_new,
    const void* v_new, const void* rows, const void* lens, void* o,
    int batch, int heads, int head_dim, int n_layers, int layer, int n_rows,
    int seq, int n_split, float sm_scale, void* stream) {
  switch (head_dim) {
    case 32:
      return launch<32>(k_arena, v_arena, q, k_new, v_new, rows, lens, o,
                        batch, heads, n_layers, layer, n_rows, seq, n_split,
                        sm_scale, stream);
    case 64:
      return launch<64>(k_arena, v_arena, q, k_new, v_new, rows, lens, o,
                        batch, heads, n_layers, layer, n_rows, seq, n_split,
                        sm_scale, stream);
    default:
      return kErrHeadDim;
  }
}

// For reports: the kernel's dynamic shared memory per CTA, and how many
// clusters of n_split CTAs the current device holds at once.
extern "C" int client_tpu_decode_wave_occupancy(int batch, int heads,
                                                int n_split, int head_dim,
                                                int* smem_bytes,
                                                int* max_clusters) {
  switch (head_dim) {
    case 32:
      return occupancy<32>(batch, heads, n_split, smem_bytes, max_clusters);
    case 64:
      return occupancy<64>(batch, heads, n_split, smem_bytes, max_clusters);
    default:
      return kErrHeadDim;
  }
}

extern "C" const char* client_tpu_cuda_error_string(int code) {
  if (code == kErrNoEncoder) {
    return "the CUDA driver has no cuTensorMapEncodeTiled (TMA needs CUDA 12)";
  }
  if (code == kErrTensorMap) {
    return "cuTensorMapEncodeTiled refused a KV arena tensor map";
  }
  if (code == kErrHeadDim) {
    return "the decode kernel is built for head dims 32 and 64 only";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
