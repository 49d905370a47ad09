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
// positions, each filled by two TMA boxes (the arena seen as a 3-D
// (d, H, L * R * S) fp32 tensor, a box of 32 positions of one head from
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
// Head dim. The template's D is instantiated at 8, 16, 32, 64, 128 and
// 256 and the launch takes the real head dim d <= D at run time: any d
// from 1 to 256 runs the smallest instantiation that holds it (the served
// GPTs: tiny_gpt and tiny_gpt_long at 64; tiny_gpt_mc and moe_gpt_mc at
// 32; the dry run's tp8 tiny GPT at 8 and its ep x tp MoE GPT at 16; a GPT
// at Cerebras-GPT-1.3B's widths at 128). The arena is updated in place and
// can be large, so nothing is padded by a copy: the TMA view of the arena
// is 3-D, (d, H, L * R * S), with a box of D columns, so below the
// instantiation's head dim TMA fills the columns past d with zeros in
// shared memory; q is zero-padded in registers, so the padded columns add
// nothing to q.k and give zero accumulators that are never stored; the
// scatter, the fold of the new token and the output touch d columns only.
// TMA needs d * 4 bytes to be a multiple of 16; for any other d the tiles
// are filled with ordinary loads by every thread (zeros past d and past
// the share's end), one tile at a time, and every per-lane load and store
// is an element's. At the instantiation's own head dim the kernel is
// compiled a second time with d known (kExact): its checks fold away, and
// it is the code of a kernel built for that head dim alone, so the head
// dims served before keep their speed. D fixes the
// shared-memory tiles, the lanes of a key group, the float4s each lane
// holds, the TMA box and the DSMEM partials. A key group is min(8, D / 4)
// lanes, each holding float4s 4 * lanes apart, so a key's row is read
// whole by its group: at D >= 32 8 lanes and 256 / 8 = 32-key tiles (one
// float4 a lane at 32, 2 at 64, 4 at 128, 8 at 256), at D = 16 4 lanes and
// 64-key tiles, at D = 8 2 lanes and 128-key tiles. A stage of K and V is
// 8 KB at D = 8, 16 and 32, 16 KB at 64, 32 KB at 128 and 64 KB at 256;
// the DSMEM partials are at most 8 x (D + 2) floats. The TMA box's inner
// extent is D * 4 bytes (32 at D = 8), above TMA's 16-byte minimum, and a
// share is whole tiles of the head dim's size, so the split plan (whose
// 256-key shares are a multiple of every tile) covers a short row the same
// way: ranks past the row's end take no tile. The new token's float4s for
// the scatter sit in warps 1 and up (2 * D / 4 of them, up to 4 warps at
// 256), its score in the next warp.

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
// Lanes sharing one key, and keys of a tile (one per group).
template <int kHeadDim>
constexpr int kGroupLanes = kHeadDim >= 32 ? 8 : kHeadDim / 4;
template <int kHeadDim>
constexpr int kTileKeys = kThreads / kGroupLanes<kHeadDim>;
constexpr int kStages = 2;
constexpr int kMaxSplit = 8;                     // the portable cluster size
constexpr float kNegInf = -1e30f;                // the TPU kernel's mask

template <int kHeadDim>
struct Smem {  // at a 128-byte boundary, as TMA's destination needs
  float k[kStages][kTileKeys<kHeadDim>][kHeadDim];
  float v[kStages][kTileKeys<kHeadDim>][kHeadDim];
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

// One box of the arena's 3-D (d, H, position) tensor map at head `h` and
// position `pos`, into `dst`; completion is counted on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int h, int pos) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(0),
      "r"(h), "r"(pos)
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

// `d`: the head dim the arena and the lanes hold (<= kHeadDim; the
// arena's columns past d load as zeros). `vec`: d is a multiple of 4 and
// every pointer 16-byte aligned, so the tiles come by TMA and the lanes'
// loads and stores are float4s; else ordinary loads fill the tiles and
// every per-lane access is an element's. kExact: d is kHeadDim and vec
// holds, known at compile time (d_arg and vec_arg are then not read), so
// that path compiles to the code of a kernel built for that one head dim.
template <int kHeadDim, bool kExact>
__global__ void __launch_bounds__(kThreads)
    decode_wave_kernel(const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       float* k_arena, float* v_arena,
                       const float* __restrict__ q,
                       const float* __restrict__ k_new,
                       const float* __restrict__ v_new,
                       const int* __restrict__ rows,
                       const int* __restrict__ lens, float* __restrict__ o,
                       int layer, int n_rows, int seq, int heads, int d_arg,
                       int vec_arg, float sm_scale) {
  constexpr int kLanes = kGroupLanes<kHeadDim>;
  constexpr int kTile = kTileKeys<kHeadDim>;
  constexpr int kSpan = 4 * kLanes;        // dims a group covers per float4
  constexpr int kVecs = kHeadDim / kSpan;  // float4s a lane holds of a key
  constexpr int kVec4s = kHeadDim / 4;     // float4s of one position, at most
  // Dims of q . k_new a lane of the score warp sums (lanes past d idle).
  constexpr int kDots = kHeadDim >= 32 ? kHeadDim / 32 : 1;
  // The score warp: the first after the scatter's (warps 1 and up).
  constexpr int kScoreWarp = 1 + (2 * kVec4s + 31) / 32;
  static_assert(kScoreWarp < kWarps, "no warp left for the score");
  const int d = kExact ? kHeadDim : d_arg;
  const bool vec = kExact || vec_arg != 0;
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
  const int group = tid / kLanes;
  // Dims kSpan * j + d0 .. kSpan * j + d0 + 3 for j < kVecs.
  const int d0 = (tid % kLanes) * 4;
  const int nv4 = d / 4;  // float4s of one position (vec only)
  const int si = tid - 32;  // the scatter's float4 (vec only)

  const int64_t lane_off = ((int64_t)b * heads + h) * d;
  float* ob = o + lane_off;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&sm.full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // Loads that do not depend on the lane's row are issued before it is
  // known, so their latency overlaps that of rows[b] and lens[b]. Rank 0
  // also takes the new token: with vec, thread 32 + i holds float4 i of
  // k_new (i < d / 4) or of v_new (d / 4 <= i < d / 2) for the scatter;
  // each lane of the score warp kDots dims of q and of k_new for the score
  // (lanes past d none), and thread e < d v_new[e] for the fold. q is
  // zero past d.
  float4 qv[kVecs];
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const int e = kSpan * j + d0;
    const float* qe = q + lane_off + e;
    if (vec) {
      qv[j] = e < d ? *reinterpret_cast<const float4*>(qe)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      qv[j] = make_float4(e < d ? qe[0] : 0.f, e + 1 < d ? qe[1] : 0.f,
                          e + 2 < d ? qe[2] : 0.f, e + 3 < d ? qe[3] : 0.f);
    }
  }
  float4 slot = make_float4(0.f, 0.f, 0.f, 0.f);
  float score_new = 0.0f, v_fold = 0.0f;
  if (rank == 0) {
    if (vec && si >= 0 && si < 2 * nv4) {
      slot = reinterpret_cast<const float4*>(
          si < nv4 ? k_new + lane_off : v_new + lane_off)[si % nv4];
    } else if (warp == kScoreWarp) {
      const int64_t e0 = lane_off + kDots * lane;
#pragma unroll
      for (int j = 0; j < kDots; ++j) {
        if (kDots * lane + j < d) score_new += q[e0 + j] * k_new[e0 + j];
      }
    }
    if (tid < d) v_fold = v_new[lane_off + tid];
  }
  const int row = rows[b];
  const int len = lens[b];
  if (row < 0 || row >= n_rows || len < 0 || len >= seq) {
    // Every CTA of the cluster sees the same lane, so all return here and
    // none waits at a cluster barrier.
    if (rank == 0 && tid < d) ob[tid] = __int_as_float(0x7fc00000);
    return;
  }

  // This CTA's share of the old prefix [0, len): whole tiles, so that only
  // a lane's last share ends inside a tile and the TMA boxes fetch few
  // positions past it.
  const int chunk = ((len + n_split - 1) / n_split + kTile - 1) / kTile * kTile;
  const int start = min(len, rank * chunk);
  const int end = min(len, start + chunk);
  const int n_tiles = (end - start + kTile - 1) / kTile;

  // Thread 0 fills stage t % kStages with tile t: one TMA box of kTile
  // positions of this head from K and one from V (rows past the share are
  // read but never used; columns past d arrive as zeros).
  const int64_t row_pos = ((int64_t)layer * n_rows + row) * seq;
  const int pos0 = static_cast<int>(row_pos) + start;
  auto issue = [&](int t) {
    const int s = t % kStages;
    mbar_arrive_expect_tx(&sm.full[s], 2u * kTile * kHeadDim * 4);
    tma_load(sm.k[s], &tm_k, &sm.full[s], h, pos0 + t * kTile);
    tma_load(sm.v[s], &tm_v, &sm.full[s], h, pos0 + t * kTile);
  };
  if (vec && tid == 0) {
    for (int t = 0; t < min(kStages, n_tiles); ++t) issue(t);
  }

  if (rank == 0) {
    // The scatter: the one slot (layer, row, len, h, :d) of K and of V.
    // Positions < len, the only ones used, are never written by this
    // launch.
    const int64_t slot_off = ((row_pos + len) * heads + h) * d;
    if (vec) {
      if (si >= 0 && si < 2 * nv4) {
        float* arena = si < nv4 ? k_arena : v_arena;
        reinterpret_cast<float4*>(arena + slot_off)[si % nv4] = slot;
      }
    } else {
      for (int e = tid; e < 2 * d; e += kThreads) {
        const int c = e < d ? e : e - d;
        (e < d ? k_arena : v_arena)[slot_off + c] =
            (e < d ? k_new : v_new)[lane_off + c];
      }
    }
    if (warp == kScoreWarp) {  // the new token's score, q . k_new
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
    if (vec) {
      mbar_wait(&sm.full[s], (t / kStages) & 1);
    } else {
      // Every thread fills the stage with ordinary loads: zeros past d
      // and past the share's end.
      for (int i = tid; i < kTile * kHeadDim; i += kThreads) {
        const int key = i / kHeadDim;
        const int col = i % kHeadDim;
        const int p = start + t * kTile + key;
        float kx = 0.0f, vx = 0.0f;
        if (col < d && p < end) {
          const int64_t off = ((row_pos + p) * heads + h) * d + col;
          kx = k_arena[off];
          vx = v_arena[off];
        }
        sm.k[s][key][col] = kx;
        sm.v[s][key][col] = vx;
      }
      __syncthreads();
    }
    // A group past the share's last key reads nothing and computes nothing:
    // its stage row holds positions at or past the share's end.
    const bool valid = group < min(kTile, end - start - t * kTile);
    float score = 0.0f;
    float4 vv[kVecs];
    if (valid) {
      const float* kr = sm.k[s][group];
      const float* vr = sm.v[s][group];
      float4 kv[kVecs];
#pragma unroll
      for (int j = 0; j < kVecs; ++j) {
        kv[j] = *reinterpret_cast<const float4*>(kr + kSpan * j + d0);
      }
      score = dot<kVecs>(qv, kv);
#pragma unroll
      for (int j = 0; j < kVecs; ++j) {
        vv[j] = *reinterpret_cast<const float4*>(vr + kSpan * j + d0);
      }
    }
#pragma unroll
    for (int off = 1; off < kLanes; off *= 2) {
      score += __shfl_xor_sync(0xffffffffu, score, off);
    }
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
    if (vec && tid == 0 && t + kStages < n_tiles) issue(t + kStages);
  }

  // Merge the warp's 32 / kLanes groups (lanes kLanes, 2 kLanes, ... 16
  // apart hold the same dims).
  float mw = m;
#pragma unroll
  for (int off = kLanes; off < 32; off *= 2) {
    mw = fmaxf(mw, __shfl_xor_sync(0xffffffffu, mw, off));
  }
  const float c = m <= kNegInf ? 0.0f : expf(m - mw);
  l *= c;
#pragma unroll
  for (int off = kLanes; off < 32; off *= 2) {
    l += __shfl_xor_sync(0xffffffffu, l, off);
  }
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    acc[j] = scale(acc[j], c);
#pragma unroll
    for (int off = kLanes; off < 32; off *= 2) acc[j] = shfl_add(acc[j], off);
  }
  if (lane < kLanes) {
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      store4(&sm.warp_acc[warp][kSpan * j + d0], acc[j]);
    }
  }
  if (lane == 0) {
    sm.warp_m[warp] = mw;
    sm.warp_l[warp] = l;
  }
  __syncthreads();

  // Merge the warps into this CTA's partial and store it into rank 0's
  // shared memory, once every CTA of the cluster has started.
  cluster_wait();
  if (tid < d) {
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
  if (tid < d) {
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
constexpr int kErrHeadDim = 100003;    // a head dim outside 1 .. 256

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

// The arena [L, R, S, H, d] fp32 (d * 4 a multiple of 16 bytes) as a 3-D
// (d, H, L * R * S) tensor for boxes of kHeadDim columns of one head by
// one tile's positions (32, 64 or 128), no swizzle; TMA fills the columns
// past d with zeros.
template <int kHeadDim>
bool encode_arena_map(CUtensorMap* map, const void* base, int64_t positions,
                      int heads, int d) {
  cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)heads,
                        (cuuint64_t)positions};
  cuuint64_t strides[2] = {(cuuint64_t)d * 4, (cuuint64_t)heads * d * 4};
  cuuint32_t box[3] = {kHeadDim, 1, kTileKeys<kHeadDim>};
  cuuint32_t elem_strides[3] = {1, 1, 1};
  return tensor_map_encoder()(
             map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(base),
             dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Opt the kernel in to its dynamic shared memory, once per device and
// instantiation (two threads may both do it; that is harmless).
template <int kHeadDim, bool kExact>
cudaError_t opt_in() {
  static std::atomic<bool> done[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev].load())) return err;
  err = cudaFuncSetAttribute(decode_wave_kernel<kHeadDim, kExact>,
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

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <int kHeadDim>
int launch(void* k_arena, void* v_arena, const void* q, const void* k_new,
           const void* v_new, const void* rows, const void* lens, void* o,
           int batch, int heads, int d, int n_layers, int layer, int n_rows,
           int seq, int n_split, float sm_scale, void* stream) {
  const int64_t positions = (int64_t)n_layers * n_rows * seq;
  if (positions > INT32_MAX) return kErrTensorMap;
  const int vec = d % 4 == 0 && aligned16(k_arena) && aligned16(v_arena) &&
                  aligned16(q) && aligned16(k_new) && aligned16(v_new) &&
                  aligned16(o);
  CUtensorMap tm_k = {}, tm_v = {};  // unused without vec
  if (vec) {
    if (tensor_map_encoder() == nullptr) return kErrNoEncoder;
    if (!encode_arena_map<kHeadDim>(&tm_k, k_arena, positions, heads, d) ||
        !encode_arena_map<kHeadDim>(&tm_v, v_arena, positions, heads, d)) {
      return kErrTensorMap;
    }
  }
  const bool exact = vec && d == kHeadDim;
  cudaError_t err = exact ? opt_in<kHeadDim, true>() : opt_in<kHeadDim, false>();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config<kHeadDim>(
      batch, heads, n_split, static_cast<cudaStream_t>(stream), &attr);
  err = cudaLaunchKernelEx(
      &cfg, exact ? decode_wave_kernel<kHeadDim, true>
                  : decode_wave_kernel<kHeadDim, false>, tm_k, tm_v,
      static_cast<float*>(k_arena), static_cast<float*>(v_arena),
      static_cast<const float*>(q), static_cast<const float*>(k_new),
      static_cast<const float*>(v_new), static_cast<const int*>(rows),
      static_cast<const int*>(lens), static_cast<float*>(o), layer, n_rows,
      seq, heads, d, vec, sm_scale);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

template <int kHeadDim>
int occupancy(int batch, int heads, int n_split, int* smem_bytes,
              int* max_clusters) {
  cudaError_t err = opt_in<kHeadDim, true>();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      launch_config<kHeadDim>(batch, heads, n_split, nullptr, &attr);
  *smem_bytes = kSmemBytes<kHeadDim>;
  return static_cast<int>(cudaOccupancyMaxActiveClusters(
      max_clusters, decode_wave_kernel<kHeadDim, true>, &cfg));
}

}  // namespace

// Launch on `stream` as B * H clusters of n_split CTAs; returns 0 when
// launched, else the runtime's error (a cluster size the card refuses
// included) or one of this file's codes (client_tpu_cuda_error_string
// names both; a head dim outside 1 .. 256 is one). head_dim d runs the
// smallest instantiation of 8, 16, 32, 64, 128 and 256 that holds it. The
// arena is [L, R, S, H, d] fp32 at a 16-byte aligned address with L * R *
// S < 2^31, q / k_new / v_new / o [B, H, d] fp32, rows and lens [B] int32,
// all contiguous on the card (the Python wrapper checks).
extern "C" int client_tpu_decode_wave_fwd(
    void* k_arena, void* v_arena, const void* q, const void* k_new,
    const void* v_new, const void* rows, const void* lens, void* o,
    int batch, int heads, int head_dim, int n_layers, int layer, int n_rows,
    int seq, int n_split, float sm_scale, void* stream) {
#define CLIENT_TPU_DECODE_ARGS                                               \
  k_arena, v_arena, q, k_new, v_new, rows, lens, o, batch, heads, head_dim,  \
      n_layers, layer, n_rows, seq, n_split, sm_scale, stream
  if (head_dim < 1 || head_dim > 256) return kErrHeadDim;
  if (head_dim <= 8) return launch<8>(CLIENT_TPU_DECODE_ARGS);
  if (head_dim <= 16) return launch<16>(CLIENT_TPU_DECODE_ARGS);
  if (head_dim <= 32) return launch<32>(CLIENT_TPU_DECODE_ARGS);
  if (head_dim <= 64) return launch<64>(CLIENT_TPU_DECODE_ARGS);
  if (head_dim <= 128) return launch<128>(CLIENT_TPU_DECODE_ARGS);
  return launch<256>(CLIENT_TPU_DECODE_ARGS);
#undef CLIENT_TPU_DECODE_ARGS
}

// For reports: the kernel's dynamic shared memory per CTA, and how many
// clusters of n_split CTAs the current device holds at once, for the
// instantiation that runs head dim `head_dim`.
extern "C" int client_tpu_decode_wave_occupancy(int batch, int heads,
                                                int n_split, int head_dim,
                                                int* smem_bytes,
                                                int* max_clusters) {
  if (head_dim < 1 || head_dim > 256) return kErrHeadDim;
  if (head_dim <= 8) {
    return occupancy<8>(batch, heads, n_split, smem_bytes, max_clusters);
  }
  if (head_dim <= 16) {
    return occupancy<16>(batch, heads, n_split, smem_bytes, max_clusters);
  }
  if (head_dim <= 32) {
    return occupancy<32>(batch, heads, n_split, smem_bytes, max_clusters);
  }
  if (head_dim <= 64) {
    return occupancy<64>(batch, heads, n_split, smem_bytes, max_clusters);
  }
  if (head_dim <= 128) {
    return occupancy<128>(batch, heads, n_split, smem_bytes, max_clusters);
  }
  return occupancy<256>(batch, heads, n_split, smem_bytes, max_clusters);
}

extern "C" const char* client_tpu_cuda_error_string(int code) {
  if (code == kErrNoEncoder) {
    return "the CUDA driver has no cuTensorMapEncodeTiled (TMA needs CUDA 12)";
  }
  if (code == kErrTensorMap) {
    return "cuTensorMapEncodeTiled refused a KV arena tensor map";
  }
  if (code == kErrHeadDim) {
    return "the decode kernel takes head dims 1 to 256";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
