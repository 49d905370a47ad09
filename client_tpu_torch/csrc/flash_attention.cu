// Flash attention forward for Hopper (sm_90a), bf16 in, fp32 accumulate;
// an fp32 instantiation (flash_fwd_f32_kernel) follows the bf16 one.
//
// Replaces the Pallas TPU kernel `_fa_kernel` / `flash_attention` in
// client_tpu/ops/flash_attention.py. Same function: tiled online-softmax
// attention over q/k/v laid out [B, S, H, D], an additive per-key fp32 bias
// [B, S] (or none) and an optional causal mask. Scores at or below -1e30
// get probability exactly 0, and a row whose denominator is 0 outputs 0,
// never NaN. P is rounded to bf16 before the P.V product, as the TPU
// kernel rounds it to v's dtype.
//
// Design. The Pallas grid carried the softmax state across key blocks in
// VMEM scratch, because a TPU grid runs in order on one core. Here blocks
// run in parallel, so one CTA owns one (batch, head, 64-row query tile) and
// loops over 64-key tiles itself, with the running max, denominator and
// output accumulator in fp32 registers. Four warps each own 16 query rows.
// Q.K^T and P.V are mma.sync m16n8k16 bf16 products; P never leaves
// registers (the score accumulator fragment is the A fragment of P.V).
// K/V tiles are double-buffered in shared memory with cp.async, so the next
// tile loads while this one computes. Rows are padded to 72 elements so
// fragment loads hit 32 distinct banks. q/k/v are read through their
// strides, so BERT's fused-QKV slices need no copy; the ragged last tile is
// masked (keys past S get bias -inf and zero-filled rows).
//
// What bounds it on an H100: at bert_long's shape (B=4, S=2048, H=12, D=64)
// one call does 4*B*H*S*S*D = 5.2e10 FLOP on 50 MB of input and output:
// about 1000 FLOP per byte, far above the card's ~295 bf16 FLOP/byte ridge,
// so it is bound by tensor-core operations, not memory. The design keeps
// the S x S scores out of device memory (O(S*D) traffic) and runs both
// products on the tensor cores; it uses mma.sync rather than wgmma/TMA,
// which a later change can add to approach the 989 TFLOP/s peak.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 64;   // query rows per CTA
constexpr int kBlockN = 64;   // keys per tile
constexpr int kHeadDim = 64;
constexpr int kWarps = 4;     // 16 query rows each
constexpr int kThreads = kWarps * 32;
constexpr int kRow = kHeadDim + 8;  // padded shared-memory row (144 bytes)
constexpr float kNegInf = -1e30f;   // the TPU kernel's mask value

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem,
                                            bool valid) {
  unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int src_bytes = valid ? 16 : 0;  // 0 -> the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One 64 x 64 bf16 tile, rows [row0, row0 + 64) of a [S, *] view with row
// stride `row_stride` elements; rows at or past `seq` are zero-filled.
__device__ __forceinline__ void load_tile(bf16 (*dst)[kRow], const bf16* base,
                                          int64_t row_stride, int row0,
                                          int seq, int tid) {
#pragma unroll
  for (int i = 0; i < (kBlockN * kHeadDim / 8) / kThreads; ++i) {
    int chunk = tid + i * kThreads;
    int r = chunk / (kHeadDim / 8);
    int col = (chunk % (kHeadDim / 8)) * 8;
    int row = row0 + r;
    bool valid = row < seq;
    const bf16* src = base + (int64_t)(valid ? row : 0) * row_stride + col;
    cp_async_16(&dst[r][col], src, valid);
  }
}

__device__ __forceinline__ uint32_t ld_b32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += a * b for one m16n8k16 tile: bf16 operands, fp32 accumulator.
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four transposed 8x8 bf16 matrices from shared memory: the B fragments of
// two n8 tiles of V for one 16-key step.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const bf16* smem) {
  unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const float* __restrict__ bias, bf16* __restrict__ o,
                     int seq, int64_t q_sb, int64_t q_ss, int64_t q_sh,
                     int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb,
                     int64_t v_ss, int64_t v_sh, int64_t o_sb, int64_t o_ss,
                     int64_t o_sh, int64_t bias_sb, float sm_scale,
                     int causal) {
  __shared__ __align__(16) bf16 sQ[kBlockM][kRow];
  __shared__ __align__(16) bf16 sK[2][kBlockN][kRow];
  __shared__ __align__(16) bf16 sV[2][kBlockN][kRow];
  __shared__ float sBias[2][kBlockN];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;  // fragment row group
  const int t = lane % 4;  // thread within the group
  const int q0 = blockIdx.x * kBlockM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const bf16* qb = q + b * q_sb + h * q_sh;
  const bf16* kb = k + b * k_sb + h * k_sh;
  const bf16* vb = v + b * v_sb + h * v_sh;
  const float* biasb = bias != nullptr ? bias + b * bias_sb : nullptr;

  int n_tiles = (seq + kBlockN - 1) / kBlockN;
  if (causal) {
    // Tiles wholly above the diagonal contribute nothing: skip them.
    n_tiles = min(n_tiles, (q0 + kBlockM - 1) / kBlockN + 1);
  }

  auto load_bias = [&](int buf, int key0) {
    if (tid < kBlockN) {
      int key = key0 + tid;
      float x = __int_as_float(0xff800000);  // -inf: past the sequence end
      if (key < seq) x = biasb != nullptr ? biasb[key] : 0.0f;
      sBias[buf][tid] = x;
    }
  };

  load_tile(sQ, qb, q_ss, q0, seq, tid);
  load_tile(sK[0], kb, k_ss, 0, seq, tid);
  load_tile(sV[0], vb, v_ss, 0, seq, tid);
  cp_async_commit();
  load_bias(0, 0);

  uint32_t qf[kHeadDim / 16][4];  // this warp's 16 query rows, as A fragments
  float acc[kHeadDim / 8][4];     // output accumulator, 8 n8 tiles over D
  float row_max[2] = {kNegInf, kNegInf};  // rows g and g + 8
  float row_sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < kHeadDim / 8; ++i) {
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;
  }

  const int qrow = q0 + warp * 16 + g;  // absolute query row of fragment row g

  for (int j = 0; j < n_tiles; ++j) {
    const int cur = j & 1;
    if (j + 1 < n_tiles) {
      load_tile(sK[cur ^ 1], kb, k_ss, (j + 1) * kBlockN, seq, tid);
      load_tile(sV[cur ^ 1], vb, v_ss, (j + 1) * kBlockN, seq, tid);
      cp_async_commit();
      load_bias(cur ^ 1, (j + 1) * kBlockN);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    if (j == 0) {
      const bf16* r0 = sQ[warp * 16 + g];
      const bf16* r8 = sQ[warp * 16 + g + 8];
#pragma unroll
      for (int kk = 0; kk < kHeadDim / 16; ++kk) {
        qf[kk][0] = ld_b32(r0 + kk * 16 + t * 2);
        qf[kk][1] = ld_b32(r8 + kk * 16 + t * 2);
        qf[kk][2] = ld_b32(r0 + kk * 16 + 8 + t * 2);
        qf[kk][3] = ld_b32(r8 + kk * 16 + 8 + t * 2);
      }
    }

    // S = Q K^T for 16 rows x 64 keys: 8 n8 tiles of fp32.
    float s[kBlockN / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.0f;
      const bf16* krow = sK[cur][nt * 8 + g];
#pragma unroll
      for (int kk = 0; kk < kHeadDim / 16; ++kk) {
        mma_bf16(s[nt], qf[kk], ld_b32(krow + kk * 16 + t * 2),
                 ld_b32(krow + kk * 16 + 8 + t * 2));
      }
    }

    // Scale, bias, causal mask; then the online-softmax update per row.
    const int key0 = j * kBlockN;
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int col = nt * 8 + t * 2 + (e & 1);
        float x = s[nt][e] * sm_scale + sBias[cur][col];
        if (causal && key0 + col > qrow + (e >> 1) * 8) x = kNegInf;
        s[nt][e] = x;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float m_cur = kNegInf;
#pragma unroll
      for (int nt = 0; nt < kBlockN / 8; ++nt) {
        m_cur = fmaxf(m_cur, fmaxf(s[nt][2 * r], s[nt][2 * r + 1]));
      }
      m_cur = quad_max(m_cur);
      const float m_prev = row_max[r];
      const float m_new = fmaxf(m_prev, m_cur);
      // Fully masked so far: exp(-inf - -inf) would be NaN.
      const float safe_m = m_new <= kNegInf ? 0.0f : m_new;
      const float corr = m_prev <= kNegInf ? 0.0f : __expf(m_prev - safe_m);
      float part = 0.0f;
#pragma unroll
      for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          float p = s[nt][e] <= kNegInf ? 0.0f : __expf(s[nt][e] - safe_m);
          s[nt][e] = p;
          part += p;
        }
      }
      row_sum[r] = row_sum[r] * corr + quad_sum(part);
      row_max[r] = m_new;
#pragma unroll
      for (int dt = 0; dt < kHeadDim / 8; ++dt) {
        acc[dt][2 * r] *= corr;
        acc[dt][2 * r + 1] *= corr;
      }
    }

    // O += P V. The fp32 score fragments of key tiles 2kc and 2kc+1 are,
    // rounded to bf16, the A fragment of the 16-key step kc.
    const int mat = lane / 8;  // which 8x8 matrix this lane addresses
    const int mrow = lane % 8;
#pragma unroll
    for (int kc = 0; kc < kBlockN / 16; ++kc) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
      pa[1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
      pa[2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      pa[3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
      for (int dp = 0; dp < kHeadDim / 16; ++dp) {
        uint32_t vb4[4];
        ldmatrix_x4_trans(
            vb4, &sV[cur][kc * 16 + (mat & 1) * 8 + mrow][dp * 16 + (mat >> 1) * 8]);
        mma_bf16(acc[2 * dp], pa, vb4[0], vb4[1]);
        mma_bf16(acc[2 * dp + 1], pa, vb4[2], vb4[3]);
      }
    }
    __syncthreads();  // this tile's buffers are refilled next iteration
  }

  bf16* ob = o + b * o_sb + h * o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qrow + r * 8;
    if (row >= seq) continue;
    const float denom = row_sum[r] == 0.0f ? 1.0f : row_sum[r];
    bf16* orow = ob + row * o_ss;
#pragma unroll
    for (int dt = 0; dt < kHeadDim / 8; ++dt) {
      *reinterpret_cast<uint32_t*>(orow + dt * 8 + t * 2) =
          pack_bf16(acc[dt][2 * r] / denom, acc[dt][2 * r + 1] / denom);
    }
  }
}

// ---------------------------------------------------------------------------
// The fp32 instantiation: fp32 q/k/v/o and fp32 accumulation, the same
// masking, guards and causal tile skip as above, with nothing rounded.
//
// Design. mma.sync has no fp32 form, and TF32 (m16n8k8) rounds inputs to
// 10 mantissa bits, which can flip greedy tokens of the fp32 generative
// models that run this path, so both products are SIMT FMAs. One CTA of
// 128 threads owns one (batch, head, 64-row query tile); thread (ty, tx)
// with ty in 0..15 and tx in 0..7 holds 4 query rows (ty*4..) x 4 keys
// (tx*4..) of each score tile and 4 rows x 8 dims (tx*8..) of the output.
// The 8 threads of one row group are neighbouring lanes, so row max and
// row sum are 3 shuffles. Q and K sit transposed in shared memory
// ([d][row]), so each step of Q.K^T reads one 16-byte vector of 4 rows and
// one of 4 keys for 16 FMAs; P goes through shared memory transposed
// ([key][row]) into P.V. expf, not __expf.
//
// Shared memory: fp32 64 x 64 K and V tiles, double-buffered, would need
// 64 KB, above the 48 KB static limit. This kernel shrinks the key tile to
// 32 and loads single-buffered instead of opting in to dynamic shared
// memory: Q^T 17,408 + K^T 9,216 + V 8,192 + P^T 8,704 + bias 128 =
// 43,648 bytes, static.
//
// What bounds it: at tiny_gpt_long's prefill (B=8, S=2048, H=4, D=64,
// causal) one call does 1.7e10 FLOP on 34 MB: about 500 FLOP per byte, so
// it is bound by the fp32 FMA rate (67 TFLOP/s outside the tensor cores),
// which a SIMT kernel without software pipelining does not approach.

namespace f32 {

constexpr int kBlockM = 64;   // query rows per CTA
constexpr int kBlockN = 32;   // keys per tile
constexpr int kThreads = 128;
constexpr int kPad = 4;       // keeps 16-byte rows and spreads banks

__device__ __forceinline__ float4 load4(const float* p, bool valid) {
  return valid ? *reinterpret_cast<const float4*>(p)
               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

__device__ __forceinline__ float group_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
}

__device__ __forceinline__ float group_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x + __shfl_xor_sync(0xffffffffu, x, 4);
}

__global__ void __launch_bounds__(kThreads)
    flash_fwd_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ bias,
                         float* __restrict__ o, int seq, int64_t q_sb,
                         int64_t q_ss, int64_t q_sh, int64_t k_sb,
                         int64_t k_ss, int64_t k_sh, int64_t v_sb,
                         int64_t v_ss, int64_t v_sh, int64_t o_sb,
                         int64_t o_ss, int64_t o_sh, int64_t bias_sb,
                         float sm_scale, int causal) {
  __shared__ __align__(16) float sQt[kHeadDim][kBlockM + kPad];
  __shared__ __align__(16) float sKt[kHeadDim][kBlockN + kPad];
  __shared__ __align__(16) float sV[kBlockN][kHeadDim];
  __shared__ __align__(16) float sPt[kBlockN][kBlockM + kPad];
  __shared__ float sBias[kBlockN];

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int tx = lane % 8;                  // key / dim group
  const int ty = (tid / 32) * 4 + lane / 8;  // row group, 0..15
  const int q0 = blockIdx.x * kBlockM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const float* qb = q + b * q_sb + h * q_sh;
  const float* kb = k + b * k_sb + h * k_sh;
  const float* vb = v + b * v_sb + h * v_sh;
  const float* biasb = bias != nullptr ? bias + b * bias_sb : nullptr;

  // Q tile, transposed; rows past the sequence are zero.
  for (int i = tid; i < kBlockM * (kHeadDim / 4); i += kThreads) {
    const int r = i % kBlockM;
    const int c = (i / kBlockM) * 4;
    const int row = q0 + r;
    const float4 x = load4(qb + (int64_t)(row < seq ? row : 0) * q_ss + c,
                           row < seq);
    sQt[c][r] = x.x;
    sQt[c + 1][r] = x.y;
    sQt[c + 2][r] = x.z;
    sQt[c + 3][r] = x.w;
  }

  int n_tiles = (seq + kBlockN - 1) / kBlockN;
  if (causal) {
    n_tiles = min(n_tiles, (q0 + kBlockM - 1) / kBlockN + 1);
  }

  float acc[4][8];
  float row_max[4], row_sum[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    row_max[i] = kNegInf;
    row_sum[i] = 0.0f;
#pragma unroll
    for (int d = 0; d < 8; ++d) acc[i][d] = 0.0f;
  }

  for (int j = 0; j < n_tiles; ++j) {
    const int key0 = j * kBlockN;
    __syncthreads();  // the previous tile is no longer read
    for (int i = tid; i < kBlockN * (kHeadDim / 4); i += kThreads) {
      const int r = i % kBlockN;  // K, transposed
      const int c = (i / kBlockN) * 4;
      const int key = key0 + r;
      const float4 x = load4(kb + (int64_t)(key < seq ? key : 0) * k_ss + c,
                             key < seq);
      sKt[c][r] = x.x;
      sKt[c + 1][r] = x.y;
      sKt[c + 2][r] = x.z;
      sKt[c + 3][r] = x.w;
      const int vr = i / (kHeadDim / 4);  // V, row-major
      const int vc = (i % (kHeadDim / 4)) * 4;
      const int vkey = key0 + vr;
      *reinterpret_cast<float4*>(&sV[vr][vc]) = load4(
          vb + (int64_t)(vkey < seq ? vkey : 0) * v_ss + vc, vkey < seq);
    }
    if (tid < kBlockN) {
      const int key = key0 + tid;
      float x = __int_as_float(0xff800000);  // -inf: past the sequence end
      if (key < seq) x = biasb != nullptr ? biasb[key] : 0.0f;
      sBias[tid] = x;
    }
    __syncthreads();

    // S = Q K^T: 4 rows x 4 keys per thread.
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.0f;
    }
#pragma unroll 8
    for (int d = 0; d < kHeadDim; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(&sQt[d][ty * 4]);
      const float4 kv = *reinterpret_cast<const float4*>(&sKt[d][tx * 4]);
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
      const float ka[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int c = 0; c < 4; ++c) s[i][c] = fmaf(qa[i], ka[c], s[i][c]);
      }
    }

    // Scale, bias, causal mask; the online-softmax update per row.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qrow = q0 + ty * 4 + i;
      float m_cur = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float x = s[i][c] * sm_scale + sBias[tx * 4 + c];
        if (causal && key0 + tx * 4 + c > qrow) x = kNegInf;
        s[i][c] = x;
        m_cur = fmaxf(m_cur, x);
      }
      m_cur = group_max(m_cur);
      const float m_prev = row_max[i];
      const float m_new = fmaxf(m_prev, m_cur);
      // Fully masked so far: exp(-inf - -inf) would be NaN.
      const float safe_m = m_new <= kNegInf ? 0.0f : m_new;
      const float corr = m_prev <= kNegInf ? 0.0f : expf(m_prev - safe_m);
      float part = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = s[i][c] <= kNegInf ? 0.0f : expf(s[i][c] - safe_m);
        s[i][c] = p;
        part += p;
      }
      row_sum[i] = row_sum[i] * corr + group_sum(part);
      row_max[i] = m_new;
#pragma unroll
      for (int d = 0; d < 8; ++d) acc[i][d] *= corr;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      *reinterpret_cast<float4*>(&sPt[tx * 4 + c][ty * 4]) =
          make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
    }
    __syncthreads();

    // O += P V: 4 rows x 8 dims per thread.
#pragma unroll 4
    for (int c = 0; c < kBlockN; ++c) {
      const float4 pv = *reinterpret_cast<const float4*>(&sPt[c][ty * 4]);
      const float4 v0 = *reinterpret_cast<const float4*>(&sV[c][tx * 8]);
      const float4 v1 = *reinterpret_cast<const float4*>(&sV[c][tx * 8 + 4]);
      const float pa[4] = {pv.x, pv.y, pv.z, pv.w};
      const float va[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int d = 0; d < 8; ++d) acc[i][d] = fmaf(pa[i], va[d], acc[i][d]);
      }
    }
  }

  float* ob = o + b * o_sb + h * o_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= seq) continue;
    const float denom = row_sum[i] == 0.0f ? 1.0f : row_sum[i];
    float* orow = ob + row * o_ss + tx * 8;
    *reinterpret_cast<float4*>(orow) =
        make_float4(acc[i][0] / denom, acc[i][1] / denom, acc[i][2] / denom,
                    acc[i][3] / denom);
    *reinterpret_cast<float4*>(orow + 4) =
        make_float4(acc[i][4] / denom, acc[i][5] / denom, acc[i][6] / denom,
                    acc[i][7] / denom);
  }
}

}  // namespace f32

}  // namespace

// Launch the fp32 instantiation; arguments and return as for the bf16 one
// below, with fp32 q/k/v/o whose rows are 16-byte aligned.
extern "C" int client_tpu_flash_attention_fwd_f32(
    const void* q, const void* k, const void* v, const void* bias, void* o,
    int batch, int seq, int heads, int64_t q_sb, int64_t q_ss, int64_t q_sh,
    int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss,
    int64_t v_sh, int64_t o_sb, int64_t o_ss, int64_t o_sh, int64_t bias_sb,
    float sm_scale, int causal, void* stream) {
  dim3 grid((seq + f32::kBlockM - 1) / f32::kBlockM, heads, batch);
  f32::flash_fwd_f32_kernel<<<grid, f32::kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(bias),
      static_cast<float*>(o), seq, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb,
      v_ss, v_sh, o_sb, o_ss, o_sh, bias_sb, sm_scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// Launch on `stream`; returns cudaGetLastError() (0 = launched). Strides are
// in elements; each of q/k/v/o has unit stride along D, and rows 16-byte
// aligned (the Python wrapper checks both). `bias` may be null.
extern "C" int client_tpu_flash_attention_fwd(
    const void* q, const void* k, const void* v, const void* bias, void* o,
    int batch, int seq, int heads, int64_t q_sb, int64_t q_ss, int64_t q_sh,
    int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss,
    int64_t v_sh, int64_t o_sb, int64_t o_ss, int64_t o_sh, int64_t bias_sb,
    float sm_scale, int causal, void* stream) {
  dim3 grid((seq + kBlockM - 1) / kBlockM, heads, batch);
  flash_fwd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(bias),
      static_cast<bf16*>(o), seq, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb,
      v_ss, v_sh, o_sb, o_ss, o_sh, bias_sb, sm_scale, causal);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* client_tpu_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
