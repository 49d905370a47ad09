// Flash attention forward for Hopper (sm_90a), bf16 in, fp32 accumulate.
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

}  // namespace

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
