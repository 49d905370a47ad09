// Flash attention forward for Hopper (sm_90a): a bf16 kernel (the BERTs),
// the same kernel in fp16, and an fp32 kernel (the generative models'
// prefill), every head dim from 1 to 256.
//
// Both replace the Pallas TPU kernel `_fa_kernel` / `flash_attention` in
// client_tpu/ops/flash_attention.py, which reads the head dim from the
// shape. Same function: tiled online-softmax attention over q/k/v laid out
// [B, S, H, D], an additive per-key fp32 bias [B, S] (or none) and an
// optional causal mask. Scores at or below -1e30 get probability exactly 0,
// and a row whose denominator is 0 outputs 0, never NaN. In bf16 and fp16,
// P is rounded to that type before the P.V product, as the TPU kernel
// rounds it to v's dtype.
//
// The Pallas grid carried the softmax state across key blocks in VMEM
// scratch, because a TPU grid runs in order on one core. Here blocks run
// in parallel, so a CTA owns a (batch, head, query tile) at a time (the
// 2-byte kernel walks several, persistently) and loops over key tiles
// itself, with the running max, denominator and output accumulator in
// fp32 registers. Keys past S get bias -inf. Under the causal flag, key
// tiles wholly above the diagonal are skipped and only the tiles that
// cross the diagonal are masked element by element; the query tiles with
// the most key tiles (the last ones) start first and the light ones fill
// the tail.
//
// Head dims. The head dim is a template parameter of the kernels,
// instantiated at 32, 64, 128 and 256 (bf16 and fp16 also at 96). Any
// other D up to 256 runs the next
// larger instantiation with the head dim zero-padded inside the kernel:
// the loads fill the columns past D with zeros (TMA's out-of-bounds fill in
// bf16 and for fp32 Q above 64, zero-filled cp.async copies in fp32 to 64,
// the fp32 pre-pass's zeros for K and V above 64), the zeros add nothing
// to q.k, and the output columns past D are never stored. sm_scale is
// 1/sqrt(D) of the real D (the caller's). The loads need D times the
// element size and every stride to be multiples of 16 bytes; the Python
// wrapper makes one zero-padded copy of q/k/v where they are not.
//
// bf16 and fp16 kernel (flash_fwd_kernel<Config, T>, T = bf16 or __half:
// the same tiles, swizzles and registers, wgmma's .bf16 or .f16 operand
// type, and TMA maps of the one or the other; the bias is fp32 in both,
// cast by the Python wrapper where the caller's is not). What bounds it:
// at bert_long's shape (B=4, S=2048, H=12, D=64) one call does
// 4*B*H*S*S*D = 5.2e10 FLOP on 50 MB: about 1000 FLOP per byte, above the
// card's ~295 bf16 (and fp16) FLOP/byte ridge, so the bound is the tensor
// cores' 989 TFLOP/s, which only wgmma reaches; causal calls do half the
// pairs on the same bytes. At head dim 64 the softmax's exponentials (16 a
// clock on an SM's MUFU units) take about as long as the products, so the
// two have to overlap, and the instructions a tile issues count.
//
// Roles. A CTA of kConsumers + 1 warpgroups owns kBlockM = 64 * kConsumers
// query rows of one (batch, head) at a time. Each consumer warpgroup owns
// 64 of them; the last warpgroup is the producer, which gives its
// registers to the consumers (setmaxnreg) and of which three warps issue
// every load: warp 0 the K tiles and their kBlockN bias values (ordinary
// loads, stored times log2(e)), warp 1 the V tiles, warp 2 each consumer's
// 64 Q rows. Loads are TMA boxes of 4-D tensor maps over the strided [B,
// S, H, D] views (BERT's fused-QKV slices need no copy; rows past S and
// columns past D arrive as zeros). A tile is stored as D / kBoxCols column
// blocks, each one box of kBoxCols columns whose rows are one swizzle atom
// wide (128 bytes, 64 columns, with the 128-byte swizzle; 64 bytes, 32
// columns, with the 64-byte swizzle at head dims 32 and 96): the layout
// wgmma reads without bank conflicts. The warpgroup index is taken through
// a shuffle, so that the compiler sees it warp-uniform and keeps the
// descriptors and stage indices in uniform registers.
//
// Rings and barriers (mbarriers in shared memory). K (with its bias) and V
// have rings of their own, kKStages and kVStages deep, each stage with a
// full barrier (TMA's transaction bytes; K's also the 32 bias lanes) and
// an empty one (every consumer thread arrives). A consumer frees K's stage
// as soon as S of the tile is in its registers and the bias read, and V's
// once P.V of the tile is done, so the next tiles' loads are in flight
// while a tile is still being used. Each consumer's Q rows have a full and
// an empty barrier: a consumer frees its rows after the last S it computes
// from them, so the next unit's Q arrives during this unit's last P.V and
// stores.
//
// Products. S = Q.K^T is wgmma m64nNk16 (N = kBlockN) with both operands
// in shared memory, D / 16 k-steps that step through the column blocks.
// O += P.V is kBlockN / 16 wgmma m64nDk16, one a 16-key step over all D
// columns: P is the register A operand (the fp32 accumulator of a 16-key
// slice of S, packed pairwise to T x 2, is exactly the A fragment, so P
// never touches shared memory), and V, stored [key][d], is the MN-major B
// operand (transpose bit set) whose column blocks, kBlockN * kRowBytes
// bytes apart, the descriptor's leading byte offset joins. Within a
// consumer, S of tile j goes to the tensor cores together with P.V of tile
// j - 1, and the online softmax of tile j (in registers, two rows a
// thread, in the log2 domain so that each exponential is one ex2) starts
// while P.V of j - 1 is still in flight (ptxas places the wait for it
// before the exponentials; pinning them ahead of it bought nothing).
//
// Turns (FA3's ping-pong between two consumers from head dim 96; a round
// of three at head dim 64). Named barriers 1 to kConsumers (0 is
// __syncthreads), one per consumer, pass a turn around: a consumer waits
// on its own (bar.sync, 256 threads) before it issues its products of a
// tile and arrives on the next one's (bar.arrive) once they are issued, so
// the warpgroups' products go to the tensor cores in turn, one's softmax
// running while another's products do. Consumer 0 arrives on its own
// barrier once at the start to take the first turn, and takes the last
// consumer's last arrival at the end. A consumer takes one turn per key
// tile of the unit, also for the tiles it skips, so the turns stay in step
// across units. At head dim 32 three consumers run independently (taking
// turns there was not reliably faster); two ping-ponged consumers
// measured slower at 32 and 64.
//
// Causal calls. Each consumer stops at its own diagonal: key tiles wholly
// above its 64 rows are not computed (it waits for their stages and frees
// them, as another consumer may need them), and only the tiles that cross
// its own rows are masked element by element. A skipped tile would have
// added exactly nothing (its scores are all masked: the rescale factor is
// 1 and every p is 0), so every row's arithmetic, tile by tile in the same
// order, is that of a kernel that computes every tile. The producer
// loads up to the CTA's heaviest consumer's last tile. A causal call
// without a bias reads none: its scores are only scaled (the keys past S
// lie above every real row's diagonal, so the mask drops them).
//
// Schedule. The grid is persistent: min(units, SMs) CTAs, one an SM, for
// the call's units of (batch, head, kBlockM query rows), counted heaviest
// first (the last query tiles, with the most key tiles under the causal
// flag) and dealt to the CTAs in rounds of gridDim.x, each round in the
// other direction (CTA i takes unit i of round 0, the (G - 1 - i)th of
// round 1, and so on), which evens out the heavy and the light. Each role
// walks the same units in the same order, so the producer's loads for the
// next unit go out while the consumers finish this one. A causal call
// whose units fit one round (the served prefill's B1 S1024 H16: 128 units)
// is balanced instead: its 64-row blocks are dealt to the units heaviest
// first, consumer w's round in direction w & 1, so that the heaviest
// blocks share a CTA with the lightest and the longest CTA is not a whole
// heavy query tile's.
//
// Output. Each consumer normalises its rows and stores them from its
// accumulators, two T a thread per 8-column slice (4-byte stores; element
// stores where d_out is odd or o is not 4-byte aligned); columns past
// d_out and rows past S are not stored.
//
// The instantiations, per CTA (registers a consumer thread after
// setmaxnreg; the producer keeps 24; shared memory with the bias):
//   D    rows  keys/tile  K, V stages  consumers          registers  shared
//   32   192   128        4, 4         3, independent     160        78 KB
//   64   192   128        4, 4         3, taking turns    160        154 KB
//   96   128   128        4, 3         2, ping-pong       240        194 KB
//   128  128   128        3, 2         2, ping-pong       240        194 KB
//   256  128   64         3, 2         2, ping-pong       240        225 KB
// At 128, O 64 + S 64 + packed P 32 registers a thread; Q 32 KB and 32 KB
// a K or V stage (a fourth K stage would not fit the 227 KB, and two K
// with three V stages measured no faster). At 256, O 128 + S 32 + P 16; Q
// 64 KB and 32 KB a stage of 64 keys. 96 runs head dims 65 to 96.
//
// fp32 kernels. What bounds them: at tiny_gpt_long's prefill (B=8, S=2048,
// H=4, D=64, causal) one call does 1.7e10 FLOP on 34 MB; at the
// Cerebras-width GPT's head dim 128 (B8 S2048 H4) 3.4e10 on 67 MB.
// Computed in plain fp32 that is bound by the 67 TFLOP/s of SIMT FMAs; on
// the tensor cores through the 3xTF32 split below it takes three TF32
// products per product at 495 TFLOP/s (0.104 and 0.208 ms), the lesser.
// Plain TF32 (10 mantissa bits) can flip greedy tokens of the fp32
// generative models; the split keeps fp32 accuracy. Each fp32 operand x
// becomes big = rna_tf32(x) and small = rna_tf32(x - big), and each
// product is a_small*b_big + a_big*b_small + a_big*b_big (small*small,
// about 2^-22 relative, is dropped). The tensor cores' fp32 accumulation
// truncates, so each key tile's P.V starts from zero and joins the running
// output in one rounded fp32 add: the bias of truncation then does not
// grow with S. P needs no shuffle into an A fragment: a thread's S
// accumulator holds P(g, 2t) and P(g, 2t+1) of each 8-key slice, and the
// P.V product reads them as A columns t and t+4 with V's keys permuted to
// match (key 2t as B row t, key 2t+1 as B row t+4), which leaves the sum
// over keys unchanged. expf, not __expf. Two kernels:
//
// Head dims 32 and 64: flash_fwd_f32_kernel<D, 64>, on mma.sync m16n8k8
// tf32. A CTA of four warps owns 64 query rows (16 a warp). The Q tile
// sits in shared memory and each 8-wide step of it is split once for the
// key slices it meets. 64-key K and V tiles are double-buffered with
// cp.async in dynamic shared memory, rows padded to D + 4 floats so that
// every fragment load of Q and K (rows g, columns t) and of V (rows 2t and
// 2t+1, columns g) hits 32 distinct banks; 46 and 86 KB, two CTAs an SM at
// 64. Each of the three products is issued for all slices that share an A
// fragment before the next, so products into one accumulator are not back
// to back; P.V runs over 64 output columns at a time.
//
// Head dims 128 and 256 (any D from 65): flash_fwd_tf32_kernel<Config>,
// on wgmma m64nNk8 tf32 fed by TMA, after a pre-pass (split_kv_kernel).
// At these widths the mma.sync kernel held one CTA of four warps an SM
// (its tiles took 166 and 195 KB) at 255 registers a thread (spilling at
// 256), re-split every K and V tile in each warp, and reached only
// mma.sync's share of the tensor cores; only wgmma reaches their full
// rate. TF32 wgmma takes K-major operands only, which Q and K are and V,
// the B operand of P.V, is not. So the pre-pass, once a call, writes K's
// big and small halves [2, B, H, S_pad, D] and V's transposed [2, B, H,
// D, S_pad], the keys of each 8-key group in the permuted order above, to
// scratch the wrapper allocates: K and V are split once a call, not once a
// warp, and V^T is K-major (reading 2 x 4 and writing 4 x 4 bytes an
// element, 0.06 ms at B8 S2048 H4 D128). The kernel is the bf16 kernel's
// shape: a producer warp loads the Q tile once (raw fp32, 4-D tensor map
// over the strided view, zeros past D and S) and, into rings of stages
// guarded by full / empty mbarriers, kBlockN-key tiles of K's halves (D /
// 32 boxes of 32 columns, one 128-byte swizzle atom each) with the
// stage's bias (ordinary loads), and V^T's halves (one box of D rows by
// kBlockN keys); K's and V's rings are separate, so V's may be shallower.
// Each consumer warpgroup owns 64 query rows. It splits its Q rows once:
// each thread reads the elements of its own A fragments, writes the big
// half back in place and keeps the small half in registers (128) or in
// shared memory (256). S = Q K^T is D / 8 k-steps of three wgmma
// m64nNk8 (N = kBlockN) with B = K's halves and A = Q_big from shared
// memory or Q_small from registers; big x big accumulates in one
// register set, the two correction products in another, joined by one
// add (else every product would truncate at S's own scale: against
// float64 with x8 inputs one accumulator missed 2e-3 at D 256). The
// online softmax runs in registers (two rows a thread); P, split into big
// and small in registers, is the register A operand of P.V, kChunk = 64
// output columns at a time into a zeroed accumulator, with B = V^T's
// halves. Key tiles wholly above a warpgroup's diagonal are skipped (the
// warpgroup hands their stages on), only the tiles that cross it are
// masked, and query tiles run heaviest first. With two consumers, one's
// softmax overlaps the other's products. The output is stored from the
// accumulators as 8-byte pairs. The instantiations, per CTA:
//   D    rows  keys/stage  K,V stages  consumers  registers   shared  CTAs/SM
//   128  128   32          2, 2        2          240 (set-   199 KB  1
//                                                 maxnreg; producer 24)
//   256   64   16          2, 1        1          229 (ptxas) 231 KB  1
// At 128 Q's big half is 64 KB, each stage of K's halves 32 KB and of
// V^T's 32 KB; O 64 + Q_small 64 + S and its corrections 32 + P's halves
// 32 + one P.V chunk 32 registers. At 256 Q's halves take 128 KB, so one
// consumer of 64 rows and 16-key stages (K 2 x 32 KB, V^T 1 x 32 KB) are
// what fits 227 KB; one CTA an SM, as before, but its products are
// wgmma's and no thread spills. A third K stage at 128 would not fit.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;  // the TPU kernel's mask value
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxHeadDim = 256;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(0xff800000);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------------------------------------
// bf16: wgmma fed by TMA.

namespace sm90 {

// One instantiation: head dim, keys per tile, K and V stages, consumer
// warpgroups, their registers, and whether they take turns (see the
// header comment).
template <int D, int BlockN, int KStages, int VStages, int Consumers,
          int ConsumerRegs, bool Turns>
struct Config {
  static constexpr int kHeadDim = D;
  static constexpr int kBlockN = BlockN;
  static constexpr int kKStages = KStages;
  static constexpr int kVStages = VStages;
  static constexpr int kConsumers = Consumers;  // warpgroups of 64 rows
  static constexpr bool kTurns = Turns;
  static constexpr int kBlockM = Consumers * 64;  // query rows per CTA
  static constexpr int kThreads = (Consumers + 1) * 128;
  // Registers a thread after setmaxnreg: the producer warpgroup gives up
  // what the consumers take, within the SM's 65,536.
  static constexpr int kProducerRegs = 24;
  static constexpr int kConsumerRegs = ConsumerRegs;
  static_assert(128 * kProducerRegs + 128 * Consumers * ConsumerRegs <= 65536,
                "register split exceeds the SM");
  // A column block: one swizzle atom's width of the head dim (64
  // columns, 128 bytes; 32 columns, 64 bytes, at head dims 32 and 96).
  static constexpr int kBoxCols = D % 64 == 0 ? 64 : 32;
  static constexpr int kRowBytes = kBoxCols * 2;   // 64 or 128
  static constexpr int kColBlocks = D / kBoxCols;
  static_assert(kRowBytes == 64 || kRowBytes == 128, "swizzle width");
  static_assert(BlockN % 32 == 0 && BlockN <= 256, "key tile");
  static_assert(Consumers == 2 || Consumers == 3, "consumer warpgroups");
};

typedef Config<32, 128, 4, 4, 3, 160, false> Config32;
typedef Config<64, 128, 4, 4, 3, 160, true> Config64;
typedef Config<96, 128, 4, 3, 2, 240, true> Config96;
typedef Config<128, 128, 3, 2, 2, 240, true> Config128;
typedef Config<256, 64, 3, 2, 2, 240, true> Config256;

// T: bf16 or __half, the same bytes.
template <class C, typename T>
struct Smem {  // at a 1024-byte boundary, as the swizzle needs
  T q[C::kColBlocks][C::kBlockM * C::kBoxCols];
  T k[C::kKStages][C::kColBlocks][C::kBlockN * C::kBoxCols];
  T v[C::kVStages][C::kColBlocks][C::kBlockN * C::kBoxCols];
  float bias[C::kKStages][C::kBlockN];  // travels with K
  uint64_t q_full[C::kConsumers];
  uint64_t q_empty[C::kConsumers];
  uint64_t k_full[C::kKStages];
  uint64_t k_empty[C::kKStages];
  uint64_t v_full[C::kVStages];
  uint64_t v_empty[C::kVStages];
};
template <class C>
constexpr int kSmemBytes = sizeof(Smem<C, bf16>) + 1024;  // + room to align

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(
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

// One box of a 4-D tensor map, coordinates (d, s, h, b), into `dst`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int d, int s, int h,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(d), "r"(s),
      "r"(h), "r"(b)
      : "memory");
}

// Shared-memory matrix descriptor of a tile written by TMA with the 128-
// or 64-byte swizzle (kRowBytes): 8-row groups of kRowBytes-byte rows,
// 8 * kRowBytes apart (the stride byte offset). The leading byte offset is
// unused for K-major operands; for an MN-major one (V as P.V's B) it is
// the distance between its column blocks, each one swizzle atom wide along
// N, so that one product spans them all.
template <int kRowBytes>
__device__ __forceinline__ uint64_t smem_desc(const void* smem,
                                              uint32_t lead_bytes = 16) {
  const uint64_t addr = smem_u32(smem);
  constexpr uint64_t kStride = (8 * kRowBytes) >> 4;
  constexpr uint64_t kLayout = kRowBytes == 128 ? 1 : 2;  // 128B / 64B
  return ((addr & 0x3FFFF) >> 4) | (uint64_t(lead_bytes >> 4) << 16) |
         (kStride << 32) | (kLayout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous product that owns it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d[64 x N] (+)= A[64 x 16] * B[16 x N]: A and B K-major in shared
// memory, fp32 accumulator in registers (N / 2 a thread); bf16 operands,
// or fp16 with KF16.
template <int N, bool KF16>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a,
                                         uint64_t desc_b, int scale_d);

#define CLIENT_TPU_WGMMA_SS_128(KF16, TY)                                      \
template <>                                                                    \
__device__ __forceinline__ void wgmma_ss<128, KF16>(                           \
    float (&d)[64], uint64_t desc_a, uint64_t desc_b, int scale_d) {           \
  asm volatile(                                                                \
      "{\n"                                                                    \
      ".reg .pred p;\n"                                                        \
      "setp.ne.b32 p, %66, 0;\n"                                               \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"            \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, " \
      "%58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n"              \
      "}\n"                                                                    \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),            \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),            \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),       \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),       \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),       \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),       \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),       \
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),       \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),       \
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),       \
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),       \
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),       \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                     \
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));                               \
}
CLIENT_TPU_WGMMA_SS_128(false, "bf16")
CLIENT_TPU_WGMMA_SS_128(true, "f16")
#undef CLIENT_TPU_WGMMA_SS_128

#define CLIENT_TPU_WGMMA_SS_64(KF16, TY)                                       \
template <>                                                                    \
__device__ __forceinline__ void wgmma_ss<64, KF16>(                            \
    float (&d)[32], uint64_t desc_a, uint64_t desc_b, int scale_d) {           \
  asm volatile(                                                                \
      "{\n"                                                                    \
      ".reg .pred p;\n"                                                        \
      "setp.ne.b32 p, %34, 0;\n"                                               \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"             \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
      "%30, %31}, %32, %33, p, 1, 1, 0, 0;\n"                                  \
      "}\n"                                                                    \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),            \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),            \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),       \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),       \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),       \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),       \
        "+f"(d[30]), "+f"(d[31])                                               \
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));                               \
}
CLIENT_TPU_WGMMA_SS_64(false, "bf16")
CLIENT_TPU_WGMMA_SS_64(true, "f16")
#undef CLIENT_TPU_WGMMA_SS_64

// d[64 x N] += A[64 x 16] * B[16 x N]: A in registers (bf16x2 or, with
// KF16, f16x2 pairs in the accumulator's row layout), B MN-major in shared
// memory.
template <int N, bool KF16>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b);

#define CLIENT_TPU_WGMMA_RS_64(KF16, TY)                                       \
template <>                                                                    \
__device__ __forceinline__ void wgmma_rs<64, KF16>(                            \
    float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b) {                 \
  asm volatile(                                                                \
      "{\n"                                                                    \
      ".reg .pred p;\n"                                                        \
      "setp.ne.b32 p, %37, 0;\n"                                               \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"             \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
      "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"                    \
      "}\n"                                                                    \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),            \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),            \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),       \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),       \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),       \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),       \
        "+f"(d[30]), "+f"(d[31])                                               \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));      \
}
CLIENT_TPU_WGMMA_RS_64(false, "bf16")
CLIENT_TPU_WGMMA_RS_64(true, "f16")
#undef CLIENT_TPU_WGMMA_RS_64

#define CLIENT_TPU_WGMMA_RS_32(KF16, TY)                                  \
template <>                                                               \
__device__ __forceinline__ void wgmma_rs<32, KF16>(                       \
    float (&d)[16], const uint32_t (&a)[4], uint64_t desc_b) {            \
  asm volatile(                                                           \
      "{\n"                                                               \
      ".reg .pred p;\n"                                                   \
      "setp.ne.b32 p, %21, 0;\n"                                          \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " {"        \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n"                    \
      "}\n"                                                               \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),       \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),       \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),  \
        "+f"(d[15])                                                       \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1)); \
}
CLIENT_TPU_WGMMA_RS_32(false, "bf16")
CLIENT_TPU_WGMMA_RS_32(true, "f16")
#undef CLIENT_TPU_WGMMA_RS_32

#define CLIENT_TPU_WGMMA_RS_96(KF16, TY)                                       \
template <>                                                                    \
__device__ __forceinline__ void wgmma_rs<96, KF16>(                            \
    float (&d)[48], const uint32_t (&a)[4], uint64_t desc_b) {                 \
  asm volatile(                                                                \
      "{\n"                                                                    \
      ".reg .pred p;\n"                                                        \
      "setp.ne.b32 p, %53, 0;\n"                                               \
      "wgmma.mma_async.sync.aligned.m64n96k16.f32." TY "." TY " {"             \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"       \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"       \
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40,"       \
      "%41, %42, %43, %44, %45, %46, %47}, "                                   \
      "{%48, %49, %50, %51}, %52, p, 1, 1, 1;\n"                               \
      "}\n"                                                                    \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),            \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),            \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),       \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),       \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),       \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),       \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),       \
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),       \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),       \
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47])                                  \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));      \
}
CLIENT_TPU_WGMMA_RS_96(false, "bf16")
CLIENT_TPU_WGMMA_RS_96(true, "f16")
#undef CLIENT_TPU_WGMMA_RS_96

#define CLIENT_TPU_WGMMA_RS_128(KF16, TY)                                      \
template <>                                                                    \
__device__ __forceinline__ void wgmma_rs<128, KF16>(                           \
    float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b) {                 \
  asm volatile(                                                                \
      "{\n"                                                                    \
      ".reg .pred p;\n"                                                        \
      "setp.ne.b32 p, %69, 0;\n"                                               \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"            \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"       \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"       \
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40,"       \
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53,"       \
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "                    \
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"                               \
      "}\n"                                                                    \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),            \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),            \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),       \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),       \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),       \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),       \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),       \
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),       \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),       \
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),       \
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),       \
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),       \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                     \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));      \
}
CLIENT_TPU_WGMMA_RS_128(false, "bf16")
CLIENT_TPU_WGMMA_RS_128(true, "f16")
#undef CLIENT_TPU_WGMMA_RS_128

#define CLIENT_TPU_WGMMA_RS_256(KF16, TY)                                      \
template <>                                                                    \
__device__ __forceinline__ void wgmma_rs<256, KF16>(                           \
    float (&d)[128], const uint32_t (&a)[4], uint64_t desc_b) {                \
  asm volatile(                                                                \
      "{\n"                                                                    \
      ".reg .pred p;\n"                                                        \
      "setp.ne.b32 p, %133, 0;\n"                                              \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " {"            \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"       \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"       \
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40,"       \
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53,"       \
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66,"       \
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"       \
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92,"       \
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104,"       \
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114,"            \
      "%115, %116, %117, %118, %119, %120, %121, %122, %123, %124,"            \
      "%125, %126, %127}, "                                                    \
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n"                          \
      "}\n"                                                                    \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),            \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),            \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),       \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),       \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),       \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),       \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),       \
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),       \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),       \
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),       \
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),       \
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),       \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),       \
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),       \
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),       \
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),       \
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),       \
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),       \
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),       \
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),       \
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),                \
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),                \
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),                \
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),                \
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),                \
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),                \
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])                 \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));      \
}
CLIENT_TPU_WGMMA_RS_256(false, "bf16")
CLIENT_TPU_WGMMA_RS_256(true, "f16")
#undef CLIENT_TPU_WGMMA_RS_256

// 2^x in one MUFU op; 2^-inf and anything below 2^-126 give exactly 0.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two fp32 values rounded to T and packed as T x 2 (lo in the low half).
template <typename T>
__device__ __forceinline__ uint32_t pack(float lo, float hi);

template <>
__device__ __forceinline__ uint32_t pack<bf16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <>
__device__ __forceinline__ uint32_t pack<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Named barrier `id` (1 to 15; 0 is __syncthreads) of `count` threads:
// wait for it, or arrive on it without waiting.
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// The turns' barriers: consumer w waits on kTurnBar + w.
constexpr int kTurnBar = 1;

// The CTA's unit of round `round` (its round-th unit), or a value at or
// past `units` when it has no more: units are counted heaviest first and
// dealt in rounds of gridDim.x, each round in the other direction.
__device__ __forceinline__ int unit_of_round(int round) {
  const int g = gridDim.x;
  const int cta = static_cast<int>(blockIdx.x);
  return round * g + ((round & 1) ? g - 1 - cta : cta);
}

// One unit: a (batch, head) and its rank p among that head's query tiles
// (0 the heaviest); unit u is (u % (batch * heads), p = u / (batch *
// heads)).
struct Unit {
  int b, h, p;
};

__device__ __forceinline__ Unit unit_at(int u, int heads, int bh) {
  const int i = u % bh;
  return {i / heads, i % heads, u / bh};
}

// `d_out`: the caller's head dim, the output columns stored (<= D);
// `vec_out`: o's rows take 4-byte stores of two T (d_out even and o 4-byte
// aligned), else element stores. T: q's, k's, v's and o's element, bf16 or
// __half (fp16); P is rounded to T before P.V.
template <class C, typename T>
__global__ void __launch_bounds__(C::kThreads, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const float* __restrict__ bias, T* __restrict__ o,
                     int batch, int seq, int heads, int d_out, int64_t o_sb,
                     int64_t o_ss, int64_t o_sh, int64_t bias_sb,
                     float sm_scale, int causal, int vec_out) {
  constexpr int kHeadDim = C::kHeadDim;
  constexpr int kBlockN = C::kBlockN;
  constexpr int kBlockM = C::kBlockM;
  constexpr int kKStages = C::kKStages;
  constexpr int kVStages = C::kVStages;
  constexpr int kConsumers = C::kConsumers;
  constexpr int kBoxCols = C::kBoxCols;
  constexpr int kRowBytes = C::kRowBytes;
  constexpr int kColBlocks = C::kColBlocks;
  constexpr bool kF16 = std::is_same<T, __half>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<C, T>& sm = *reinterpret_cast<Smem<C, T>*>(
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));

  const int tid = threadIdx.x;
  // Warp-uniform as the compiler sees it (a shuffle from lane 0), so that
  // the descriptors and stage indices derived from it stay in uniform
  // registers.
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int bh = batch * heads;
  const int q_tiles = (seq + kBlockM - 1) / kBlockM;
  const int units = bh * q_tiles;
  const int seq_tiles = (seq + kBlockN - 1) / kBlockN;
  // A causal call without a bias only scales its scores: the keys past S,
  // which the bias (-inf there) drops otherwise, lie above the diagonal of
  // every row before S, so the causal mask drops them (rows past S are not
  // stored). fmaf(x, c, 0) and x * c differ at most in an exact zero's
  // sign, which neither the max nor exp2 of a difference sees.
  const bool plain_scores = causal && bias == nullptr;
  // Key tiles that rows up to `last_row` attend.
  auto tiles_to = [&](int last_row) {
    return causal ? min(seq_tiles, last_row / kBlockN + 1) : seq_tiles;
  };
  // The first of consumer w's 64 rows in unit `un` (at or past seq:
  // none). As a rule, query tile q_tiles - 1 - p, its consumers' rows in
  // order: the last tiles, heaviest under the causal flag, first. A causal
  // call whose units fit one round (a CTA each) is balanced instead: the
  // 64-row blocks are dealt to the units heaviest first, consumer w's round
  // in direction w & 1, so that the heaviest blocks share their CTAs with
  // the lightest and no CTA's path is a whole heavy tile's.
  const bool balanced = causal && units <= static_cast<int>(gridDim.x);
  const int blocks = (seq + 63) / 64;
  auto first_row = [&](const Unit& un, int w) {
    if (!balanced) return (q_tiles - 1 - un.p) * kBlockM + 64 * w;
    const int rank = w * q_tiles + ((w & 1) ? q_tiles - 1 - un.p : un.p);
    const int block = blocks - 1 - rank;
    return block >= 0 ? 64 * block : seq;
  };
  // Key tiles the unit's CTA loads: those its heaviest consumer attends.
  auto unit_tiles = [&](const Unit& un) {
    int last = 0;
    for (int w = 0; w < kConsumers; ++w) {
      const int row = first_row(un, w);
      if (row < seq) last = max(last, row + 63);
    }
    return tiles_to(last);
  };

  if (tid == 0) {
    for (int w = 0; w < kConsumers; ++w) {
      mbar_init(&sm.q_full[w], 1);       // the Q warp
      mbar_init(&sm.q_empty[w], 128);    // the consumer's threads
    }
    for (int s = 0; s < kKStages; ++s) {
      mbar_init(&sm.k_full[s], 32);                 // the K warp
      mbar_init(&sm.k_empty[s], kConsumers * 128);  // every consumer thread
    }
    for (int s = 0; s < kVStages; ++s) {
      mbar_init(&sm.v_full[s], 1);                  // the V warp
      mbar_init(&sm.v_empty[s], kConsumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // Producer. Warps 0, 1 and 2 issue K (and the bias), V and Q; the
    // fourth only hands over its registers.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        C::kProducerRegs));
    const int warp = (tid % 128) / 32;
    const int lane = tid % 32;
    if (warp == 0) {
      for (int r = 0, it = 0;; ++r) {
        const int u = unit_of_round(r);
        if (u >= units) break;
        const Unit un = unit_at(u, heads, bh);
        const float* biasb =
            bias != nullptr ? bias + un.b * bias_sb : nullptr;
        const int n_tiles = unit_tiles(un);
        for (int j = 0; j < n_tiles; ++j, ++it) {
          const int stage = it % kKStages;
          mbar_wait(&sm.k_empty[stage], ((it / kKStages) & 1) ^ 1);
          const int key0 = j * kBlockN;
          if (lane == 0) {
            mbar_expect_tx(&sm.k_full[stage], kBlockN * kHeadDim * 2);
#pragma unroll
            for (int c = 0; c < kColBlocks; ++c) {
              tma_load(sm.k[stage][c], &tm_k, &sm.k_full[stage],
                       c * kBoxCols, key0, un.h, un.b);
            }
          }
          if (!plain_scores) {
#pragma unroll
            for (int e = 0; e < kBlockN / 32; ++e) {
              const int key = key0 + lane + 32 * e;
              float x = neg_inf();  // past the sequence end
              if (key < seq) {
                x = biasb != nullptr ? biasb[key] * kLog2e : 0.0f;
              }
              sm.bias[stage][lane + 32 * e] = x;
            }
          }
          mbar_arrive(&sm.k_full[stage]);
        }
      }
    } else if (warp == 1 && lane == 0) {
      for (int r = 0, it = 0;; ++r) {
        const int u = unit_of_round(r);
        if (u >= units) break;
        const Unit un = unit_at(u, heads, bh);
        const int n_tiles = unit_tiles(un);
        for (int j = 0; j < n_tiles; ++j, ++it) {
          const int stage = it % kVStages;
          mbar_wait(&sm.v_empty[stage], ((it / kVStages) & 1) ^ 1);
          mbar_arrive_expect_tx(&sm.v_full[stage], kBlockN * kHeadDim * 2);
#pragma unroll
          for (int c = 0; c < kColBlocks; ++c) {
            tma_load(sm.v[stage][c], &tm_v, &sm.v_full[stage], c * kBoxCols,
                     j * kBlockN, un.h, un.b);
          }
        }
      }
    } else if (warp == 2 && lane == 0) {
      for (int r = 0;; ++r) {
        const int u = unit_of_round(r);
        if (u >= units) break;
        const Unit un = unit_at(u, heads, bh);
        for (int w = 0; w < kConsumers; ++w) {
          mbar_wait(&sm.q_empty[w], (r & 1) ^ 1);
          const int row = first_row(un, w);
          if (row >= seq) {  // no row to load: the consumer computes nothing
            mbar_arrive(&sm.q_full[w]);
            continue;
          }
          mbar_arrive_expect_tx(&sm.q_full[w], 64 * kHeadDim * 2);
#pragma unroll
          for (int c = 0; c < kColBlocks; ++c) {
            tma_load(sm.q[c] + 64 * w * kBoxCols, &tm_q, &sm.q_full[w],
                     c * kBoxCols, row, un.h, un.b);
          }
        }
      }
    }
  } else {
    // Consumer warpgroup `wg`: rows first_row(unit, wg) ... + 63 of each
    // unit.
    // Scores are kept in the log2 domain (exp2 is one MUFU op): x2 =
    // log2(e) * x.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        C::kConsumerRegs));
    const int wtid = tid % 128;
    const int warp = wtid / 32;
    const int lane = tid % 32;
    const int g = lane / 4;
    const int t = lane % 4;
    const int row0 = 16 * warp + g;             // rows row0 and row0 + 8
    const float scale2 = sm_scale * kLog2e;
    const float neg_inf2 = kNegInf * kLog2e;    // the mask value, log2 domain

    // O: D / 8 n8 slices (column block c's from c * kBoxCols / 2), rows
    // row0 / row0 + 8.
    float acc[kHeadDim / 2];
    float row_max[2], row_sum[2];
    float s[kBlockN / 2];          // S of one key tile, then its P in fp32
    uint32_t pa[kBlockN / 16][4];  // P of the previous tile, T A fragments
    uint64_t desc_q[kColBlocks];   // this warpgroup's Q rows, per block
#pragma unroll
    for (int c = 0; c < kColBlocks; ++c) {
      desc_q[c] = smem_desc<kRowBytes>(sm.q[c] + 64 * wg * kBoxCols);
    }

    // S = Q K^T of the tile in K's `stage`: 64 rows x kBlockN keys, D / 16
    // k-steps of 16 (32 bytes along the swizzled rows of each column
    // block).
    auto issue_s = [&](int stage) {
#pragma unroll
      for (int c = 0; c < kColBlocks; ++c) {
        const uint64_t desc_k = smem_desc<kRowBytes>(sm.k[stage][c]);
#pragma unroll
        for (int kk = 0; kk < kBoxCols / 16; ++kk) {
          wgmma_ss<kBlockN, kF16>(s, desc_q[c] + 2 * kk, desc_k + 2 * kk,
                                  c > 0 || kk > 0);
        }
      }
      wgmma_commit();
    };
    // O += P V of the tile in V's `stage`: kBlockN / 16 k-steps of 16
    // keys, each 16 V rows further on, every one a single product over all
    // D columns (the column blocks kBlockN * kRowBytes bytes apart).
    auto issue_pv = [&](int stage) {
      const uint64_t desc_v =
          smem_desc<kRowBytes>(sm.v[stage][0], kBlockN * kRowBytes);
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk) {
        wgmma_rs<kHeadDim, kF16>(acc, pa[kk],
                                 desc_v + kk * (16 * kRowBytes >> 4));
      }
      wgmma_commit();
    };
    // Scale, and add the bias (stored times log2(e)) of K's `stage`.
    auto scale_bias = [&](int stage) {
      if (plain_scores) {
#pragma unroll
        for (int i = 0; i < kBlockN / 2; ++i) s[i] *= scale2;
        return;
      }
#pragma unroll
      for (int jn = 0; jn < kBlockN / 8; ++jn) {
        const float2 bv =
            *reinterpret_cast<const float2*>(&sm.bias[stage][jn * 8 + 2 * t]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[4 * jn + e] = fmaf(s[4 * jn + e], scale2, (e & 1) ? bv.y : bv.x);
        }
      }
    };
    // The causal mask, on a tile that crosses the diagonal of this
    // warpgroup's rows (`masked`); the online-softmax update of the row
    // statistics; s becomes P. A score at or below -1e30 needs no test:
    // exp2 of it minus a finite max is exactly 0. Maxima and sums run in 4
    // independent chains, and each thread keeps its own part of the row
    // sum until the epilogue. Returns the rescale factors of O through
    // `corr`.
    auto softmax = [&](bool masked, int key0, int qrow, float (&corr)[2]) {
      if (masked) {
#pragma unroll
        for (int jn = 0; jn < kBlockN / 8; ++jn) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (key0 + jn * 8 + 2 * t + (e & 1) > qrow + (e >> 1) * 8) {
              s[4 * jn + e] = neg_inf();
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float m4[4] = {neg_inf2, neg_inf2, neg_inf2, neg_inf2};
#pragma unroll
        for (int jn = 0; jn < kBlockN / 8; ++jn) {
          m4[jn % 4] = fmaxf(m4[jn % 4],
                             fmaxf(s[4 * jn + 2 * r], s[4 * jn + 2 * r + 1]));
        }
        const float m_cur =
            quad_max(fmaxf(fmaxf(m4[0], m4[1]), fmaxf(m4[2], m4[3])));
        const float m_prev = row_max[r];
        const float m_new = fmaxf(m_prev, m_cur);
        // Nothing attended yet: keep the max finite (0) so no NaN appears.
        const float safe_m = m_new <= neg_inf2 ? 0.0f : m_new;
        corr[r] = m_prev <= neg_inf2 ? 0.0f : fast_exp2(m_prev - safe_m);
        float part4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int jn = 0; jn < kBlockN / 8; ++jn) {
#pragma unroll
          for (int e = 2 * r; e < 2 * r + 2; ++e) {
            const float p = fast_exp2(s[4 * jn + e] - safe_m);
            s[4 * jn + e] = p;
            part4[jn % 4] += p;
          }
        }
        row_sum[r] = row_sum[r] * corr[r] +
                     ((part4[0] + part4[1]) + (part4[2] + part4[3]));
        row_max[r] = m_new;
      }
    };
    // Rescale O, and round P to T: the accumulator of key slices 2kk and
    // 2kk + 1, packed pairwise, is the A fragment of P.V step kk.
    auto rescale_and_pack = [&](const float (&corr)[2]) {
#pragma unroll
      for (int i = 0; i < kHeadDim / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk) {
        pa[kk][0] = pack<T>(s[8 * kk + 0], s[8 * kk + 1]);
        pa[kk][1] = pack<T>(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = pack<T>(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = pack<T>(s[8 * kk + 6], s[8 * kk + 7]);
      }
    };
    // The turns: wait for this warpgroup's; pass it to the next one (no
    // branch between a product's issue and its wait).
    const int my_turn = kTurnBar + wg;
    const int next_turn = kTurnBar + (wg + 1) % kConsumers;
    auto turn_begin = [&]() {
      if constexpr (C::kTurns) named_sync(my_turn, 256);
    };
    auto turn_end = [&]() {
      if constexpr (C::kTurns) named_arrive(next_turn, 256);
    };
    if constexpr (C::kTurns) {
      if (wg == 0) named_arrive(my_turn, 256);  // the first turn
    }

    int k_it = 0, v_it = 0;  // tiles of K's and V's rings taken so far
    for (int r = 0;; ++r) {
      const int u = unit_of_round(r);
      if (u >= units) break;
      const Unit un = unit_at(u, heads, bh);
      const int row_a = first_row(un, wg);  // this warpgroup's first row
      const int qrow = row_a + row0;        // absolute query row
      const int n_tiles = unit_tiles(un);
      // This warpgroup's tiles: none past the sequence, and under the
      // causal flag none wholly above its own diagonal.
      const int my_tiles = row_a < seq ? tiles_to(row_a + 63) : 0;
#pragma unroll
      for (int i = 0; i < kHeadDim / 2; ++i) acc[i] = 0.0f;
      row_max[0] = row_max[1] = neg_inf2;
      row_sum[0] = row_sum[1] = 0.0f;

      mbar_wait(&sm.q_full[wg], r & 1);
      if (my_tiles > 0) {
        // Tile 0 alone; then, for each further tile j, S of j and P.V of
        // j - 1 go to the tensor cores together, and the softmax of j runs
        // while P.V of j - 1 is still in flight. Tiles before `unmasked`
        // lie wholly below this warpgroup's diagonal.
        const int unmasked =
            causal ? min(my_tiles, (row_a + 1) / kBlockN) : my_tiles;
        float corr[2];
        const int ks0 = k_it % kKStages;
        mbar_wait(&sm.k_full[ks0], (k_it / kKStages) & 1);
        turn_begin();
        wgmma_fence();
        issue_s(ks0);
        turn_end();
        wgmma_wait<0>();
        fence_regs(s);
        scale_bias(ks0);
        mbar_arrive(&sm.k_empty[ks0]);
        softmax(unmasked == 0, 0, qrow, corr);
        rescale_and_pack(corr);
        for (int j = 1; j < my_tiles; ++j) {
          const int ks = (k_it + j) % kKStages;
          const int vs = (v_it + j - 1) % kVStages;  // tile j - 1
          mbar_wait(&sm.k_full[ks], ((k_it + j) / kKStages) & 1);
          mbar_wait(&sm.v_full[vs], ((v_it + j - 1) / kVStages) & 1);
          turn_begin();
          fence_regs(acc);
          wgmma_fence();
          issue_s(ks);
          issue_pv(vs);
          turn_end();
          wgmma_wait<1>();  // S of j is in; P.V of j - 1 may still run
          fence_regs(s);
          scale_bias(ks);
          mbar_arrive(&sm.k_empty[ks]);  // K and its bias are read
          softmax(j >= unmasked, j * kBlockN, qrow, corr);
          wgmma_wait<0>();
          fence_regs(acc);
          mbar_arrive(&sm.v_empty[vs]);
          rescale_and_pack(corr);
        }
        mbar_arrive(&sm.q_empty[wg]);  // its Q rows are read
        const int it = v_it + my_tiles - 1;
        const int vs = it % kVStages;
        mbar_wait(&sm.v_full[vs], (it / kVStages) & 1);
        fence_regs(acc);
        wgmma_fence();
        issue_pv(vs);
        wgmma_wait<0>();
        fence_regs(acc);
        mbar_arrive(&sm.v_empty[vs]);
      } else {
        mbar_arrive(&sm.q_empty[wg]);
      }
      // The CTA's tiles past this warpgroup's own: a turn each, to keep
      // the turns in step, and their stages handed on.
      for (int j = my_tiles; j < n_tiles; ++j) {
        turn_begin();
        turn_end();
        const int ki = k_it + j, vi = v_it + j;
        mbar_wait(&sm.k_full[ki % kKStages], (ki / kKStages) & 1);
        mbar_arrive(&sm.k_empty[ki % kKStages]);
        mbar_wait(&sm.v_full[vi % kVStages], (vi / kVStages) & 1);
        mbar_arrive(&sm.v_empty[vi % kVStages]);
      }
      k_it += n_tiles;
      v_it += n_tiles;

      // Epilogue: normalise, round to T, and store pairs of T straight
      // from the accumulators; rows past the sequence and columns past
      // d_out are not stored.
      T* ob = o + un.b * o_sb + un.h * o_sh;
#pragma unroll
      for (int r2 = 0; r2 < 2; ++r2) {
        const float sum = quad_sum(row_sum[r2]);
        const float denom = sum == 0.0f ? 1.0f : sum;
        const int row = qrow + 8 * r2;
        if (row >= seq) continue;
        T* orow = ob + row * o_ss;
#pragma unroll
        for (int dn = 0; dn < kHeadDim / 8; ++dn) {
          const int col = dn * 8 + 2 * t;
          const uint32_t pair = pack<T>(acc[4 * dn + 2 * r2] / denom,
                                        acc[4 * dn + 2 * r2 + 1] / denom);
          if (vec_out) {
            if (col < d_out) *reinterpret_cast<uint32_t*>(orow + col) = pair;
          } else {
            uint16_t* out16 = reinterpret_cast<uint16_t*>(orow);
            if (col < d_out) out16[col] = static_cast<uint16_t>(pair);
            if (col + 1 < d_out) {
              out16[col + 1] = static_cast<uint16_t>(pair >> 16);
            }
          }
        }
      }
    }
    // The last consumer's last turn_end arrived on consumer 0's barrier:
    // take it, so that no barrier is left with arrivals pending.
    if constexpr (C::kTurns) {
      if (wg == 0) named_sync(my_turn, 256);
    }
  }
}

}  // namespace sm90

// ---------------------------------------------------------------------------
// fp32: the tensor cores through the 3xTF32 split.

namespace f32 {

constexpr int kBlockM = 64;   // query rows per CTA, 16 a warp
constexpr int kThreads = 128;

// kPitch: K and V rows in shared memory, in floats. kChunk: output columns
// of one zeroed P.V accumulator.
template <int D, int BlockN>
struct Smem {
  static constexpr int kPitch = D + 4;
  float q[kBlockM][kPitch];
  float k[2][BlockN][kPitch];
  float v[2][BlockN][kPitch];
  float bias[2][BlockN];
};

__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem,
                                            bool valid) {
  const int src_bytes = valid ? 16 : 0;  // 0: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [row0, row0 + kRows) of a [S, *] fp32 view into a padded tile; rows
// at or past `seq` and columns at or past `d_in` are zero-filled.
template <int kRows, int D, int kPitch>
__device__ __forceinline__ void load_tile(float (*dst)[kPitch],
                                          const float* base,
                                          int64_t row_stride, int row0,
                                          int seq, int d_in, int tid) {
#pragma unroll
  for (int i = 0; i < kRows * (D / 4) / kThreads; ++i) {
    const int chunk = tid + i * kThreads;
    const int r = chunk / (D / 4);
    const int col = (chunk % (D / 4)) * 4;
    const int row = row0 + r;
    const bool valid = row < seq && col < d_in;
    cp_async_16(&dst[r][col],
                base + (valid ? (int64_t)row * row_stride + col : 0), valid);
  }
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small to about 2^-22: both halves rounded to TF32.
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

// c += a * b for one m16n8k8 tile, TF32 operands, fp32 accumulator.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c[n] += a * b[n] in 3xTF32 for N n8 slices that share the A fragment:
// small*big, big*small, then big*big into each accumulator. Each term is
// issued for all N slices before the next, so that two products into the
// same accumulator are N issues apart, not back to back.
template <int N>
__device__ __forceinline__ void mma_3xtf32(float (&c)[N][4],
                                           const uint32_t (&a_big)[4],
                                           const uint32_t (&a_small)[4],
                                           const float (&b)[N][2]) {
  uint32_t b_big[N][2], b_small[N][2];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    split(b[n][0], b_big[n][0], b_small[n][0]);
    split(b[n][1], b_big[n][1], b_small[n][1]);
  }
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(c[n], a_small, b_big[n][0], b_big[n][1]);
#pragma unroll
  for (int n = 0; n < N; ++n) {
    mma_tf32(c[n], a_big, b_small[n][0], b_small[n][1]);
  }
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(c[n], a_big, b_big[n][0], b_big[n][1]);
}

// `d_in`: the head dim q/k/v hold (columns past it load as zeros);
// `d_out`: the output columns stored; `vec_out`: o's rows take 8-byte
// stores (d_out even, o 8-byte aligned), else element stores.
template <int D, int kBlockN>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ bias,
                         float* __restrict__ o, int seq, int heads,
                         int d_in, int d_out,
                         int64_t q_sb, int64_t q_ss, int64_t q_sh,
                         int64_t k_sb, int64_t k_ss, int64_t k_sh,
                         int64_t v_sb, int64_t v_ss, int64_t v_sh,
                         int64_t o_sb, int64_t o_ss, int64_t o_sh,
                         int64_t bias_sb, float sm_scale, int causal,
                         int vec_out) {
  typedef Smem<D, kBlockN> S;
  constexpr int kPitch = S::kPitch;
  constexpr int kChunk = D < 64 ? D : 64;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S& sm = *reinterpret_cast<S*>(smem_raw);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int h = blockIdx.x % heads;
  const int b = blockIdx.x / heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockM;  // heaviest first

  const float* qb = q + b * q_sb + h * q_sh;
  const float* kb = k + b * k_sb + h * k_sh;
  const float* vb = v + b * v_sb + h * v_sh;
  const float* biasb = bias != nullptr ? bias + b * bias_sb : nullptr;

  int n_tiles = (seq + kBlockN - 1) / kBlockN;
  if (causal) n_tiles = min(n_tiles, (q0 + kBlockM - 1) / kBlockN + 1);

  auto load_bias = [&](int buf, int key0) {
    if (tid < kBlockN) {
      const int key = key0 + tid;
      float x = neg_inf();  // past the sequence end
      if (key < seq) x = biasb != nullptr ? biasb[key] : 0.0f;
      sm.bias[buf][tid] = x;
    }
  };

  load_tile<kBlockM, D, kPitch>(sm.q, qb, q_ss, q0, seq, d_in, tid);
  load_tile<kBlockN, D, kPitch>(sm.k[0], kb, k_ss, 0, seq, d_in, tid);
  load_tile<kBlockN, D, kPitch>(sm.v[0], vb, v_ss, 0, seq, d_in, tid);
  cp_async_commit();
  load_bias(0, 0);

  const int qrow = q0 + 16 * warp + g;  // absolute row of fragment row g
  const float* q_g = sm.q[16 * warp + g];
  const float* q_g8 = sm.q[16 * warp + g + 8];

  float acc[D / 8][4];  // O: D / 8 n8 slices
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;
  }
  float row_max[2] = {kNegInf, kNegInf};  // rows g and g + 8
  float row_sum[2] = {0.0f, 0.0f};

  for (int j = 0; j < n_tiles; ++j) {
    const int cur = j & 1;
    if (j + 1 < n_tiles) {
      load_tile<kBlockN, D, kPitch>(sm.k[cur ^ 1], kb, k_ss,
                                    (j + 1) * kBlockN, seq, d_in, tid);
      load_tile<kBlockN, D, kPitch>(sm.v[cur ^ 1], vb, v_ss,
                                    (j + 1) * kBlockN, seq, d_in, tid);
      cp_async_commit();
      load_bias(cur ^ 1, (j + 1) * kBlockN);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // S = Q K^T for 16 rows x kBlockN keys: D / 8 k-steps, kBlockN / 8 n8
    // slices. Q's A fragment of step kk: a0 (g, t), a1 (g + 8, t), a2 (g,
    // t + 4), a3 (g + 8, t + 4), split once for the slices.
    float s[kBlockN / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.0f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      uint32_t qa_big[4], qa_small[4];
      split(q_g[kk * 8 + t], qa_big[0], qa_small[0]);
      split(q_g8[kk * 8 + t], qa_big[1], qa_small[1]);
      split(q_g[kk * 8 + t + 4], qa_big[2], qa_small[2]);
      split(q_g8[kk * 8 + t + 4], qa_big[3], qa_small[3]);
      float kf[kBlockN / 8][2];  // B fragments: K rows nt * 8 + g
#pragma unroll
      for (int nt = 0; nt < kBlockN / 8; ++nt) {
        kf[nt][0] = sm.k[cur][nt * 8 + g][kk * 8 + t];
        kf[nt][1] = sm.k[cur][nt * 8 + g][kk * 8 + t + 4];
      }
      mma_3xtf32(s, qa_big, qa_small, kf);
    }

    // Scale, bias, causal mask (the tiles that cross the diagonal only);
    // then the online-softmax update per row.
    const int key0 = j * kBlockN;
    float row_corr[2];
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = s[nt][e] * sm_scale + sm.bias[cur][nt * 8 + 2 * t + (e & 1)];
      }
    }
    if (causal && key0 + kBlockN - 1 > q0) {  // crosses the diagonal
#pragma unroll
      for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (key0 + nt * 8 + 2 * t + (e & 1) > qrow + (e >> 1) * 8) {
            s[nt][e] = kNegInf;
          }
        }
      }
    }
    // As in the bf16 kernel: a score at or below -1e30 needs no test (expf
    // of it minus a finite max is exactly 0), maxima and sums run in 4
    // independent chains, and the row sum stays per thread until the end.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float m4[4] = {kNegInf, kNegInf, kNegInf, kNegInf};
#pragma unroll
      for (int nt = 0; nt < kBlockN / 8; ++nt) {
        m4[nt % 4] = fmaxf(m4[nt % 4], fmaxf(s[nt][2 * r], s[nt][2 * r + 1]));
      }
      const float m_cur =
          quad_max(fmaxf(fmaxf(m4[0], m4[1]), fmaxf(m4[2], m4[3])));
      const float m_prev = row_max[r];
      const float m_new = fmaxf(m_prev, m_cur);
      // Nothing attended yet: keep the max finite (0) so no NaN appears.
      const float safe_m = m_new <= kNegInf ? 0.0f : m_new;
      const float corr = m_prev <= kNegInf ? 0.0f : expf(m_prev - safe_m);
      float part4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          const float p = expf(s[nt][e] - safe_m);
          s[nt][e] = p;
          part4[nt % 4] += p;
        }
      }
      row_sum[r] = row_sum[r] * corr +
                   ((part4[0] + part4[1]) + (part4[2] + part4[3]));
      row_max[r] = m_new;
      row_corr[r] = corr;
    }

    // O = O * corr + P V, kBlockN / 8 k-steps of 8 keys, kChunk output
    // columns at a time. The tensor cores' fp32 accumulation truncates;
    // summed into the running O across all key tiles that bias would grow
    // with S, so each tile's P V starts from 0 and joins O in one rounded
    // add. Step kk's A fragment is the accumulator of key slice kk as it
    // lies: P(g, 2t) and P(g + 8, 2t) as columns t, P(g, 2t + 1) and
    // P(g + 8, 2t + 1) as columns t + 4; the B fragment reads V rows 2t
    // and 2t + 1 to match.
#pragma unroll
    for (int c = 0; c < D / kChunk; ++c) {
      float pv[kChunk / 8][4];
#pragma unroll
      for (int dn = 0; dn < kChunk / 8; ++dn) {
        pv[dn][0] = pv[dn][1] = pv[dn][2] = pv[dn][3] = 0.0f;
      }
#pragma unroll
      for (int kk = 0; kk < kBlockN / 8; ++kk) {
        uint32_t pa_big[4], pa_small[4];
        split(s[kk][0], pa_big[0], pa_small[0]);
        split(s[kk][2], pa_big[1], pa_small[1]);
        split(s[kk][1], pa_big[2], pa_small[2]);
        split(s[kk][3], pa_big[3], pa_small[3]);
        float vf[kChunk / 8][2];  // B fragments: V rows 2t, 2t + 1
#pragma unroll
        for (int dn = 0; dn < kChunk / 8; ++dn) {
          vf[dn][0] = sm.v[cur][kk * 8 + 2 * t][c * kChunk + dn * 8 + g];
          vf[dn][1] = sm.v[cur][kk * 8 + 2 * t + 1][c * kChunk + dn * 8 + g];
        }
        mma_3xtf32(pv, pa_big, pa_small, vf);
      }
#pragma unroll
      for (int dn = 0; dn < kChunk / 8; ++dn) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[c * (kChunk / 8) + dn][e] =
              acc[c * (kChunk / 8) + dn][e] * row_corr[e >> 1] + pv[dn][e];
        }
      }
    }
    __syncthreads();  // this tile's buffers are refilled next iteration
  }

  float* ob = o + b * o_sb + h * o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float sum = quad_sum(row_sum[r]);  // every lane, before any exit
    const int row = qrow + r * 8;
    if (row >= seq) continue;
    const float denom = sum == 0.0f ? 1.0f : sum;
    float* orow = ob + row * o_ss;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      const int col = dn * 8 + 2 * t;
      const float x = acc[dn][2 * r] / denom;
      const float y = acc[dn][2 * r + 1] / denom;
      if (vec_out) {
        if (col < d_out) {
          *reinterpret_cast<float2*>(orow + col) = make_float2(x, y);
        }
      } else {
        if (col < d_out) orow[col] = x;
        if (col + 1 < d_out) orow[col + 1] = y;
      }
    }
  }
}

}  // namespace f32

// ---------------------------------------------------------------------------
// fp32 above head dim 64: 3xTF32 on wgmma fed by TMA, and its pre-pass.

namespace tf32 {

using sm90::fence_regs;
using sm90::mbar_arrive;
using sm90::mbar_arrive_expect_tx;
using sm90::mbar_expect_tx;
using sm90::mbar_init;
using sm90::mbar_wait;
using sm90::smem_desc;
using sm90::wgmma_commit;
using sm90::wgmma_fence;
using sm90::wgmma_wait;

// One instantiation (see the header comment): head dim, keys a stage, K
// and V stages, consumer warpgroups and their registers, and whether Q's
// small half lives in registers (the A operand of one product) or in
// shared memory.
template <int D, int BlockN, int KStages, int VStages, int Consumers,
          int ConsumerRegs, bool QSmallInRegs>
struct Config {
  static constexpr int kHeadDim = D;
  static constexpr int kBlockN = BlockN;
  static constexpr int kKStages = KStages;
  static constexpr int kVStages = VStages;
  static constexpr int kConsumers = Consumers;    // warpgroups of 64 rows
  static constexpr int kBlockM = Consumers * 64;  // query rows per CTA
  static constexpr int kThreads = (Consumers + 1) * 128;
  // Registers a thread after setmaxnreg: with two or more consumers the
  // producer warpgroup gives up what they take; with one (ConsumerRegs 0)
  // every thread keeps up to 255 and nothing is handed over.
  static constexpr int kProducerRegs = 24;
  static constexpr int kConsumerRegs = ConsumerRegs;
  static_assert(Consumers == 1
                    ? kConsumerRegs == 0
                    : 128 * kProducerRegs + 128 * Consumers * kConsumerRegs <=
                          65536,
                "register split exceeds the SM");
  static constexpr bool kQSmallInRegs = QSmallInRegs;
  // Q and K: column blocks of 32 fp32 columns, one 128-byte swizzle atom.
  static constexpr int kColBlocks = D / 32;
  // V^T: rows of kBlockN keys, one swizzle atom (128 or 64 bytes) wide.
  static constexpr int kVtRowBytes = BlockN * 4;
  static_assert(kVtRowBytes == 128 || kVtRowBytes == 64, "swizzle width");
  static constexpr int kChunk = 64;  // output columns of one P.V product
  static_assert(D % kChunk == 0, "head dim");
};

typedef Config<128, 32, 2, 2, 2, 240, true> Config128;
typedef Config<256, 16, 2, 1, 1, 0, false> Config256;

template <class C>
struct Smem {  // at a 1024-byte boundary, as the swizzle needs
  float q_big[C::kColBlocks][C::kBlockM * 32];
  // Where Q's small half is held in registers, 1 KB that keeps the rest
  // aligned.
  float q_small[C::kQSmallInRegs ? 256 : C::kColBlocks * C::kBlockM * 32];
  float k_big[C::kKStages][C::kColBlocks][C::kBlockN * 32];
  float k_small[C::kKStages][C::kColBlocks][C::kBlockN * 32];
  float vt_big[C::kVStages][C::kHeadDim * C::kBlockN];
  float vt_small[C::kVStages][C::kHeadDim * C::kBlockN];
  float bias[C::kKStages][C::kBlockN];
  uint64_t q_full;
  uint64_t k_full[C::kKStages];
  uint64_t k_empty[C::kKStages];
  uint64_t v_full[C::kVStages];
  uint64_t v_empty[C::kVStages];
};
template <class C>
constexpr int kSmemBytes = sizeof(Smem<C>) + 1024;  // + room to align

// One box of a 3-D tensor map, coordinates (x, y, z), into `dst`.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int x, int y,
                                            int z) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(x), "r"(y),
      "r"(z)
      : "memory");
}

// d[64 x N] (+)= A[64 x 8] * B[8 x N] in TF32, A and B K-major in shared
// memory, fp32 accumulator in registers (N / 2 a thread). scale_d = 0
// starts from zero.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a,
                                         uint64_t desc_b, int scale_d);

template <>
__device__ __forceinline__ void wgmma_ss<16>(float (&d)[8], uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d[64 x N] (+)= A[64 x 8] * B[8 x N] in TF32, A in registers (a0 row g
// column t, a1 row g + 8 column t, a2 row g column t + 4, a3 row g + 8
// column t + 4 of the warp's 16 rows), B K-major in shared memory.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b, int scale_d);

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

// Keeps register A fragments alive, unmoved, until the asynchronous
// products that read them have completed (after the wait).
template <int N>
__device__ __forceinline__ void fence_a(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e])::"memory");
  }
}

// The key that position p of an 8-key group of V^T holds: positions t and
// t + 4 take keys 2t and 2t + 1, the order in which a thread's S
// accumulator holds P (see the header comment).
__host__ __device__ __forceinline__ int permuted_key(int p) {
  const int e = p & 7;
  return (p & ~7) + (e < 4 ? 2 * e : 2 * (e - 4) + 1);
}

constexpr int kSplitKeys = 32;    // keys a pre-pass CTA splits
constexpr int kSplitThreads = 256;

// The pre-pass: K's and V's TF32 halves, once a call. `kh` is [2, B, H,
// s_pad, dk] (big, then small), `vt` [2, B, H, dk, s_pad] with the keys of
// each 8-key group in permuted_key order; columns at or past d_in and keys
// at or past seq are zeros. One CTA splits 32 keys of one (batch, head):
// grid (key blocks, heads, batch).
__global__ void __launch_bounds__(kSplitThreads)
    split_kv_kernel(const float* __restrict__ k, const float* __restrict__ v,
                    float* __restrict__ kh, float* __restrict__ vt,
                    int batch, int seq, int heads, int d_in, int dk,
                    int s_pad, int64_t k_sb, int64_t k_ss, int64_t k_sh,
                    int64_t v_sb, int64_t v_ss, int64_t v_sh) {
  __shared__ float tile[kSplitKeys][kMaxHeadDim + 1];
  const int key0 = blockIdx.x * kSplitKeys;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int bh = b * heads + h;
  const int64_t half = (int64_t)batch * heads * s_pad * dk;
  float* kout = kh + ((int64_t)bh * s_pad + key0) * dk;
  const int quads = dk / 4;
  for (int i = threadIdx.x; i < kSplitKeys * quads; i += kSplitThreads) {
    const int r = i / quads;
    const int c = (i % quads) * 4;
    const int key = key0 + r;
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float4 y = x;
    if (key < seq && c < d_in) {
      x = *reinterpret_cast<const float4*>(k + b * k_sb + key * k_ss +
                                           h * k_sh + c);
      y = *reinterpret_cast<const float4*>(v + b * v_sb + key * v_ss +
                                           h * v_sh + c);
    }
    float4 big, small;
    uint32_t hi, lo;
    f32::split(x.x, hi, lo);
    big.x = __uint_as_float(hi);
    small.x = __uint_as_float(lo);
    f32::split(x.y, hi, lo);
    big.y = __uint_as_float(hi);
    small.y = __uint_as_float(lo);
    f32::split(x.z, hi, lo);
    big.z = __uint_as_float(hi);
    small.z = __uint_as_float(lo);
    f32::split(x.w, hi, lo);
    big.w = __uint_as_float(hi);
    small.w = __uint_as_float(lo);
    *reinterpret_cast<float4*>(kout + r * dk + c) = big;
    *reinterpret_cast<float4*>(kout + half + r * dk + c) = small;
    tile[r][c] = y.x;
    tile[r][c + 1] = y.y;
    tile[r][c + 2] = y.z;
    tile[r][c + 3] = y.w;
  }
  __syncthreads();
  float* vout = vt + (int64_t)bh * dk * s_pad + key0;
  for (int i = threadIdx.x; i < dk * kSplitKeys; i += kSplitThreads) {
    const int d = i / kSplitKeys;
    const int p = i % kSplitKeys;
    uint32_t hi, lo;
    f32::split(tile[permuted_key(p)][d], hi, lo);
    vout[(int64_t)d * s_pad + p] = __uint_as_float(hi);
    vout[half + (int64_t)d * s_pad + p] = __uint_as_float(lo);
  }
}

// `d_out`: the caller's head dim, the output columns stored (<= D);
// `vec_out`: o's rows take 8-byte stores (d_out even, o 8-byte aligned),
// else element stores. tm_k and tm_vt read the pre-pass's halves: the big
// half of (b, h) at z = b * heads + h, its small half batch * heads on.
template <class C>
__global__ void __launch_bounds__(C::kThreads, 1)
    flash_fwd_tf32_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_vt,
                          const float* __restrict__ bias,
                          float* __restrict__ o, int batch, int seq,
                          int heads, int d_out, int64_t o_sb, int64_t o_ss,
                          int64_t o_sh, int64_t bias_sb, float sm_scale,
                          int causal, int vec_out) {
  constexpr int kHeadDim = C::kHeadDim;
  constexpr int kBlockN = C::kBlockN;
  constexpr int kBlockM = C::kBlockM;
  constexpr int kKStages = C::kKStages;
  constexpr int kVStages = C::kVStages;
  constexpr int kConsumers = C::kConsumers;
  constexpr int kColBlocks = C::kColBlocks;
  constexpr int kVtRowBytes = C::kVtRowBytes;
  constexpr int kChunk = C::kChunk;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<C>& sm = *reinterpret_cast<Smem<C>*>(
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int h = blockIdx.x % heads;
  const int b = blockIdx.x / heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockM;  // heaviest first
  int n_tiles = (seq + kBlockN - 1) / kBlockN;
  if (causal) n_tiles = min(n_tiles, (q0 + kBlockM - 1) / kBlockN + 1);

  if (tid == 0) {
    mbar_init(&sm.q_full, 1);
    for (int s = 0; s < kKStages; ++s) {
      mbar_init(&sm.k_full[s], 32);                  // the producer warp
      mbar_init(&sm.k_empty[s], kConsumers * 128);   // every consumer thread
    }
    for (int s = 0; s < kVStages; ++s) {
      mbar_init(&sm.v_full[s], 1);
      mbar_init(&sm.v_empty[s], kConsumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // Producer: one warp issues everything.
    if constexpr (C::kConsumerRegs > 0) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
          C::kProducerRegs));
    }
    if (tid % 128 < 32) {
      const int lane = tid % 32;
      const float* biasb = bias != nullptr ? bias + b * bias_sb : nullptr;
      const int z_big = b * heads + h;
      const int z_small = z_big + batch * heads;
      if (lane == 0) {
        mbar_arrive_expect_tx(&sm.q_full, kBlockM * kHeadDim * 4);
#pragma unroll
        for (int c = 0; c < kColBlocks; ++c) {
          sm90::tma_load(sm.q_big[c], &tm_q, &sm.q_full, c * 32, q0, h, b);
        }
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int key0 = j * kBlockN;
        const int ks = j % kKStages;
        mbar_wait(&sm.k_empty[ks], ((j / kKStages) & 1) ^ 1);
        if (lane == 0) {
          mbar_expect_tx(&sm.k_full[ks], 2 * kBlockN * kHeadDim * 4);
#pragma unroll
          for (int c = 0; c < kColBlocks; ++c) {
            tma_load_3d(sm.k_big[ks][c], &tm_k, &sm.k_full[ks], c * 32, key0,
                        z_big);
            tma_load_3d(sm.k_small[ks][c], &tm_k, &sm.k_full[ks], c * 32,
                        key0, z_small);
          }
        }
        if (lane < kBlockN) {
          const int key = key0 + lane;
          float x = neg_inf();  // past the sequence end
          if (key < seq) x = biasb != nullptr ? biasb[key] : 0.0f;
          sm.bias[ks][lane] = x;
        }
        mbar_arrive(&sm.k_full[ks]);
        const int vs = j % kVStages;
        mbar_wait(&sm.v_empty[vs], ((j / kVStages) & 1) ^ 1);
        if (lane == 0) {
          mbar_arrive_expect_tx(&sm.v_full[vs], 2 * kBlockN * kHeadDim * 4);
          tma_load_3d(sm.vt_big[vs], &tm_vt, &sm.v_full[vs], key0, 0, z_big);
          tma_load_3d(sm.vt_small[vs], &tm_vt, &sm.v_full[vs], key0, 0,
                      z_small);
        }
      }
    }
  } else {
    if constexpr (C::kConsumerRegs > 0) {
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
          C::kConsumerRegs));
    }
    const int wtid = tid % 128;
    const int warp = wtid / 32;
    const int lane = tid % 32;
    const int g = lane / 4;
    const int t = lane % 4;
    const int row0 = 64 * wg + 16 * warp + g;  // rows row0, row0 + 8
    const int qrow = q0 + row0;                // absolute query row
    const int first_row = q0 + 64 * wg;        // this warpgroup's first row
    // Key tiles wholly above this warpgroup's diagonal are skipped.
    int my_tiles = n_tiles;
    if (causal) my_tiles = min(n_tiles, (first_row + 63) / kBlockN + 1);

    // Split Q once: each thread reads the elements of its own A fragments
    // (k-step kk of column block c: rows row0 / row0 + 8, columns 8 kk + t
    // / + 4), writes the big half back in place and keeps the small half
    // in registers (or writes it to q_small). Element (r, col) of a
    // column block sits at 16-byte chunk (col / 4) ^ (r % 8) of row r.
    constexpr int kQsRegs = C::kQSmallInRegs ? kColBlocks * 4 : 1;
    uint32_t qs[kQsRegs][4];
    mbar_wait(&sm.q_full, 0);
#pragma unroll
    for (int c = 0; c < kColBlocks; ++c) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = row0 + 8 * (e & 1);
          const int col = 8 * kk + t + 4 * (e >> 1);
          const int off = r * 32 + (((col >> 2) ^ (r & 7)) << 2) + (col & 3);
          uint32_t big, small;
          f32::split(sm.q_big[c][off], big, small);
          sm.q_big[c][off] = __uint_as_float(big);
          if constexpr (C::kQSmallInRegs) {
            qs[c * 4 + kk][e] = small;
          } else {
            sm.q_small[c * kBlockM * 32 + off] = __uint_as_float(small);
          }
        }
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");

    float acc[kHeadDim / kChunk][kChunk / 2];  // O, per 64-column chunk
#pragma unroll
    for (int ch = 0; ch < kHeadDim / kChunk; ++ch) {
#pragma unroll
      for (int i = 0; i < kChunk / 2; ++i) acc[ch][i] = 0.0f;
    }
    float row_max[2] = {kNegInf, kNegInf};  // rows row0 and row0 + 8
    float row_sum[2] = {0.0f, 0.0f};
    uint64_t desc_q[kColBlocks], desc_qs[kColBlocks];  // its Q rows
#pragma unroll
    for (int c = 0; c < kColBlocks; ++c) {
      desc_q[c] = smem_desc<128>(sm.q_big[c] + 64 * wg * 32);
      if constexpr (!C::kQSmallInRegs) {
        desc_qs[c] =
            smem_desc<128>(sm.q_small + c * kBlockM * 32 + 64 * wg * 32);
      }
    }

    for (int j = 0; j < n_tiles; ++j) {
      const int ks = j % kKStages;
      const int vs = j % kVStages;
      if (j >= my_tiles) {  // wholly above the diagonal: hand the stages on
        mbar_wait(&sm.k_full[ks], (j / kKStages) & 1);
        mbar_arrive(&sm.k_empty[ks]);
        mbar_wait(&sm.v_full[vs], (j / kVStages) & 1);
        mbar_arrive(&sm.v_empty[vs]);
        continue;
      }
      // S = Q K^T: 64 rows x kBlockN keys, D / 8 k-steps, each three TF32
      // products. big x big goes into s; small x big and big x small, about
      // 2^-11 of it, into s_corr, and the two join in one rounded add: the
      // tensor cores' accumulation truncates at the accumulator's scale, so
      // only the big x big chain rounds at S's own.
      float s[kBlockN / 2], s_corr[kBlockN / 2];
      mbar_wait(&sm.k_full[ks], (j / kKStages) & 1);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < kColBlocks; ++c) {
        const uint64_t desc_kb = smem_desc<128>(sm.k_big[ks][c]);
        const uint64_t desc_ks = smem_desc<128>(sm.k_small[ks][c]);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int acc_s = c > 0 || kk > 0;
          if constexpr (C::kQSmallInRegs) {
            wgmma_rs<kBlockN>(s_corr, qs[c * 4 + kk], desc_kb + 2 * kk,
                              acc_s);
          } else {
            wgmma_ss<kBlockN>(s_corr, desc_qs[c] + 2 * kk, desc_kb + 2 * kk,
                              acc_s);
          }
          wgmma_ss<kBlockN>(s, desc_q[c] + 2 * kk, desc_kb + 2 * kk, acc_s);
          wgmma_ss<kBlockN>(s_corr, desc_q[c] + 2 * kk, desc_ks + 2 * kk, 1);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(s_corr);
#pragma unroll
      for (int i = 0; i < kBlockN / 2; ++i) s[i] += s_corr[i];

      // Scale, bias, causal mask on the tiles that cross this warpgroup's
      // diagonal; the online-softmax update. s[4 jn + e] is row row0 +
      // 8 (e >> 1), key key0 + 8 jn + 2t + (e & 1). As in the other
      // kernels: a score at or below -1e30 needs no test (expf of it
      // minus a finite max is exactly 0), and each thread keeps its own
      // part of the row sum until the end.
      const int key0 = j * kBlockN;
#pragma unroll
      for (int jn = 0; jn < kBlockN / 8; ++jn) {
        const float2 bv =
            *reinterpret_cast<const float2*>(&sm.bias[ks][jn * 8 + 2 * t]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[4 * jn + e] = s[4 * jn + e] * sm_scale + ((e & 1) ? bv.y : bv.x);
        }
      }
      mbar_arrive(&sm.k_empty[ks]);  // K and the bias are read
      if (causal && key0 + kBlockN - 1 > first_row) {
#pragma unroll
        for (int jn = 0; jn < kBlockN / 8; ++jn) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (key0 + jn * 8 + 2 * t + (e & 1) > qrow + (e >> 1) * 8) {
              s[4 * jn + e] = kNegInf;
            }
          }
        }
      }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float m = kNegInf;
#pragma unroll
        for (int jn = 0; jn < kBlockN / 8; ++jn) {
          m = fmaxf(m, fmaxf(s[4 * jn + 2 * r], s[4 * jn + 2 * r + 1]));
        }
        const float m_new = fmaxf(row_max[r], quad_max(m));
        // Nothing attended yet: keep the max finite (0) so no NaN appears.
        const float safe_m = m_new <= kNegInf ? 0.0f : m_new;
        corr[r] = row_max[r] <= kNegInf ? 0.0f : expf(row_max[r] - safe_m);
        float part = 0.0f;
#pragma unroll
        for (int jn = 0; jn < kBlockN / 8; ++jn) {
#pragma unroll
          for (int e = 2 * r; e < 2 * r + 2; ++e) {
            const float p = expf(s[4 * jn + e] - safe_m);
            s[4 * jn + e] = p;
            part += p;
          }
        }
        row_sum[r] = row_sum[r] * corr[r] + part;
        row_max[r] = m_new;
      }
      // P's A fragments, split: key slice kk's accumulator as it lies,
      // P(g, 2t) and P(g + 8, 2t) as columns t, P(g, 2t + 1) and P(g + 8,
      // 2t + 1) as columns t + 4, which V^T's permuted keys match.
      uint32_t pb[kBlockN / 8][4], ps[kBlockN / 8][4];
#pragma unroll
      for (int kk = 0; kk < kBlockN / 8; ++kk) {
        f32::split(s[4 * kk + 0], pb[kk][0], ps[kk][0]);
        f32::split(s[4 * kk + 2], pb[kk][1], ps[kk][1]);
        f32::split(s[4 * kk + 1], pb[kk][2], ps[kk][2]);
        f32::split(s[4 * kk + 3], pb[kk][3], ps[kk][3]);
      }

      // O = O * corr + P V, kChunk output columns at a time. The tensor
      // cores' fp32 accumulation truncates, so each tile's P V starts from
      // zero and joins O in one rounded add.
      mbar_wait(&sm.v_full[vs], (j / kVStages) & 1);
#pragma unroll
      for (int ch = 0; ch < kHeadDim / kChunk; ++ch) {
        float pv[kChunk / 2];
        const uint64_t desc_vb = smem_desc<kVtRowBytes>(
            sm.vt_big[vs] + ch * kChunk * kBlockN);
        const uint64_t desc_vs = smem_desc<kVtRowBytes>(
            sm.vt_small[vs] + ch * kChunk * kBlockN);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBlockN / 8; ++kk) {
          wgmma_rs<kChunk>(pv, ps[kk], desc_vb + 2 * kk, kk > 0);
          wgmma_rs<kChunk>(pv, pb[kk], desc_vs + 2 * kk, 1);
          wgmma_rs<kChunk>(pv, pb[kk], desc_vb + 2 * kk, 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(pv);
        fence_a(pb);
        fence_a(ps);
#pragma unroll
        for (int i = 0; i < kChunk / 2; ++i) {
          acc[ch][i] = acc[ch][i] * corr[(i >> 1) & 1] + pv[i];
        }
      }
      mbar_arrive(&sm.v_empty[vs]);
    }

    float* ob = o + b * o_sb + h * o_sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float sum = quad_sum(row_sum[r]);
      const int row = qrow + r * 8;
      if (row >= seq) continue;
      const float denom = sum == 0.0f ? 1.0f : sum;
      float* orow = ob + row * o_ss;
#pragma unroll
      for (int ch = 0; ch < kHeadDim / kChunk; ++ch) {
#pragma unroll
        for (int dn = 0; dn < kChunk / 8; ++dn) {
          const int col = ch * kChunk + dn * 8 + 2 * t;
          const float x = acc[ch][4 * dn + 2 * r] / denom;
          const float y = acc[ch][4 * dn + 2 * r + 1] / denom;
          if (vec_out) {
            if (col < d_out) {
              *reinterpret_cast<float2*>(orow + col) = make_float2(x, y);
            }
          } else {
            if (col < d_out) orow[col] = x;
            if (col + 1 < d_out) orow[col + 1] = y;
          }
        }
      }
    }
  }
}

}  // namespace tf32

// Error codes of this file beyond cudaError_t's range.
constexpr int kErrNoEncoder = 100001;  // no cuTensorMapEncodeTiled
constexpr int kErrTensorMap = 100002;  // it refused a tensor map
constexpr int kErrHeadDim = 100003;    // a head dim outside 1 .. 256
constexpr int kErrSplit = 100004;      // no pre-pass halves, or bad ones

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

// A 4-D (d, s, h, b) map over a strided [B, S, H, d_in] view of bf16 or
// fp32 elements (strides in elements), boxes of `box_cols` columns (one
// swizzle atom wide: 128 bytes with the 128-byte swizzle, 64 with the
// 64-byte one) by `box_rows` rows of one head. Columns past d_in and rows
// past S arrive as zeros.
bool encode_qkv_map(CUtensorMap* map, const void* base,
                    CUtensorMapDataType type, int elem_bytes, int batch,
                    int seq, int heads, int d_in, int64_t sb, int64_t ss,
                    int64_t sh, cuuint32_t box_cols, cuuint32_t box_rows) {
  // The stride of a dimension of size 1 is never stepped: any valid one.
  const cuuint64_t row_bytes = (cuuint64_t)d_in * elem_bytes;
  cuuint64_t dims[4] = {(cuuint64_t)d_in, (cuuint64_t)seq, (cuuint64_t)heads,
                        (cuuint64_t)batch};
  cuuint64_t strides[3] = {
      seq > 1 ? (cuuint64_t)ss * elem_bytes : row_bytes,
      heads > 1 ? (cuuint64_t)sh * elem_bytes : row_bytes,
      batch > 1 ? (cuuint64_t)sb * elem_bytes : row_bytes};
  cuuint32_t box[4] = {box_cols, box_rows, 1, 1};
  cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return tensor_map_encoder()(
             map, type, 4, const_cast<void*>(base), dims, strides, box,
             elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
             box_cols * elem_bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                          : CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A 3-D fp32 map over a contiguous [z, y, x] array of the pre-pass, boxes
// of box_x by box_y (box_x one swizzle atom wide: 128 or 64 bytes).
bool encode_split_map(CUtensorMap* map, const void* base, int x, int y, int z,
                      cuuint32_t box_x, cuuint32_t box_y) {
  cuuint64_t dims[3] = {(cuuint64_t)x, (cuuint64_t)y, (cuuint64_t)z};
  cuuint64_t strides[2] = {(cuuint64_t)x * 4, (cuuint64_t)x * y * 4};
  cuuint32_t box[3] = {box_x, box_y, 1};
  cuuint32_t elem_strides[3] = {1, 1, 1};
  return tensor_map_encoder()(
             map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(base),
             dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
             box_x * 4 == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                              : CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Opt a kernel in to its dynamic shared memory, once per device (two
// threads may both do it; that is harmless).
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, int bytes, std::atomic<bool> (&done)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev].load())) return err;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < 64) done[dev].store(true);
  return err;
}

// The current device's SM count, read once per device.
cudaError_t sm_count(int* count) {
  static std::atomic<int> counts[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && (*count = counts[dev].load()) > 0) return cudaSuccess;
  err = cudaDeviceGetAttribute(count, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && dev < 64) counts[dev].store(*count);
  return err;
}

template <int D, int kBlockN>
int launch_f32(const void* q, const void* k, const void* v, const void* bias,
               void* o, int batch, int seq, int heads, int d_in, int d_out,
               int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb,
               int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss,
               int64_t v_sh, int64_t o_sb, int64_t o_ss, int64_t o_sh,
               int64_t bias_sb, float sm_scale, int causal, void* stream) {
  static std::atomic<bool> opted_in[64];
  constexpr int kBytes = sizeof(f32::Smem<D, kBlockN>);
  cudaError_t err =
      opt_in(f32::flash_fwd_f32_kernel<D, kBlockN>, kBytes, opted_in);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec_out = d_out % 2 == 0 &&
                      reinterpret_cast<uintptr_t>(o) % 8 == 0 &&
                      o_sb % 2 == 0 && o_ss % 2 == 0 && o_sh % 2 == 0;
  dim3 grid(batch * heads, (seq + f32::kBlockM - 1) / f32::kBlockM);
  f32::flash_fwd_f32_kernel<D, kBlockN>
      <<<grid, f32::kThreads, kBytes, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), static_cast<const float*>(bias),
          static_cast<float*>(o), seq, heads, d_in, d_out, q_sb, q_ss, q_sh,
          k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh, bias_sb,
          sm_scale, causal, vec_out);
  return static_cast<int>(cudaGetLastError());
}

// bf16 or fp16 (T) on wgmma fed by TMA.
template <class C, typename T>
int launch_16(const void* q, const void* k, const void* v, const void* bias,
              void* o, int batch, int seq, int heads, int d_in, int d_out,
              int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb,
              int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss,
              int64_t v_sh, int64_t o_sb, int64_t o_ss, int64_t o_sh,
              int64_t bias_sb, float sm_scale, int causal, void* stream) {
  if (tensor_map_encoder() == nullptr) return kErrNoEncoder;
  CUtensorMap tm_q, tm_k, tm_v;
  constexpr CUtensorMapDataType kType = std::is_same<T, __half>::value
                                            ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                            : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (!encode_qkv_map(&tm_q, q, kType, 2, batch, seq, heads, d_in, q_sb,
                      q_ss, q_sh, C::kBoxCols, 64) ||  // a consumer's rows
      !encode_qkv_map(&tm_k, k, kType, 2, batch, seq, heads, d_in, k_sb,
                      k_ss, k_sh, C::kBoxCols, C::kBlockN) ||
      !encode_qkv_map(&tm_v, v, kType, 2, batch, seq, heads, d_in, v_sb,
                      v_ss, v_sh, C::kBoxCols, C::kBlockN)) {
    return kErrTensorMap;
  }
  static std::atomic<bool> opted_in[64];
  cudaError_t err = opt_in(sm90::flash_fwd_kernel<C, T>,
                           sm90::kSmemBytes<C>, opted_in);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec_out = d_out % 2 == 0 &&
                      reinterpret_cast<uintptr_t>(o) % 4 == 0 &&
                      o_sb % 2 == 0 && o_ss % 2 == 0 && o_sh % 2 == 0;
  int sms = 0;
  err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  // Persistent: one CTA an SM at most, each walking its units.
  const int64_t units = static_cast<int64_t>(batch) * heads *
                        ((seq + C::kBlockM - 1) / C::kBlockM);
  const int grid = static_cast<int>(units < sms ? units : sms);
  sm90::flash_fwd_kernel<C, T><<<grid, C::kThreads, sm90::kSmemBytes<C>,
                                 static_cast<cudaStream_t>(stream)>>>(
      tm_q, tm_k, tm_v, static_cast<const float*>(bias), static_cast<T*>(o),
      batch, seq, heads, d_out, o_sb, o_ss, o_sh, bias_sb, sm_scale, causal,
      vec_out);
  return static_cast<int>(cudaGetLastError());
}


// `kh` / `vt`: the pre-pass's halves of k and v (client_tpu_split_kv_f32 at
// dk = C::kHeadDim), s_pad keys a row.
template <class C>
int launch_tf32(const void* q, const void* bias, void* o, int batch, int seq,
                int heads, int d_in, int d_out, int64_t q_sb, int64_t q_ss,
                int64_t q_sh, int64_t o_sb, int64_t o_ss, int64_t o_sh,
                int64_t bias_sb, float sm_scale, int causal, const void* kh,
                const void* vt, int s_pad, void* stream) {
  if (kh == nullptr || vt == nullptr || s_pad < seq ||
      s_pad % tf32::kSplitKeys != 0) {
    return kErrSplit;
  }
  if (tensor_map_encoder() == nullptr) return kErrNoEncoder;
  CUtensorMap tm_q, tm_k, tm_vt;
  const int z = 2 * batch * heads;  // big halves, then small
  if (!encode_qkv_map(&tm_q, q, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, batch,
                      seq, heads, d_in, q_sb, q_ss, q_sh, 32, C::kBlockM) ||
      !encode_split_map(&tm_k, kh, C::kHeadDim, s_pad, z, 32, C::kBlockN) ||
      !encode_split_map(&tm_vt, vt, s_pad, C::kHeadDim, z, C::kBlockN,
                        C::kHeadDim)) {
    return kErrTensorMap;
  }
  static std::atomic<bool> opted_in[64];
  cudaError_t err = opt_in(tf32::flash_fwd_tf32_kernel<C>,
                           tf32::kSmemBytes<C>, opted_in);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec_out = d_out % 2 == 0 &&
                      reinterpret_cast<uintptr_t>(o) % 8 == 0 &&
                      o_sb % 2 == 0 && o_ss % 2 == 0 && o_sh % 2 == 0;
  dim3 grid(batch * heads, (seq + C::kBlockM - 1) / C::kBlockM);
  tf32::flash_fwd_tf32_kernel<C><<<grid, C::kThreads, tf32::kSmemBytes<C>,
                                   static_cast<cudaStream_t>(stream)>>>(
      tm_q, tm_k, tm_vt, static_cast<const float*>(bias),
      static_cast<float*>(o), batch, seq, heads, d_out, o_sb, o_ss, o_sh,
      bias_sb, sm_scale, causal, vec_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The arguments of both entry points: q/k/v strided [B, S, H, d_in] views
// with unit stride along the head dim, 16-byte aligned rows and strides
// (in elements) that are multiples of 16 bytes, d_in * element size a
// multiple of 16 bytes (the Python wrapper checks, and pads a copy where
// they are not); o [B, S, H, d_out] (d_out <= d_in <= 256: the columns
// past d_out, zeros the caller padded, are dropped); `bias` may be null.
// The instantiation is the smallest head dim of 32, 64, 128 and 256 (bf16
// and fp16 also 96) that holds d_in. Launch on `stream`; returns 0 when launched, else a
// cudaError_t or one of this file's codes (client_tpu_cuda_error_string
// names both).

// fp32 q/k/v/o. Above head dim 64 the kernel reads k and v only through
// `kh` and `vt`, the pre-pass's halves of them (client_tpu_split_kv_f32 at
// dk 128 or 256, the instantiation), with s_pad keys a row.
extern "C" int client_tpu_flash_attention_fwd_f32(
    const void* q, const void* k, const void* v, const void* bias, void* o,
    int batch, int seq, int heads, int d_in, int d_out, int64_t q_sb,
    int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh,
    int64_t v_sb, int64_t v_ss, int64_t v_sh, int64_t o_sb, int64_t o_ss,
    int64_t o_sh, int64_t bias_sb, float sm_scale, int causal,
    const void* kh, const void* vt, int s_pad, void* stream) {
  if (d_out < 1 || d_out > d_in || d_in > kMaxHeadDim) return kErrHeadDim;
#define CLIENT_TPU_F32_ARGS                                                   \
  q, k, v, bias, o, batch, seq, heads, d_in, d_out, q_sb, q_ss, q_sh, k_sb,   \
      k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh, bias_sb, sm_scale,      \
      causal, stream
#define CLIENT_TPU_TF32_ARGS                                                  \
  q, bias, o, batch, seq, heads, d_in, d_out, q_sb, q_ss, q_sh, o_sb, o_ss,   \
      o_sh, bias_sb, sm_scale, causal, kh, vt, s_pad, stream
  if (d_in <= 32) return launch_f32<32, 64>(CLIENT_TPU_F32_ARGS);
  if (d_in <= 64) return launch_f32<64, 64>(CLIENT_TPU_F32_ARGS);
  if (d_in <= 128) return launch_tf32<tf32::Config128>(CLIENT_TPU_TF32_ARGS);
  return launch_tf32<tf32::Config256>(CLIENT_TPU_TF32_ARGS);
#undef CLIENT_TPU_F32_ARGS
#undef CLIENT_TPU_TF32_ARGS
}

// The fp32 kernel's pre-pass: k and v (strided [B, S, H, d_in] views as
// above) into kh [2, B, H, s_pad, dk] and vt [2, B, H, dk, s_pad], their
// TF32 big and small halves, V transposed with its keys permuted in groups
// of 8 (d_in <= dk <= 256, both multiples of 4; s_pad a multiple of 32 and
// at least S).
extern "C" int client_tpu_split_kv_f32(
    const void* k, const void* v, void* kh, void* vt, int batch, int seq,
    int heads, int d_in, int dk, int s_pad, int64_t k_sb, int64_t k_ss,
    int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh, void* stream) {
  if (d_in < 1 || d_in > dk || dk > kMaxHeadDim || d_in % 4 != 0 ||
      dk % 4 != 0) {
    return kErrHeadDim;
  }
  if (s_pad < seq || s_pad % tf32::kSplitKeys != 0) return kErrSplit;
  dim3 grid(s_pad / tf32::kSplitKeys, heads, batch);
  tf32::split_kv_kernel<<<grid, tf32::kSplitThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(kh), static_cast<float*>(vt), batch, seq, heads,
      d_in, dk, s_pad, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh);
  return static_cast<int>(cudaGetLastError());
}

// The dynamic shared memory of an fp32 launch at head dim d_in (<= 256).
extern "C" int client_tpu_flash_attention_f32_smem_bytes(int d_in) {
  if (d_in <= 32) return sizeof(f32::Smem<32, 64>);
  if (d_in <= 64) return sizeof(f32::Smem<64, 64>);
  if (d_in <= 128) return tf32::kSmemBytes<tf32::Config128>;
  return tf32::kSmemBytes<tf32::Config256>;
}

#define CLIENT_TPU_16_ARGS                                                    \
  q, k, v, bias, o, batch, seq, heads, d_in, d_out, q_sb, q_ss, q_sh, k_sb,   \
      k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh, bias_sb, sm_scale,      \
      causal, stream
#define CLIENT_TPU_16_PARAMS                                                  \
  const void *q, const void *k, const void *v, const void *bias, void *o,     \
      int batch, int seq, int heads, int d_in, int d_out, int64_t q_sb,       \
      int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh,   \
      int64_t v_sb, int64_t v_ss, int64_t v_sh, int64_t o_sb, int64_t o_ss,   \
      int64_t o_sh, int64_t bias_sb, float sm_scale, int causal, void *stream

namespace {

template <typename T>
int launch_16_head_dim(CLIENT_TPU_16_PARAMS) {
  if (d_out < 1 || d_out > d_in || d_in > kMaxHeadDim) return kErrHeadDim;
  if (d_in <= 32) return launch_16<sm90::Config32, T>(CLIENT_TPU_16_ARGS);
  if (d_in <= 64) return launch_16<sm90::Config64, T>(CLIENT_TPU_16_ARGS);
  if (d_in <= 96) return launch_16<sm90::Config96, T>(CLIENT_TPU_16_ARGS);
  if (d_in <= 128) return launch_16<sm90::Config128, T>(CLIENT_TPU_16_ARGS);
  return launch_16<sm90::Config256, T>(CLIENT_TPU_16_ARGS);
}

}  // namespace

// bf16 q/k/v/o.
extern "C" int client_tpu_flash_attention_fwd(CLIENT_TPU_16_PARAMS) {
  return launch_16_head_dim<bf16>(CLIENT_TPU_16_ARGS);
}

// fp16 q/k/v/o: the bf16 kernel's instantiations on f16 wgmma and f16 TMA
// maps.
extern "C" int client_tpu_flash_attention_fwd_f16(CLIENT_TPU_16_PARAMS) {
  return launch_16_head_dim<__half>(CLIENT_TPU_16_ARGS);
}
#undef CLIENT_TPU_16_ARGS
#undef CLIENT_TPU_16_PARAMS

extern "C" const char* client_tpu_cuda_error_string(int code) {
  if (code == kErrNoEncoder) {
    return "the CUDA driver has no cuTensorMapEncodeTiled (TMA needs CUDA 12)";
  }
  if (code == kErrTensorMap) {
    return "cuTensorMapEncodeTiled refused a q/k/v tensor map";
  }
  if (code == kErrHeadDim) {
    return "the flash attention kernel takes head dims 1 to 256";
  }
  if (code == kErrSplit) {
    return "the fp32 kernel above head dim 64 needs the pre-pass's halves "
           "of k and v (s_pad a multiple of 32, at least S)";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
