// Flash-attention forward in bf16 at head dims 64 and 128 for the H100 (sm_90a): asynchronous warpgroup products
// (wgmma), TMA loads and warp specialisation, so that the exponentials run while the tensor cores run.
//
// Replaces the TPU kernel alg_tpu/ops/flash_attention.py:_fwd_kernel on every bf16 call at D = 64 or 128 without
// a bias (ops/flash_attention.py:kernel_route). At D = 64: the self-attention of the CogVideoX and CogVideoX-1.5
// DiTs, their training forward with the LSE, the ring's LSE calls, CLIP-L vision in bf16. At D = 128: the Wan
// DiT's self-attention and its two cross-attentions (to the text and to the image tokens), its training forward
// with the LSE, the HunyuanVideo DiT's joint attention with kv_len and its token refiner, Llama's causal attention
// with kv_len, the ring's calls. A call with a bias (T5, UMT5), or at D = 80, keeps flash_attention_tc.cu. The
// semantics are that kernel's: `stable` (running max) or not (bounded logits, no max); a per-batch key count
// kv_len [B] read on the device; Sq != Sk; `causal` (query i sees key j iff j <= i + (Sk - Sq)); the base-2 row
// log-sum-exp (`lse`). P is rounded to bf16 before P·V, as the TPU kernel does (p.astype(v.dtype)), and the
// denominator, with it the LSE, is the TPU kernel's: at D = 64, where that kernel sums the rows on its matrix unit
// through a ones column appended to V, the sum of the bf16-rounded p, fp32-accumulated, here one more wgmma of each
// P step against a tile of ones; at D = 128 the sum of the fp32 p, here in registers in the softmax and across a
// row's four lanes at the end. A running max of -inf takes 0 for the exponentials; a row with no visible key
// writes zeros and an LSE of -inf. The exponentials are ex2.approx.ftz: a p below 2^-126 is 0.
//
// Bound on the H100: a (query, key) pair costs 4·D tensor-core FLOPs (q·kᵀ and P·V; 989 TFLOP/s in bf16, about
// 16 pairs a clock an SM at D = 64, 8 at D = 128) and one exp2 on the MUFU unit (16 a clock an SM). At D = 64 the
// two bounds are even: at [2,48,17776,64] 7.85 ms of products and 8.2 ms of exponentials. At D = 128 the
// products weigh twice the exponentials: at [3,40,32760,128] (the Wan DiT's 3-pass step) 66.7 ms of products
// against about 35 ms of exp2. The bytes are 60-300 times fewer (Wan's cross-attention to 257 keys, whose q and
// output are as many bytes as its products take time, aside). A kernel that runs the softmax and the products one
// after the other, as flash_attention_tc.cu does, cannot pass about half of the tensor-core bound; the two units
// have to run at once.
//
// Design (after FlashAttention-3, Shah et al. 2024). A block of kConsumers + 1 warpgroups takes 64 query rows a
// consumer warpgroup of one (batch, head) and walks its keys in tiles of 128. The head dim sets the block's
// shape (Cfg below): at D = 64 three consumers of 160 registers (192 rows a block: each K and V tile read from L2
// once for 192 rows); at D = 128 two consumers of 240 (128 rows), whose S (64 registers), O (64) and P (32) fit
// with the intra-warpgroup overlap below, as in FA3 at this head dim.
//  - Producer: the last warpgroup lowers its registers (setmaxnreg) and one of its threads issues TMA loads: the
//    block's q tile once, then K and V tiles into a ring of kStages stages in shared memory, each signalled by an
//    mbarrier that counts the bytes landed; a consumer warp's arrival on the stage's "empty" mbarrier frees it.
//    The tensor maps are 3-D, [B·H, S, D], read in boxes of [rows, 64] with the 128-byte swizzle, so TMA
//    zero-fills the ragged end of a head and never reads the next one. The 128-byte swizzle spans 128-byte rows,
//    64 values: at D = 128 a tile is two boxes, one for each half of D, each a swizzled sub-tile of its own.
//  - Consumers raise their registers (setmaxnreg). For each key tile: S = q·kᵀ by wgmma.m64n128k16 with both
//    operands in shared memory (D / 16 k16 steps, 32 bytes into the rows of a sub-tile each); the mask,
//    p = exp2(s·scale·log2e) (less the running max when stable, which rescales O first) in the accumulator
//    registers; P rounded to bf16 pairs, which are already the A operand's register layout; O += P·V by
//    wgmma.m64n{D}k16 with V an MN-major operand in shared memory (at D = 128 the leading byte offset of the
//    descriptor steps from one half of D to the other); at D = 64 the row sums of the rounded P by
//    wgmma.m64n8k16 against a tile of ones.
//  - Overlap: a consumer issues the next tile's q·kᵀ together with this tile's P·V, and runs the next tile's
//    softmax while its P·V is on the tensor cores (intra-warpgroup pipelining); the consumers issue their
//    products in turn through named barriers (ping-pong), so one warpgroup's exponentials run under another's
//    products.
// At D = 64 this reaches 61% of the tensor-core bound at [2,48,17776,64], 55% at [2,48,45106,64], against the
// mma.sync kernel's 31%; with the exponentials taken out it reaches only 70%, so exp2 no longer sets the pace,
// and computing a share of them on the FMA pipe (a polynomial) made it slower (PERF.md). At D = 128 it reaches, on
// an H100 80GB HBM3, 75-76% at [3,40,32760,128] (88 ms against the mma.sync kernel's 191-199), 46-48% for the
// cross-attention to 512 keys and 28-29% to 257, where each block's start and its q and output bytes weigh against
// 3-4 key tiles. There P·V as one m64n128k16 a k16 step beat two m64n64k16 (72%), and a third stage (224 KB) gained
// nothing (74%). The producer keeps 24 registers at D = 128, not 32: a block of 384 threads is launched with 168 a
// thread, 64,512 in all.
// Masks: row i of batch b sees keys j < min(Sk, kv_len[b], i + (Sk - Sq) + 1), the last term only when causal.
// The block's key loop ends at its last row's limit; tiles that every row of the block sees whole skip the mask.
// Causal blocks run longest first. Rows past Sq are zero-filled by TMA, computed and not written.
#include <cuda.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using alg::mma::pack_bf16;
using alg::mma::smem_addr;

// The compile-time shape of each head dim's instantiation.
template <int kD>
struct Cfg {
  static_assert(kD == 64 || kD == 128, "head dims 64 and 128");
  static constexpr int kConsumers = kD == 64 ? 3 : 2;         // consumer warpgroups, 64 query rows each
  static constexpr int kThreads = 128 * (kConsumers + 1);
  static constexpr int kBlockQ = 64 * kConsumers;             // query rows a block
  static constexpr int kBlockK = 128;                         // keys a tile
  static constexpr int kStages = 2;                           // K and V tiles in flight
  static constexpr bool kOnesSum = kD == 64;                  // Σ bf16(p) against ones; else Σ p in registers
  static constexpr int kHalves = kD / 64;                     // 128-byte swizzled sub-tiles a row of D
  static constexpr int kSubQ = kBlockQ * 128;                 // bytes of a q sub-tile ...
  static constexpr int kSubTile = kBlockK * 128;              // ... and of a K or V one
  static constexpr int kQBytes = kHalves * kSubQ;
  static constexpr int kTileBytes = kHalves * kSubTile;
  static constexpr int kOnesBytes = kOnesSum ? 512 : 0;       // bf16 ones: the B operand of the row sums
  // shared memory, from a 1024-byte aligned base (the swizzle's atom): q, K stages, V stages, ones, mbarriers
  static constexpr int kOffK = kQBytes;
  static constexpr int kOffV = kOffK + kStages * kTileBytes;
  static constexpr int kOffOnes = kOffV + kStages * kTileBytes;
  static constexpr int kOffBar = kOffOnes + kOnesBytes;
  static constexpr int kBars = 1 + 4 * kStages;               // q full; K full, K empty, V full, V empty a stage
  static constexpr int kSmemBytes = kOffBar + 8 * kBars + 1024;  // and the slack to align the base
  // registers a thread after setmaxnreg: the producer's few and the consumers' S, O and P. Their sum is the
  // pool the block is launched with, 65,536 / kThreads a thread rounded down to 8: 128 at 512 threads, 168 at 384
  static constexpr int kProducerRegs = kD == 64 ? 32 : 24;
  static constexpr int kConsumerRegs = kD == 64 ? 160 : 240;
  static_assert(kProducerRegs * 128 + kConsumerRegs * 128 * kConsumers <= (65536 / kThreads) / 8 * 8 * kThreads,
                "registers of one SM");
  static_assert(kSmemBytes <= 227 * 1024, "shared memory of one block");
  static_assert(kSubQ % 1024 == 0 && kSubTile % 1024 == 0, "sub-tiles start on swizzle atoms");
};

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kNotCausal = 1 << 30;  // causal_offset of a call without the causal mask

// -- PTX: mbarriers, TMA, warpgroup products --------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {  // arrive, and expect `bytes` to land
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {  // until the phase of `parity` completes
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// a [1, rows, 64] box of a 3-D tensor map at (col, row, bh) into shared memory, completing on mbarrier `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int col, int row, int bh,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(bh), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void named_sync(int id) {  // a ping-pong hand-over between two warpgroups
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving reads or writes of registers that an asynchronous product owns across the
// wgmma instructions around this point
template <int N>
__device__ __forceinline__ void own(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void own(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// Shared-memory matrix descriptors. A sub-tile written by TMA with the 128-byte swizzle: 128-byte rows in atoms
// of 8 rows (1,024 bytes, the stride byte offset) that follow each other. Read K-major (q and K: the reduction
// dim, D, contiguous) a k16 step starts 32 bytes further into the rows; read MN-major (V: the reduction dim,
// keys, across rows) 16 rows, two atoms, further. The leading byte offset `lbo` is read only where a product
// spans more than one sub-tile along its rows: MN-major at N = 128, where it steps from one half of D to the
// other.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo = 16) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}
// the ones, unswizzled and K-major: two 8 x 16-byte core matrices along K, 128 bytes apart
__device__ __forceinline__ uint64_t desc_ones(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) | ((uint64_t)(256 >> 4) << 32);
}

// d (64 x 128, fp32) = A·Bᵀ, plus d when accumulate != 0: A (64 x 16) and B (128 x 16) K-major in shared memory
__device__ __forceinline__ void wgmma_qk(float (&d)[64], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]),
        "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]),
        "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x 64, fp32) += A·B: A (64 x 16) bf16 in registers, B (16 x 64) MN-major in shared memory
__device__ __forceinline__ void wgmma_pv(float (&d)[32], const uint32_t* a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]),
        "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d (64 x 128, fp32) += A·B: A (64 x 16) bf16 in registers, B (16 x 128) MN-major in shared memory, its two
// 64-column halves `lbo` bytes apart
__device__ __forceinline__ void wgmma_pv(float (&d)[64], const uint32_t* a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]),
        "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]),
        "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d (64 x 8, fp32) += A·B: A (64 x 16) bf16 in registers, B (16 x 8) K-major in shared memory
__device__ __forceinline__ void wgmma_n8(float (&d)[4], const uint32_t* a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// A consumer thread's registers follow the wgmma accumulator layout: warp w of the warpgroup holds rows
// 16w..16w+15 of its 64, lane l rows g = l / 4 and g + 8 and, of each 8 columns j, columns 8j + 2 (l % 4) and
// one more: acc[4j + 2h + e] is row g + 8h, column 8j + 2 (l % 4) + e. The bf16 pairs of S's columns 16kk to
// 16kk + 15 are the A operand of P·V's k16 step kk.
template <int kD, bool kStable>
__global__ void __launch_bounds__(Cfg<kD>::kThreads, 1)
flash_fwd_tc_kernel_wgmma(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v, const int* __restrict__ kv_len,
                          bf16* __restrict__ out, float* __restrict__ lse, int heads, int sq, int sk,
                          int causal_offset, float scale_log2) {
  using C = Cfg<kD>;
  constexpr int kConsumers = C::kConsumers, kBlockQ = C::kBlockQ, kBlockK = C::kBlockK, kStages = C::kStages;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t s_q = base, s_k = base + C::kOffK, s_v = base + C::kOffV, s_ones = base + C::kOffOnes;
  const uint32_t bar_q = base + C::kOffBar;
  auto k_full = [&](int s) { return bar_q + 8 * (1 + s); };
  auto k_empty = [&](int s) { return bar_q + 8 * (1 + kStages + s); };
  auto v_full = [&](int s) { return bar_q + 8 * (1 + 2 * kStages + s); };
  auto v_empty = [&](int s) { return bar_q + 8 * (1 + 3 * kStages + s); };

  const int bh = blockIdx.y, b = bh / heads;
  const bool causal = causal_offset != kNotCausal;
  const int tile = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;  // causal: longest blocks first
  const int q0 = tile * kBlockQ;
  const int n_keys = kv_len == nullptr ? sk : max(0, min(sk, kv_len[b]));
  auto keys_of = [&](int row) {  // keys row `row` sees
    return row >= sq ? 0 : causal ? max(0, min(n_keys, row + causal_offset + 1)) : n_keys;
  };
  const int block_keys = keys_of(min(sq, q0 + kBlockQ) - 1);  // the block's last row's limit: the loop bound
  const int whole_keys = keys_of(q0);                         // keys every row of the block sees
  const int n_tiles = (block_keys + kBlockK - 1) / kBlockK;
  const int warpgroup = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), 4 * kConsumers);  // one arrival a consumer warp
      mbar_init(v_empty(s), 4 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (C::kOnesSum) {
    for (int i = threadIdx.x; i < C::kOnesBytes / 4; i += C::kThreads)
      reinterpret_cast<uint32_t*>(smem_raw + (s_ones - raw))[i] = 0x3f803f80u;  // two bf16 ones
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the ones, visible to wgmma
  }
  __syncthreads();

  if (warpgroup == kConsumers) {  // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(C::kProducerRegs));
    if (threadIdx.x == 128 * kConsumers && n_tiles > 0) {
      mbar_expect_tx(bar_q, C::kQBytes);
#pragma unroll
      for (int h = 0; h < C::kHalves; ++h) tma_load(s_q + h * C::kSubQ, &tm_q, 64 * h, q0, bh, bar_q);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        const uint32_t parity = ((t / kStages) & 1) ^ 1;  // a stage's first use waits for nothing
        mbar_wait(k_empty(s), parity);
        mbar_expect_tx(k_full(s), C::kTileBytes);
#pragma unroll
        for (int h = 0; h < C::kHalves; ++h)
          tma_load(s_k + s * C::kTileBytes + h * C::kSubTile, &tm_k, 64 * h, t * kBlockK, bh, k_full(s));
        mbar_wait(v_empty(s), parity);
        mbar_expect_tx(v_full(s), C::kTileBytes);
#pragma unroll
        for (int h = 0; h < C::kHalves; ++h)
          tma_load(s_v + s * C::kTileBytes + h * C::kSubTile, &tm_v, 64 * h, t * kBlockK, bh, v_full(s));
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(C::kConsumerRegs));
  const int wg = warpgroup, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int col = 2 * (lane % 4);
  const int row0 = q0 + 64 * wg + 16 * warp + lane / 4;  // this thread's rows: row0 and row0 + 8
  const int lim[2] = {keys_of(row0), keys_of(row0 + 8)};
  // ping-pong: warpgroup wg issues its products after the one before it (the last before the first)
  const int my_turn = 1 + wg, next_turn = 1 + (wg + 1) % kConsumers;
  const uint64_t d_q = desc_sw128(s_q + wg * 64 * 128), d_ones = desc_ones(s_ones);

  // S, O (kD columns), P; the row sums: at D = 64 the n8 tile of Σ bf16(p), at D = 128 a lane's share of Σ p
  float s[64], o[kD / 2], l[C::kOnesSum ? 4 : 2], m[2] = {-INFINITY, -INFINITY}, alpha[2] = {1.0f, 1.0f};
  uint32_t p[32];
#pragma unroll
  for (int i = 0; i < 64; ++i) s[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) o[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < (C::kOnesSum ? 4 : 2); ++i) l[i] = 0.0f;

  auto release = [&](uint32_t bar) {  // this warp is done with a stage
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  auto own_acc = [&]() {  // O and, at D = 64, the row sums: the registers P·V writes
    own(o);
    if constexpr (C::kOnesSum) own(l);
  };
  auto issue_qk = [&](int stage) {
    const uint64_t d_k = desc_sw128(s_k + stage * C::kTileBytes);
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {  // 32 bytes a k16 step, 4 steps a sub-tile
      const int sub = kk / 4, step = 2 * (kk % 4);
      wgmma_qk(s, d_q + sub * (C::kSubQ >> 4) + step, d_k + sub * (C::kSubTile >> 4) + step, kk);
    }
  };
  auto issue_pv = [&](int stage) {
    const uint32_t v0 = s_v + stage * C::kTileBytes;
    if constexpr (kD == 64) {
      const uint64_t d_v = desc_sw128(v0);
#pragma unroll
      for (int kk = 0; kk < kBlockK / 16; ++kk) {
        wgmma_pv(o, p + 4 * kk, d_v + 128 * kk);  // 16 rows of 128 bytes a k16 step
        wgmma_n8(l, p + 4 * kk, d_ones);
      }
    } else {
      const uint64_t d_v = desc_sw128(v0, C::kSubTile);  // the second half of D a sub-tile further
#pragma unroll
      for (int kk = 0; kk < kBlockK / 16; ++kk) wgmma_pv(o, p + 4 * kk, d_v + 128 * kk);
    }
  };
  // the mask, p = exp2 of the scaled logits (less the running max when stable) in s, alpha the factor that
  // takes O and the row sums to the new max; at D = 128 the row sums of the fp32 p taken here
  auto softmax = [&](int t) {
    const int k0 = t * kBlockK;
    if (k0 + kBlockK > whole_keys) {
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + 8 * j + col + (e & 1) >= lim[e >> 1]) s[4 * j + e] = -INFINITY;
    }
    if constexpr (kStable) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < 16; ++j) mx = fmaxf(mx, fmaxf(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[h], mx * scale_log2);
        // all logits so far -inf: take 0, so that p = exp2(-inf) = 0
        const float m_exp = m_new == -INFINITY ? 0.0f : m_new;
        alpha[h] = ex2(m[h] - m_exp);  // 0 while the old max is -inf
        m[h] = m_new;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          s[4 * j + 2 * h] = ex2(fmaf(s[4 * j + 2 * h], scale_log2, -m_exp));
          s[4 * j + 2 * h + 1] = ex2(fmaf(s[4 * j + 2 * h + 1], scale_log2, -m_exp));
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < 64; ++i) s[i] = ex2(s[i] * scale_log2);
    }
    if constexpr (!C::kOnesSum) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float sum = 0.0f;
#pragma unroll
        for (int j = 0; j < 16; ++j) sum += s[4 * j + 2 * h] + s[4 * j + 2 * h + 1];
        l[h] = (kStable ? l[h] * alpha[h] : l[h]) + sum;
      }
    }
  };
  auto rescale_and_pack = [&]() {  // O and the ones' sums to the new max; P to bf16 pairs
    if constexpr (kStable) {
#pragma unroll
      for (int i = 0; i < kD / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      if constexpr (C::kOnesSum) {
#pragma unroll
        for (int i = 0; i < 4; ++i) l[i] *= alpha[i >> 1];
      }
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
  };

  if (n_tiles > 0) {
    if (wg == kConsumers - 1) named_arrive(1);  // the first warpgroup goes first
    mbar_wait(bar_q, 0);
    mbar_wait(k_full(0), 0);
    named_sync(my_turn);
    wgmma_fence();
    issue_qk(0);
    wgmma_commit();
    named_arrive(next_turn);
    wgmma_wait<0>();
    own(s);
    release(k_empty(0));
    softmax(0);
    rescale_and_pack();
    for (int t = 1; t < n_tiles; ++t) {
      const int sk_t = t % kStages, sv = (t - 1) % kStages;
      mbar_wait(k_full(sk_t), (t / kStages) & 1);
      named_sync(my_turn);
      own_acc();
      own(p);
      wgmma_fence();
      issue_qk(sk_t);  // the next tile's q·kᵀ ...
      wgmma_commit();
      mbar_wait(v_full(sv), ((t - 1) / kStages) & 1);
      issue_pv(sv);    // ... with this tile's P·V
      wgmma_commit();
      named_arrive(next_turn);
      wgmma_wait<1>();  // q·kᵀ has landed; P·V runs on under the softmax
      own(s);
      release(k_empty(sk_t));
      softmax(t);
      wgmma_wait<0>();
      own_acc();
      own(p);
      release(v_empty(sv));
      rescale_and_pack();
    }
    const int sv = (n_tiles - 1) % kStages;
    mbar_wait(v_full(sv), ((n_tiles - 1) / kStages) & 1);
    named_sync(my_turn);
    own_acc();
    own(p);
    wgmma_fence();
    issue_pv(sv);
    wgmma_commit();
    if (wg != kConsumers - 1) named_arrive(next_turn);  // the last hand-over of the ring is not taken
    wgmma_wait<0>();
    own_acc();
    release(v_empty(sv));
  }

  float lsum[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if constexpr (C::kOnesSum) {
      lsum[h] = l[2 * h];  // every column of the row sums' tile holds the row's sum
    } else {                // the four lanes of a row hold its columns
      lsum[h] = l[h] + __shfl_xor_sync(0xffffffffu, l[h], 1);
      lsum[h] += __shfl_xor_sync(0xffffffffu, lsum[h], 2);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row >= sq) continue;
    const float inv = 1.0f / (lsum[h] == 0.0f ? 1.0f : lsum[h]);  // a row with no visible key: o = 0
    bf16* orow = out + ((long long)bh * sq + row) * kD + col;
#pragma unroll
    for (int j = 0; j < kD / 8; ++j)
      alg::store2(orow + 8 * j, o[4 * j + 2 * h] * inv, o[4 * j + 2 * h + 1] * inv);
    if (lse != nullptr && lane % 4 == 0) {
      // l is taken against the running max when stable (0 while that is -inf), against 0 otherwise
      const float base2 = (kStable && m[h] != -INFINITY) ? m[h] : 0.0f;
      lse[(long long)bh * sq + row] = lsum[h] == 0.0f ? -INFINITY : base2 + log2f(lsum[h]);
    }
  }
}

// cuTensorMapEncodeTiled, a driver function, found through the runtime so that the library links no -lcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* found = nullptr;
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &found, cudaEnableDefault, &status) == cudaSuccess &&
        status == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(found);
  }
  return fn;
}

// [bh, rows, kD] bf16, contiguous, read in [box_rows, 64] boxes with the 128-byte swizzle, zeros past `rows`
template <int kD>
bool encode(CUtensorMap* map, const void* ptr, int bh, int rows, int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)kD, (cuuint64_t)rows, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)2 * kD, (cuuint64_t)rows * 2 * kD};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t steps[3] = {1, 1, 1};
  return encoder()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box, steps,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int kD, bool kStable>
cudaError_t launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv, const void* kv_len,
                   void* out, void* lse, int batch, int heads, int sq, int sk, int causal_offset, float scale,
                   cudaStream_t stream) {
  using C = Cfg<kD>;
  auto kernel = flash_fwd_tc_kernel_wgmma<kD, kStable>;
  // above 48 KB a block's dynamic shared memory needs this attribute, once per device and instantiation
  static unsigned long long configured = 0;  // a bit per device
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 64 && !((configured >> device) & 1ull)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
    if (err != cudaSuccess) return err;
    configured |= 1ull << device;
  }
  const dim3 grid((sq + C::kBlockQ - 1) / C::kBlockQ, batch * heads);
  kernel<<<grid, C::kThreads, C::kSmemBytes, stream>>>(tq, tk, tv, static_cast<const int*>(kv_len),
                                                       static_cast<bf16*>(out), static_cast<float*>(lse), heads, sq,
                                                       sk, causal_offset, scale * kLog2e);
  return cudaGetLastError();
}

template <int kD>
int run_forward(int dtype, const void* q, const void* k, const void* v, const void* bias, const void* kv_len,
                void* out, void* lse, int batch, int heads, int sq, int sk, float scale, int stable, int causal,
                void* stream) {
  if (dtype != alg::kBFloat16 || bias != nullptr || batch <= 0 || heads <= 0 || sq <= 0 || sk <= 0 ||
      (long long)batch * heads > 65535)
    return (int)cudaErrorInvalidValue;
  if (encoder() == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  const int bh = batch * heads;
  if (!encode<kD>(&tq, q, bh, sq, Cfg<kD>::kBlockQ) || !encode<kD>(&tk, k, bh, sk, Cfg<kD>::kBlockK) ||
      !encode<kD>(&tv, v, bh, sk, Cfg<kD>::kBlockK))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int causal_offset = causal != 0 ? sk - sq : kNotCausal;
  const cudaError_t err =
      stable ? launch<kD, true>(tq, tk, tv, kv_len, out, lse, batch, heads, sq, sk, causal_offset, scale, st)
             : launch<kD, false>(tq, tk, tv, kv_len, out, lse, batch, heads, sq, sk, causal_offset, scale, st);
  return (int)err;
}

}  // namespace

// alg_flash_attention_wgmma_fwd_d64 and _d128: the arguments of alg_flash_attention_tc_fwd_d64 and _d128
// (flash_attention_tc.cu), for the calls that take no bias. q/out: [B, H, Sq, D], k/v: [B, H, Sk, D], contiguous,
// 16-byte aligned bf16 (dtype must be alg::kBFloat16 and bias null; anything else returns cudaErrorInvalidValue).
// kv_len: null, or int32 [B] on the device. causal != 0: query i also sees no key past i + (Sk - Sq). lse: null,
// or fp32 [B, H, Sq] that receives each row's base-2 log-sum-exp. Returns the launch's cudaError_t
// (cudaErrorNotSupported where the driver offers no cuTensorMapEncodeTiled).
extern "C" int alg_flash_attention_wgmma_fwd_d64(int dtype, const void* q, const void* k, const void* v,
                                                 const void* bias, long long bias_b_stride, const void* kv_len,
                                                 void* out, void* lse, int batch, int heads, int sq, int sk,
                                                 float scale, int stable, int causal, void* stream) {
  (void)bias_b_stride;
  return run_forward<64>(dtype, q, k, v, bias, kv_len, out, lse, batch, heads, sq, sk, scale, stable, causal, stream);
}
extern "C" int alg_flash_attention_wgmma_fwd_d128(int dtype, const void* q, const void* k, const void* v,
                                                  const void* bias, long long bias_b_stride, const void* kv_len,
                                                  void* out, void* lse, int batch, int heads, int sq, int sk,
                                                  float scale, int stable, int causal, void* stream) {
  (void)bias_b_stride;
  return run_forward<128>(dtype, q, k, v, bias, kv_len, out, lse, batch, heads, sq, sk, scale, stable, causal, stream);
}
