// Flash-attention backward, dK and dV, in bf16 on the tensor cores: every
// bf16 call (fp32 calls keep the CUDA-core kernel of flash_attention_bwd.cu,
// and dQ stays there for both types). The build reads the next line and
// makes one object per head dim, each with its own C entry point.
//
// build-variants: ALG_FLASH_HEAD_DIM=64,80,128
//
// Replaces the TPU kernel alg_tpu/ops/flash_attention_bwd.py:_dkv_kernel for
// bf16 inputs (dense, causal, kv_len, Sq != Sk). Given q, k, v, the output
// cotangent dO, the forward's base-2 row log-sum-exp `lse` and
// delta_i = rowsum(dO_i ⊙ O_i), both fp32 [B, H, Sq]:
//
//   s_ij  = (q_i·k_j)·scale·log2e, masked like the forward
//   p_ij  = exp2(s_ij - lse_i)          (0 where masked)
//   dV_j  = Σ_i bf16(p_ij)·dO_i
//   dp_ij = dO_i·v_j,  ds_ij = p_ij·(dp_ij - delta_i)
//   dK_j  = scale·Σ_i bf16(ds_ij)·q_i
//
// P and dS are rounded to bf16 before their products, as the TPU kernel does
// (p_t.astype(do.dtype), ds_t.astype(q.dtype)); ds itself takes the fp32 p.
//
// Bound on the H100: tensor-core FLOPs, 8·H·D per visible (query, key) pair
// (four products) at 989 TFLOP/s in bf16.
//
// Design (after FlashAttention-2's backward, Dao 2023). One block of 4 warps
// per (b·h, tile of 64 keys), 16 keys a warp; the TPU grid's sequential
// query axis becomes a loop over query tiles of 64 rows (at D = 128 a few
// registers spill, and it is still faster than 32-row tiles without spills:
// PERF.md, PR 6's tiling variants). K and V are staged once; q, dO, lse and delta
// of the query tiles go through a two-stage cp.async ring (the next tile's
// copy overlaps this tile's math), swizzled as in mma.cuh. Per query tile a
// warp computes, all with mma.sync.m16n8k16 and its 16 keys as the M side:
// Sᵀ = K·qᵀ (K's A fragments held in registers at D = 64, read again by
// ldmatrix from shared memory at D = 80 and 128; qᵀ's B fragments by
// ldmatrix of q), Pᵀ with the masks, dV += Pᵀ·dO (Pᵀ as bf16 A fragments
// straight from the accumulators, dO's B fragments by ldmatrix.trans),
// dPᵀ = V·dOᵀ, dSᵀ = Pᵀ ⊙ (dPᵀ - delta), dK += dSᵀ·q. dK and dV stay fp32 in
// registers: each key has one owner, no atomics, one summation order.
//
// Masks, as in flash_attention_bwd.cu: key j is visible to query i of batch b
// iff j < min(Sk, kv_len[b]) and, when causal, j <= i + (Sk - Sq). The query
// loop starts at the first row that can see the block's first key; a block
// whose first key is at or past kv_len does nothing and writes zeros; rows
// past Sq are zero-filled and masked; a row with lse = -inf (no visible key)
// contributes nothing. Tiles that every (query, key) pair of the block sees
// skip the mask.
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

#ifndef ALG_FLASH_HEAD_DIM
#error "compile with -DALG_FLASH_HEAD_DIM=64, 80 or 128 (the build-variants line above)"
#endif

#define ALG_CAT_(a, b) a##b
#define ALG_CAT(a, b) ALG_CAT_(a, b)

namespace {

using bf16 = __nv_bfloat16;
using namespace alg::mma;

constexpr int kD = ALG_FLASH_HEAD_DIM;           // head dim
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBlockN = 16 * kWarps;             // keys a block
constexpr int kBlockM = 64;                      // queries a shared-memory tile
constexpr int kKSteps = kD / 16;                 // k16 steps over the head dim
constexpr int kDTiles = kD / 8;                  // n8 tiles of dK and dV
constexpr int kQTiles = kBlockM / 8;             // n8 tiles of Sᵀ and dPᵀ
constexpr bool kKVInRegisters = kD == 64;        // K's and V's A fragments held across the query loop
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kNotCausal = 1 << 30;              // causal_offset of a call without the causal mask

using TileD = alg::mma::Tile<kD>;
constexpr int kKVBytes = TileD::bytes(kBlockN);
constexpr int kQBytes = TileD::bytes(kBlockM);
constexpr int kStageBytes = 2 * kQBytes + 2 * kBlockM * 4;  // q, dO, lse, delta
constexpr int kSmemBytes = 2 * kKVBytes + 2 * kStageBytes;

static_assert(kD == 64 || kD == 80 || kD == 128, "head dims the port's models use");
static_assert(kDTiles % 2 == 0 && kQTiles % 2 == 0 && kBlockM % 16 == 0, "ldmatrix.x4 reads two n8 tiles at a time");
static_assert(kSmemBytes <= 227 * 1024, "shared memory of one block");

// One query tile's q, dO, lse and delta into a stage; rows at or past Sq are zero-filled.
__device__ __forceinline__ void stage_queries(uint32_t dst, const bf16* qp, const bf16* dop, const float* lsep,
                                              const float* deltap, int q0, int sq) {
  TileD::stage<kBlockM, kThreads>(dst, qp, q0, sq);
  TileD::stage<kBlockM, kThreads>(dst + kQBytes, dop, q0, sq);
  for (int i = threadIdx.x; i < 2 * kBlockM; i += kThreads) {
    const int r = i % kBlockM;
    const float* src = i < kBlockM ? lsep : deltap;
    const bool ok = q0 + r < sq;
    cp_async4(dst + 2 * kQBytes + 4 * i, ok ? src + q0 + r : src, ok);
  }
}

__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                        const bf16* __restrict__ dout, const float* __restrict__ lse,
                        const float* __restrict__ delta, const int* __restrict__ kv_len, bf16* __restrict__ dk,
                        bf16* __restrict__ dv, int heads, int sq, int sk, int causal_offset, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s_k = smem_addr(smem), s_v = s_k + kKVBytes, s_stages = s_v + kKVBytes;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.y;
  const int b = bh / heads;
  const bool causal = causal_offset != kNotCausal;
  const int key0 = blockIdx.x * kBlockN;  // the first key tiles see the most queries: longest blocks first as it is
  const int n_keys = kv_len == nullptr ? sk : max(0, min(sk, kv_len[b]));
  // queries below the first one that sees the block's first key see none of its keys
  int q_begin = key0 < n_keys ? 0 : sq;
  if (causal && q_begin == 0) q_begin = min(sq, max(0, key0 - causal_offset));
  const int n_tiles = (sq - q_begin + kBlockM - 1) / kBlockM;
  const bf16* qp = q + (long long)bh * sq * kD;
  const bf16* dop = dout + (long long)bh * sq * kD;
  const float* lsep = lse + (long long)bh * sq;
  const float* deltap = delta + (long long)bh * sq;
  const float scale_log2 = scale * kLog2e;

  TileD::stage<kBlockN, kThreads>(s_k, k + (long long)bh * sk * kD, key0, n_keys);
  TileD::stage<kBlockN, kThreads>(s_v, v + (long long)bh * sk * kD, key0, n_keys);
  cp_async_commit();
  if (n_tiles > 0) stage_queries(s_stages, qp, dop, lsep, deltap, q_begin, sq);
  cp_async_commit();

  // this lane's keys: key_of(hf) = key0 + 16 warp + lane / 4 + 8 hf
  const int wkey = 16 * warp;
  const int my_key = key0 + wkey + lane / 4;
  float dka[kDTiles][4], dva[kDTiles][4];
#pragma unroll
  for (int dt = 0; dt < kDTiles; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[dt][e] = dva[dt][e] = 0.0f;
  uint32_t kf[kKVInRegisters ? kKSteps : 1][4], vf[kKVInRegisters ? kKSteps : 1][4];

  for (int t = 0; t < n_tiles; ++t) {
    const int q0 = q_begin + t * kBlockM;
    if (t + 1 < n_tiles)  // the next tile's copy overlaps this tile's math
      stage_queries(s_stages + ((t + 1) & 1) * kStageBytes, qp, dop, lsep, deltap, q0 + kBlockM, sq);
    cp_async_commit();
    cp_async_wait<1>();  // K, V and this tile have landed
    __syncthreads();
    if constexpr (kKVInRegisters) {
      if (t == 0) {
#pragma unroll
        for (int kk = 0; kk < kKSteps; ++kk) {
          ldmatrix_x4(kf[kk], a_order<kD>(s_k, wkey, 2 * kk, lane));
          ldmatrix_x4(vf[kk], a_order<kD>(s_v, wkey, 2 * kk, lane));
        }
      }
    }
    const uint32_t s_q = s_stages + (t & 1) * kStageBytes, s_do = s_q + kQBytes;
    const float* lses = reinterpret_cast<const float*>(smem + (s_q - s_k) + 2 * kQBytes);
    const float* deltas = lses + kBlockM;

    // Sᵀ = K·qᵀ: [16 keys, kBlockM queries] a warp
    float st[kQTiles][4];
#pragma unroll
    for (int nt = 0; nt < kQTiles; ++nt) st[nt][0] = st[nt][1] = st[nt][2] = st[nt][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      uint32_t ka[4];
      if constexpr (kKVInRegisters) {
#pragma unroll
        for (int e = 0; e < 4; ++e) ka[e] = kf[kk][e];
      } else {
        ldmatrix_x4(ka, a_order<kD>(s_k, wkey, 2 * kk, lane));
      }
#pragma unroll
      for (int np = 0; np < kQTiles / 2; ++np) {
        uint32_t bq[4];
        ldmatrix_x4(bq, b_order<kD>(s_q, 16 * np, 2 * kk, lane));
        mma_bf16(st[2 * np], ka, bq[0], bq[1]);
        mma_bf16(st[2 * np + 1], ka, bq[2], bq[3]);
      }
    }

    // Pᵀ; a lane's columns are queries q0 + 8 nt + 2 (lane % 4) + {0, 1}, its rows keys my_key + 8 hf
    const bool whole = key0 + kBlockN <= n_keys && q0 + kBlockM <= sq &&
                       (!causal || key0 + kBlockN - 1 <= q0 + causal_offset);
#pragma unroll
    for (int nt = 0; nt < kQTiles; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * nt + 2 * (lane % 4) + (e & 1), key = my_key + 8 * (e >> 1);
        const float li = lses[col];
        const bool visible = whole || (key < n_keys && q0 + col < sq && (!causal || key <= q0 + col + causal_offset));
        st[nt][e] = visible && li != -INFINITY ? exp2f(st[nt][e] * scale_log2 - li) : 0.0f;
      }

    // dV += Pᵀ·dO: the accumulators of query tiles 2j and 2j + 1, as bf16 pairs, are the A fragment of step j
#pragma unroll
    for (int j = 0; j < kBlockM / 16; ++j) {
      const uint32_t pa[4] = {pack_bf16(st[2 * j][0], st[2 * j][1]), pack_bf16(st[2 * j][2], st[2 * j][3]),
                              pack_bf16(st[2 * j + 1][0], st[2 * j + 1][1]),
                              pack_bf16(st[2 * j + 1][2], st[2 * j + 1][3])};
#pragma unroll
      for (int dp = 0; dp < kDTiles / 2; ++dp) {
        uint32_t bo[4];
        ldmatrix_x4_trans(bo, a_order<kD>(s_do, 16 * j, 2 * dp, lane));
        mma_bf16(dva[2 * dp], pa, bo[0], bo[1]);
        mma_bf16(dva[2 * dp + 1], pa, bo[2], bo[3]);
      }
    }

    // dPᵀ = V·dOᵀ, then dSᵀ = Pᵀ ⊙ (dPᵀ - delta) in place
    float dpt[kQTiles][4];
#pragma unroll
    for (int nt = 0; nt < kQTiles; ++nt) dpt[nt][0] = dpt[nt][1] = dpt[nt][2] = dpt[nt][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      uint32_t va[4];
      if constexpr (kKVInRegisters) {
#pragma unroll
        for (int e = 0; e < 4; ++e) va[e] = vf[kk][e];
      } else {
        ldmatrix_x4(va, a_order<kD>(s_v, wkey, 2 * kk, lane));
      }
#pragma unroll
      for (int np = 0; np < kQTiles / 2; ++np) {
        uint32_t bo[4];
        ldmatrix_x4(bo, b_order<kD>(s_do, 16 * np, 2 * kk, lane));
        mma_bf16(dpt[2 * np], va, bo[0], bo[1]);
        mma_bf16(dpt[2 * np + 1], va, bo[2], bo[3]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < kQTiles; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dpt[nt][e] = st[nt][e] * (dpt[nt][e] - deltas[8 * nt + 2 * (lane % 4) + (e & 1)]);

    // dK += dSᵀ·q
#pragma unroll
    for (int j = 0; j < kBlockM / 16; ++j) {
      const uint32_t da[4] = {pack_bf16(dpt[2 * j][0], dpt[2 * j][1]), pack_bf16(dpt[2 * j][2], dpt[2 * j][3]),
                              pack_bf16(dpt[2 * j + 1][0], dpt[2 * j + 1][1]),
                              pack_bf16(dpt[2 * j + 1][2], dpt[2 * j + 1][3])};
#pragma unroll
      for (int dp = 0; dp < kDTiles / 2; ++dp) {
        uint32_t bq[4];
        ldmatrix_x4_trans(bq, a_order<kD>(s_q, 16 * j, 2 * dp, lane));
        mma_bf16(dka[2 * dp], da, bq[0], bq[1]);
        mma_bf16(dka[2 * dp + 1], da, bq[2], bq[3]);
      }
    }
    __syncthreads();  // this stage is read; the next iteration's copy may overwrite it
  }
  cp_async_wait<0>();

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int key = my_key + 8 * hf;
    if (key >= sk) continue;
    const long long at = ((long long)bh * sk + key) * kD + 2 * (lane % 4);
#pragma unroll
    for (int dt = 0; dt < kDTiles; ++dt) {
      alg::store2(dk + at + 8 * dt, dka[dt][2 * hf] * scale, dka[dt][2 * hf + 1] * scale);
      alg::store2(dv + at + 8 * dt, dva[dt][2 * hf], dva[dt][2 * hf + 1]);
    }
  }
}

cudaError_t launch(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                   const void* delta, const void* kv_len, void* dk, void* dv, int batch, int heads, int sq, int sk,
                   int causal_offset, float scale, cudaStream_t stream) {
  // above 48 KB a block's dynamic shared memory needs this attribute, once per device
  static unsigned long long configured = 0;  // a bit per device
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 64 && !((configured >> device) & 1ull)) {
    err = cudaFuncSetAttribute(flash_bwd_dkv_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return err;
    configured |= 1ull << device;
  }
  const dim3 grid((sk + kBlockN - 1) / kBlockN, batch * heads);
  flash_bwd_dkv_tc_kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(kv_len), static_cast<bf16*>(dk), static_cast<bf16*>(dv), heads, sq, sk,
      causal_offset, scale);
  return cudaGetLastError();
}

}  // namespace

// alg_flash_attention_bwd_dkv_tc_d<D>: the arguments of
// alg_flash_attention_bwd_dkv_d<D> (flash_attention_bwd.cu). q/dout:
// [B, H, Sq, D], k/v/dk/dv: [B, H, Sk, D], contiguous bf16 (dtype must be
// alg::kBFloat16; anything else returns cudaErrorInvalidValue); lse/delta:
// fp32 [B, H, Sq] (lse in base 2 of the scaled logits, -inf on a row with no
// visible key); kv_len: null, or int32 [B] on the device; causal != 0 hides
// from query i the keys past i + (Sk - Sq). `scale` is the softmax scale of
// the forward. Returns the launch's cudaError_t.
extern "C" int ALG_CAT(alg_flash_attention_bwd_dkv_tc_d, ALG_FLASH_HEAD_DIM)(
    int dtype, const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, const void* kv_len, void* dk, void* dv, int batch, int heads, int sq, int sk,
    float scale, int causal, void* stream) {
  if (dtype != alg::kBFloat16 || batch <= 0 || heads <= 0 || sq <= 0 || sk <= 0 ||
      (long long)batch * heads > 65535)
    return (int)cudaErrorInvalidValue;
  const int causal_offset = causal != 0 ? sk - sq : kNotCausal;
  return (int)launch(q, k, v, dout, lse, delta, kv_len, dk, dv, batch, heads, sq, sk, causal_offset, scale,
                     static_cast<cudaStream_t>(stream));
}
