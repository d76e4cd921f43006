// Flash-attention backward, dQ, in bf16 on the tensor cores: every bf16 call
// (fp32 calls keep the CUDA-core kernel of flash_attention_bwd.cu). The build
// reads the next line and makes one object per head dim, each with its own C
// entry point.
//
// build-variants: ALG_FLASH_HEAD_DIM=64,80,128
//
// Replaces the TPU kernel alg_tpu/ops/flash_attention_bwd.py:_dq_kernel for
// bf16 inputs (dense, causal, kv_len, Sq != Sk). Given q, k, v, the output
// cotangent dO, the forward's base-2 row log-sum-exp `lse` and
// delta_i = rowsum(dO_i ⊙ O_i), both fp32 [B, H, Sq]:
//
//   s_ij  = (q_i·k_j)·scale·log2e, masked like the forward
//   p_ij  = exp2(s_ij - lse_i)          (0 where masked)
//   dp_ij = dO_i·v_j,  ds_ij = p_ij·(dp_ij - delta_i)
//   dQ_i  = scale·Σ_j bf16(ds_ij)·k_j
//
// dS is rounded to bf16 before its product with K, as the TPU kernel does
// (ds_t.astype(k.dtype)): here that is the packing of the fp32 dS into the
// bf16 A fragments of the last product.
//
// Bound on the H100: tensor-core FLOPs, 6·H·D per visible (query, key) pair
// (three products) at 989 TFLOP/s in bf16; the bytes (q, dO, k, v, dQ once)
// are 100-300 times fewer at the DiT shapes.
//
// Design: the forward kernel's shape (flash_attention_tc.cu) without the
// online softmax, since the LSE is known. One block of 4 warps per (b·h, tile
// of query rows); a warp owns 16 query rows, two m16 row tiles at D = 64, so
// that each K and V fragment it reads from shared memory feeds two products
// there. q and dO are staged once in shared memory and their A fragments read
// into registers once; each row's lse and delta and the fp32 dQ accumulator
// also stay in registers. Every row has one owner: no atomics, one summation
// order. The block walks the keys in 64-key tiles, K and V staged by cp.async
// into a two-stage ring in dynamic shared memory, swizzled as in mma.cuh (the
// next tile's copy overlaps this tile's math). Each tile is taken 16 keys at a
// time, which keeps the live accumulators small: S = q·Kᵀ and dP = dO·Vᵀ by
// mma.sync.m16n8k16 (K's and V's B fragments by ldmatrix), P and dS on the
// accumulator fragments, dS packed to bf16 A fragments, and dQ += dS·K with
// K's B fragments by ldmatrix.trans of the same staged tile, so K is read from
// device memory once for both of its products.
//
// Masks, as in flash_attention_bwd.cu: key j is visible to query i of batch
// b iff j < min(Sk, kv_len[b]) and, when causal, j <= i + (Sk - Sq). The
// block's key loop ends at its last row's limit; keys past it are zero-filled
// in shared memory (cp.async with a source size of 0: no host padding, no
// host read of kv_len) and masked; tiles that every row of the block sees
// whole skip the mask. Causal blocks run longest first. A row past Sq or with
// lse = -inf (no visible key) has p = 0 and gets dQ = 0; dQ·scale is rounded
// to bf16 once, at the end.
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

constexpr int kD = ALG_FLASH_HEAD_DIM;         // head dim
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowTiles = kD == 64 ? 2 : 1;    // m16 row tiles a warp
constexpr int kWarpRows = 16 * kRowTiles;
constexpr int kBlockQ = kWarps * kWarpRows;    // query rows a block
constexpr int kBlockK = 64;                    // keys a shared-memory tile
constexpr int kKSteps = kD / 16;               // k16 steps of q·kᵀ and dO·vᵀ
constexpr int kDTiles = kD / 8;                // n8 tiles of dQ
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kNotCausal = 1 << 30;            // causal_offset of a call without the causal mask

using TileD = alg::mma::Tile<kD>;
constexpr int kQBytes = TileD::bytes(kBlockQ);
constexpr int kKVBytes = TileD::bytes(kBlockK);
constexpr int kSmemBytes = 2 * kQBytes + 4 * kKVBytes;  // q, dO, then two stages of (K, V)

static_assert(kD == 64 || kD == 80 || kD == 128, "head dims the port's models use");
static_assert(kDTiles % 2 == 0 && kBlockK % 16 == 0, "ldmatrix.x4 reads two n8 tiles at a time");
static_assert(kSmemBytes <= 227 * 1024, "shared memory of one block");

__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                       const bf16* __restrict__ dout, const float* __restrict__ lse,
                       const float* __restrict__ delta, const int* __restrict__ kv_len, bf16* __restrict__ dq,
                       int heads, int sq, int sk, int causal_offset, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s_q = smem_addr(smem), s_do = s_q + kQBytes, s_kv = s_do + kQBytes;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.y;
  const int b = bh / heads;
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
  const bf16* kp = k + (long long)bh * sk * kD;
  const bf16* vp = v + (long long)bh * sk * kD;
  const float scale_log2 = scale * kLog2e;

  TileD::stage<kBlockQ, kThreads>(s_q, q + (long long)bh * sq * kD, q0, sq);
  TileD::stage<kBlockQ, kThreads>(s_do, dout + (long long)bh * sq * kD, q0, sq);
  cp_async_commit();
  if (n_tiles > 0) {
    TileD::stage<kBlockK, kThreads>(s_kv, kp, 0, block_keys);
    TileD::stage<kBlockK, kThreads>(s_kv + kKVBytes, vp, 0, block_keys);
  }
  cp_async_commit();
  cp_async_wait<1>();  // q and dO have landed
  __syncthreads();

  uint32_t qf[kRowTiles][kKSteps][4], dof[kRowTiles][kKSteps][4];
#pragma unroll
  for (int mt = 0; mt < kRowTiles; ++mt)
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      ldmatrix_x4(qf[mt][kk], a_order<kD>(s_q, warp * kWarpRows + 16 * mt, 2 * kk, lane));
      ldmatrix_x4(dof[mt][kk], a_order<kD>(s_do, warp * kWarpRows + 16 * mt, 2 * kk, lane));
    }

  // this lane's rows: row_of(mt, half) = first + 16 mt + 8 half
  const int first = q0 + warp * kWarpRows + lane / 4;
  int row_keys[kRowTiles][2];
  float row_lse[kRowTiles][2], row_delta[kRowTiles][2];
#pragma unroll
  for (int mt = 0; mt < kRowTiles; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = first + 16 * mt + 8 * hf;
      row_keys[mt][hf] = keys_of(row);
      const float l = row < sq ? lse[(long long)bh * sq + row] : -INFINITY;
      row_lse[mt][hf] = l == -INFINITY ? INFINITY : l;  // no visible key, or past Sq: p = exp2(-inf) = 0
      row_delta[mt][hf] = row < sq ? delta[(long long)bh * sq + row] : 0.0f;
    }

  float acc[kRowTiles][kDTiles][4];
#pragma unroll
  for (int mt = 0; mt < kRowTiles; ++mt)
#pragma unroll
    for (int dt = 0; dt < kDTiles; ++dt) acc[mt][dt][0] = acc[mt][dt][1] = acc[mt][dt][2] = acc[mt][dt][3] = 0.0f;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlockK;
    if (t + 1 < n_tiles) {  // the next tile's copy overlaps this tile's math
      const uint32_t next = s_kv + ((t + 1) & 1) * 2 * kKVBytes;
      TileD::stage<kBlockK, kThreads>(next, kp, k0 + kBlockK, block_keys);
      TileD::stage<kBlockK, kThreads>(next + kKVBytes, vp, k0 + kBlockK, block_keys);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile has landed
    __syncthreads();
    const uint32_t s_k = s_kv + (t & 1) * 2 * kKVBytes, s_v = s_k + kKVBytes;
    const bool masked = k0 + kBlockK > whole_keys;

    // 16 keys at a time: keys k0 + 16 j + [0, 16), n8 tiles 0 and 1 of the accumulators below
#pragma unroll
    for (int j = 0; j < kBlockK / 16; ++j) {
      float s[kRowTiles][2][4], dp[kRowTiles][2][4];
#pragma unroll
      for (int mt = 0; mt < kRowTiles; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[mt][nt][e] = dp[mt][nt][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
        uint32_t bk[4], bv[4];
        ldmatrix_x4(bk, b_order<kD>(s_k, 16 * j, 2 * kk, lane));
        ldmatrix_x4(bv, b_order<kD>(s_v, 16 * j, 2 * kk, lane));
#pragma unroll
        for (int mt = 0; mt < kRowTiles; ++mt) {
          mma_bf16(s[mt][0], qf[mt][kk], bk[0], bk[1]);
          mma_bf16(s[mt][1], qf[mt][kk], bk[2], bk[3]);
          mma_bf16(dp[mt][0], dof[mt][kk], bv[0], bv[1]);
          mma_bf16(dp[mt][1], dof[mt][kk], bv[2], bv[3]);
        }
      }

      // P and dS on the fragments; a lane's columns are keys k0 + 16 j + 8 nt + 2 (lane % 4) + {0, 1}
#pragma unroll
      for (int mt = 0; mt < kRowTiles; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int hf = e >> 1, key = k0 + 16 * j + 8 * nt + 2 * (lane % 4) + (e & 1);
            const bool visible = !masked || key < row_keys[mt][hf];
            const float p = visible ? exp2f(s[mt][nt][e] * scale_log2 - row_lse[mt][hf]) : 0.0f;
            s[mt][nt][e] = p * (dp[mt][nt][e] - row_delta[mt][hf]);  // ds
          }

      // dQ += dS·K: the accumulators of key tiles 0 and 1, as bf16 pairs, are the A fragment of this k16 step
#pragma unroll
      for (int mt = 0; mt < kRowTiles; ++mt) {
        const uint32_t da[4] = {pack_bf16(s[mt][0][0], s[mt][0][1]), pack_bf16(s[mt][0][2], s[mt][0][3]),
                                pack_bf16(s[mt][1][0], s[mt][1][1]), pack_bf16(s[mt][1][2], s[mt][1][3])};
#pragma unroll
        for (int dp2 = 0; dp2 < kDTiles / 2; ++dp2) {
          uint32_t bk[4];
          ldmatrix_x4_trans(bk, a_order<kD>(s_k, 16 * j, 2 * dp2, lane));
          mma_bf16(acc[mt][2 * dp2], da, bk[0], bk[1]);
          mma_bf16(acc[mt][2 * dp2 + 1], da, bk[2], bk[3]);
        }
      }
    }
    __syncthreads();  // this stage is read; the next iteration's copy may overwrite it
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mt = 0; mt < kRowTiles; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = first + 16 * mt + 8 * hf;
      if (row >= sq) continue;
      bf16* orow = dq + ((long long)bh * sq + row) * kD + 2 * (lane % 4);
#pragma unroll
      for (int dt = 0; dt < kDTiles; ++dt)
        alg::store2(orow + 8 * dt, acc[mt][dt][2 * hf] * scale, acc[mt][dt][2 * hf + 1] * scale);
    }
}

cudaError_t launch(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                   const void* delta, const void* kv_len, void* dq, int batch, int heads, int sq, int sk,
                   int causal_offset, float scale, cudaStream_t stream) {
  // above 48 KB a block's dynamic shared memory needs this attribute, once per device
  static unsigned long long configured = 0;  // a bit per device
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 64 && !((configured >> device) & 1ull)) {
    err = cudaFuncSetAttribute(flash_bwd_dq_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return err;
    configured |= 1ull << device;
  }
  const dim3 grid((sq + kBlockQ - 1) / kBlockQ, batch * heads);
  flash_bwd_dq_tc_kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(kv_len), static_cast<bf16*>(dq), heads, sq, sk, causal_offset, scale);
  return cudaGetLastError();
}

}  // namespace

// alg_flash_attention_bwd_dq_tc_d<D>: the arguments of
// alg_flash_attention_bwd_dq_d<D> (flash_attention_bwd.cu). q/dout/dq:
// [B, H, Sq, D], k/v: [B, H, Sk, D], contiguous bf16 (dtype must be
// alg::kBFloat16; anything else returns cudaErrorInvalidValue); lse/delta:
// fp32 [B, H, Sq] (lse in base 2 of the scaled logits, -inf on a row with no
// visible key); kv_len: null, or int32 [B] on the device; causal != 0 hides
// from query i the keys past i + (Sk - Sq). `scale` is the softmax scale of
// the forward. Returns the launch's cudaError_t.
extern "C" int ALG_CAT(alg_flash_attention_bwd_dq_tc_d, ALG_FLASH_HEAD_DIM)(
    int dtype, const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, const void* kv_len, void* dq, int batch, int heads, int sq, int sk, float scale,
    int causal, void* stream) {
  if (dtype != alg::kBFloat16 || batch <= 0 || heads <= 0 || sq <= 0 || sk <= 0 ||
      (long long)batch * heads > 65535)
    return (int)cudaErrorInvalidValue;
  const int causal_offset = causal != 0 ? sk - sq : kNotCausal;
  return (int)launch(q, k, v, dout, lse, delta, kv_len, dq, batch, heads, sq, sk, causal_offset, scale,
                     static_cast<cudaStream_t>(stream));
}
