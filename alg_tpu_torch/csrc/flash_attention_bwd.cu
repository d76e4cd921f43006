// Flash-attention backward over [B, H, S, D]: two kernels, dQ and dK/dV, for
// one head dim D fixed at compile time. The build reads the next line and
// makes one object per value, each with its own C entry points.
//
// build-variants: ALG_FLASH_HEAD_DIM=64,80,128
//
// Replaces the TPU kernels alg_tpu/ops/flash_attention_bwd.py:_dq_kernel and
// :_dkv_kernel (dense, causal, kv_len, Sq != Sk) for fp32 inputs, where the
// products need full precision (bf16 dq and dkv run on the tensor cores,
// flash_attention_bwd_dq_tc.cu and flash_attention_bwd_tc.cu).
// Given q, k, v, the output cotangent dO, the forward's base-2 row
// log-sum-exp `lse` and delta_i = rowsum(dO_i ⊙ O_i), both fp32 [B, H, Sq]:
//
//   s_ij  = (q_i·k_j)·scale·log2e, masked like the forward: key j is visible
//           to query i of batch b iff j < min(Sk, kv_len[b]) and, when causal,
//           j <= i + (Sk - Sq)
//   p_ij  = exp2(s_ij - lse_i)            (0 where masked)
//   dp_ij = dO_i·v_j
//   ds_ij = p_ij·(dp_ij - delta_i)
//   dQ_i  = scale·Σ_j ds_ij·k_j           (dq kernel; the TPU kernel rounds
//                                          ds to the input dtype first, an
//                                          identity in fp32)
//   dV_j  = Σ_i p_ij·dO_i                 (dkv kernel)
//   dK_j  = scale·Σ_i ds_ij·q_i           (dkv kernel)
//
// Design. 128 threads a block, fp32 FMAs on the CUDA cores, both kernels
// register-tiled (flash_simt.cuh has the layout). The TPU grid's sequential
// axis becomes a loop inside the block, so every output row has exactly one
// owner: no atomics, and the sums run in one fixed order.
//
//  * dq: one block per (b·h, tile of 16·TM query rows); TM = 8 (128 rows) at
//    D = 64, 4 (64 rows) at D = 80 and 128, where 128 rows would need more
//    registers than a thread has; where that grid would leave SMs idle, 2 or
//    1 (flash_simt.cuh's rows_per_group, the forward's rule). Q, dO, lse and
//    delta of the tile are copied once by cp.async into dynamic shared
//    memory; the block walks the keys in tiles (block_k: 32 keys at D = 64
//    and 128, 64 at D = 80, so that two blocks fit an SM), K and V copied in
//    turn into a K and a V buffer, each copy one K or V tile ahead of its
//    use. For each key tile: dP = dO·Vᵀ and S = Q·Kᵀ as the same micro-tile
//    a thread (TM rows × block_k / 8 keys), so that P = exp2(S·scale·log2e -
//    lse) and dS = P ⊙ (dP - delta) are formed in registers; dS goes to
//    shared memory, read back by the same warp, and dQ += dS·K runs as the
//    second register-blocked product (K in V's place in the forward's P·V),
//    each thread owning its rows × every 8th group of head-dim columns. dQ is
//    scaled by `scale` once, at the store. At D = 64 the S and dP tiles are
//    8 × 4 (2.7 FMAs per float read from shared memory) and dS·K 8 × 8 (4).
//  * dkv: one block per (b·h, tile of 64 keys; two blocks an SM at D = 64
//    and 80, one at 128); K and V staged once; a loop over tiles of 32
//    queries, Q, dO, lse and delta copied by cp.async into a two-stage ring
//    in dynamic shared memory, the next tile's copy in flight while this one
//    is computed. For each query tile, Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ as the same
//    micro-tile a thread (4 keys × 4 queries), so that P and dS = P ⊙ (dP -
//    delta) are formed in registers; they go to shared memory (read back by
//    the same warp), and dV += Pᵀ·dO, dK += dSᵀ·Q run as register-blocked
//    products, each thread owning its keys × every 8th group of head-dim
//    columns of both accumulators. dK is scaled by `scale` once, at the end.
//
// Masks and ragged edges. The dq block's key loop ends at the limit of its
// last row, and causal dq blocks run longest first; the dkv block's query
// loop starts at the first row that sees its first key, so a causal call
// skips what no row of the block can reach. Both apply the mask only on
// tiles that some pair of the block does not see.
// Staged rows past the end are zero-filled (cp.async with a source size of
// 0), and a query past Sq or with lse = -inf (no visible key) takes +1e30 for
// its lse, so p is exactly 0: such a row gets dQ = 0 and adds nothing to dK
// or dV. Keys at or past kv_len get dK = dV = 0. P stays in fp32 for the
// second products, as in the forward kernel. No host-side padding, no host
// read of kv_len.
//
// Bound on the H100: fp32 FLOPs outside the tensor cores (dq three products,
// 6·H·D per visible (query, key) pair; dkv four, 8·H·D) at 67 TFLOP/s.
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "flash_simt.cuh"

#ifndef ALG_FLASH_HEAD_DIM
#error "compile with -DALG_FLASH_HEAD_DIM=64, 80 or 128 (the build-variants line above)"
#endif

#define ALG_CAT_(a, b) a##b
#define ALG_CAT(a, b) ALG_CAT_(a, b)

namespace {

constexpr int kD = ALG_FLASH_HEAD_DIM;        // head dim
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kNotCausal = 1 << 30;           // causal_offset of a call without the causal mask
constexpr float kNoRowLse = 1e30f;            // lse of a row that contributes nothing: exp2(s - 1e30) = 0

static_assert(kD == 64 || kD == 80 || kD == 128, "head dims the port's models use");

// ---------------------------------------------------------------------------
// dQ: register-tiled on the CUDA cores (flash_simt.cuh has the layout)
// ---------------------------------------------------------------------------

namespace grad_q {

using namespace alg::simt;

constexpr int kTMLarge = kD == 64 ? 8 : 4;    // rows of a row group when the grid fills the card
constexpr int kDC = kD / kRowLanes;           // head-dim values of a thread's dQ rows
constexpr int S = stride(kD);

// Keys a shared-memory tile for TM rows a row group: in the largest blocks 32 at D = 64 and 128 and 64 at
// D = 80, so that two blocks fit an SM; in the small blocks 64, and 32 at D = 128.
__host__ __device__ constexpr int block_k(int tm) {
  return tm > 2 ? (kD == 80 ? 64 : 32) : (kD == 128 ? 32 : 64);
}

// Dynamic shared memory of a block with TM rows a row group: Q, dO, a K and a V tile, dS, lse, delta.
constexpr int smem_floats(int tm) {
  return 2 * kGroups * tm * S + 2 * block_k(tm) * S + kGroups * tm * p_stride(block_k(tm)) + 2 * kGroups * tm;
}

template <int TM>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                    const float* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, const int* __restrict__ kv_len, float* __restrict__ dq,
                    int heads, int sq, int sk, int causal_offset, float scale) {
  constexpr int kBlockQ = kGroups * TM, kBlockK = block_k(TM);
  constexpr int kTN = kBlockK / kRowLanes;  // keys of a thread's S and dP micro-tiles
  constexpr int PS = p_stride(kBlockK);
  static_assert(kBlockK % kRowLanes == 0 && kBlockK % 4 == 0, "key tile");
  extern __shared__ float4 smem4[];
  float* const qs = reinterpret_cast<float*>(smem4);  // [kBlockQ][S]
  float* const dos = qs + kBlockQ * S;                 // [kBlockQ][S]
  float* const ks = dos + kBlockQ * S;                 // [kBlockK][S]
  float* const vs = ks + kBlockK * S;                  // [kBlockK][S]
  float* const dss = vs + kBlockK * S;                 // [kBlockQ][PS]
  float* const lses = dss + kBlockQ * PS;              // [kBlockQ]
  float* const deltas = lses + kBlockQ;                // [kBlockQ]

  const int tx = threadIdx.x % kRowLanes, ty = threadIdx.x / kRowLanes;
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
  const long long row0 = (long long)bh * sq;  // the head's first query row
  const float* kp = k + (long long)bh * sk * kD;
  const float* vp = v + (long long)bh * sk * kD;
  const float scale_log2 = scale * kLog2e;

  // V and K are copied in turn, each one K or V tile ahead of its use: V of tile t + 1 during Q·Kᵀ and dS·K
  // of tile t, K of tile t + 1 during dO·Vᵀ of tile t + 1 (one commit group a copy, empty past the last tile)
  auto copy = [&](float* dst, const float* src, int t) {
    if (t < n_tiles) stage<kBlockK, kD>(dst, src, t * kBlockK, block_keys);
    alg::mma::cp_async_commit();
  };
  if (n_tiles > 0) {  // Q, dO, lse and delta land with V of tile 0
    stage<kBlockQ, kD>(qs, q + row0 * kD, q0, sq);
    stage<kBlockQ, kD>(dos, dout + row0 * kD, q0, sq);
    stage_vector<kBlockQ>(lses, lse + row0, q0, sq);
    stage_vector<kBlockQ>(deltas, delta + row0, q0, sq);
  }
  copy(vs, vp, 0);
  copy(ks, kp, 0);

  // this thread's rows: ty + 16 i; its keys in a tile: tx + 8 j
  int row_keys[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) row_keys[i] = keys_of(q0 + ty + kGroups * i);

  float acc[TM][kDC];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int e = 0; e < kDC; ++e) acc[i][e] = 0.0f;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlockK;
    alg::mma::cp_async_wait<1>();  // this tile's V (and Q, dO, lse, delta) has landed
    __syncthreads();                // for every warp

    float dp[TM][kTN], s[TM][kTN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) dp[i][j] = s[i][j] = 0.0f;
    dot_tile<TM, kTN, kD>(dp, dos + ty * S, vs + tx * S);
    alg::mma::cp_async_wait<0>();  // this tile's K has landed
    __syncthreads();                // and every warp is done with this tile's V
    copy(vs, vp, t + 1);
    dot_tile<TM, kTN, kD>(s, qs + ty * S, ks + tx * S);

    // P and dS on the thread's micro-tile; the mask only where some pair of the block is hidden
    const bool masked = k0 + kBlockK > whole_keys;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = ty + kGroups * i;
      // a row past Sq or without a visible key (lse -inf) takes lse 1e30: p = 0, so its dQ is 0
      float l = lses[r];
      if (q0 + r >= sq || l == -INFINITY) l = kNoRowLse;
      const float dl = deltas[r];
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int key = k0 + tx + kRowLanes * j;
        const float p = masked && key >= row_keys[i] ? 0.0f : exp2f(s[i][j] * scale_log2 - l);
        dss[r * PS + tx + kRowLanes * j] = p * (dp[i][j] - dl);
      }
    }
    __syncwarp();  // a row's dS is written and read by the 8 lanes of its row group, all in one warp
    pv_tile<TM, kBlockK, kD>(acc, dss + ty * PS, ks + tx * Cols<kD>::kVec);  // dQ += dS·K
    __syncthreads();  // every warp is done with this tile's K
    copy(ks, kp, t + 1);
  }
  alg::mma::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = q0 + ty + kGroups * i;
    if (row >= sq) continue;
    float* orow = dq + (row0 + row) * kD;
#pragma unroll
    for (int c = 0; c < Cols<kD>::kGroupsPerLane; ++c) {
      constexpr int V = Cols<kD>::kVec;
      const float* x = acc[i] + V * c;
      if constexpr (V == 4) {
        alg::store4(orow + column<kD>(tx, V * c), x[0] * scale, x[1] * scale, x[2] * scale, x[3] * scale);
      } else {
        alg::store2(orow + column<kD>(tx, V * c), x[0] * scale, x[1] * scale);
      }
    }
  }
}

template <int TM>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                   const void* delta, const void* kv_len, void* dq, int batch, int heads, int sq, int sk,
                   int causal_offset, float scale, cudaStream_t stream) {
  auto kernel = flash_bwd_dq_kernel<TM>;
  constexpr int kBytes = smem_floats(TM) * (int)sizeof(float);
  static_assert(kBytes <= 227 * 1024, "shared memory of one block");
  // above 48 KB a block's dynamic shared memory needs this attribute, once per device and instantiation
  static unsigned long long configured = 0;  // a bit per device
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 64 && !((configured >> device) & 1ull)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
    if (err != cudaSuccess) return err;
    configured |= 1ull << device;
  }
  const dim3 grid((sq + kGroups * TM - 1) / (kGroups * TM), batch * heads);
  kernel<<<grid, kThreads, kBytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(kv_len), static_cast<float*>(dq), heads, sq, sk, causal_offset, scale);
  return cudaGetLastError();
}

// 16·kTMLarge rows a block, unless that leaves SMs idle: then 32, or 16 (flash_simt.cuh)
cudaError_t dispatch(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                     const void* delta, const void* kv_len, void* dq, int batch, int heads, int sq, int sk,
                     int causal_offset, float scale, cudaStream_t stream) {
  int tm = 0;
  const cudaError_t err = rows_per_group(sq, (long long)batch * heads, kTMLarge, &tm);
  if (err != cudaSuccess) return err;
  auto* run = tm == kTMLarge ? &launch<kTMLarge> : tm == 2 ? &launch<2> : &launch<1>;
  return run(q, k, v, dout, lse, delta, kv_len, dq, batch, heads, sq, sk, causal_offset, scale, stream);
}

}  // namespace grad_q

// ---------------------------------------------------------------------------
// dK, dV: register-tiled on the CUDA cores (flash_simt.cuh has the layout)
// ---------------------------------------------------------------------------

namespace dkv {

using namespace alg::simt;

constexpr int kTK = 4;                            // keys of a thread (rows ty + 16 i of the block's keys)
constexpr int kBlockKV = kGroups * kTK;           // keys a block
constexpr int kBlockQ = 32;                       // queries a shared-memory tile
constexpr int kTQ = kBlockQ / kRowLanes;          // queries of a thread's micro-tile (tx + 8 j)
constexpr int kDC = kD / kRowLanes;               // head-dim values of a thread's dK and dV rows
constexpr int S = stride(kD), PS = p_stride(kBlockQ);
// K, V; two stages of (Q, dO, lse, delta); P and dS
constexpr int kSmemFloats = 2 * kBlockKV * S + 2 * (2 * kBlockQ * S + 2 * kBlockQ) + 2 * kBlockKV * PS;
constexpr int kSmemBytes = kSmemFloats * (int)sizeof(float);
static_assert(kSmemBytes <= 227 * 1024, "shared memory of one block");

__global__ void __launch_bounds__(alg::simt::kThreads, 2)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                     const float* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, const int* __restrict__ kv_len, float* __restrict__ dk,
                     float* __restrict__ dv, int sq, int sk, int heads, int causal_offset, float scale) {
  extern __shared__ float4 smem4[];
  float* const ks = reinterpret_cast<float*>(smem4);   // [kBlockKV][S]
  float* const vs = ks + kBlockKV * S;                  // [kBlockKV][S]
  float* const stages = vs + kBlockKV * S;              // 2 × (Q [kBlockQ][S], dO [kBlockQ][S], lse, delta)
  constexpr int kStageFloats = 2 * kBlockQ * S + 2 * kBlockQ;
  float* const ps = stages + 2 * kStageFloats;          // Pᵀ [kBlockKV][PS]
  float* const dss = ps + kBlockKV * PS;                // dSᵀ [kBlockKV][PS]

  const int tx = threadIdx.x % kRowLanes, ty = threadIdx.x / kRowLanes;
  const int bh = blockIdx.y;
  const int b = bh / heads;
  const bool causal = causal_offset != kNotCausal;
  const int key0 = blockIdx.x * kBlockKV;  // the first blocks see the most queries: longest blocks first as it is
  const int n_keys = kv_len == nullptr ? sk : max(0, min(sk, kv_len[b]));
  const float* qp = q + (long long)bh * sq * kD;
  const float* dop = dout + (long long)bh * sq * kD;
  const float* lsep = lse + (long long)bh * sq;
  const float* deltap = delta + (long long)bh * sq;
  const float scale_log2 = scale * kLog2e;

  // queries below the first one that sees the block's first key see none of its keys; a block whose first
  // key is past kv_len has nothing to do
  int q_begin = key0 < n_keys ? 0 : sq;
  if (causal && q_begin == 0) q_begin = min(sq, max(0, key0 - causal_offset));
  const int n_tiles = (sq - q_begin + kBlockQ - 1) / kBlockQ;

  auto stage_queries = [&](int t) {
    float* st = stages + (t & 1) * kStageFloats;
    const int q0 = q_begin + t * kBlockQ;
    stage<kBlockQ, kD>(st, qp, q0, sq);
    stage<kBlockQ, kD>(st + kBlockQ * S, dop, q0, sq);
    stage_vector<kBlockQ>(st + 2 * kBlockQ * S, lsep, q0, sq);
    stage_vector<kBlockQ>(st + 2 * kBlockQ * S + kBlockQ, deltap, q0, sq);
  };
  if (n_tiles > 0) {
    stage<kBlockKV, kD>(ks, k + (long long)bh * sk * kD, key0, n_keys);
    stage<kBlockKV, kD>(vs, v + (long long)bh * sk * kD, key0, n_keys);
    stage_queries(0);
  }
  alg::mma::cp_async_commit();

  float dkr[kTK][kDC], dvr[kTK][kDC];
#pragma unroll
  for (int i = 0; i < kTK; ++i)
#pragma unroll
    for (int e = 0; e < kDC; ++e) dkr[i][e] = dvr[i][e] = 0.0f;

  for (int t = 0; t < n_tiles; ++t) {
    const int q0 = q_begin + t * kBlockQ;
    if (t + 1 < n_tiles) stage_queries(t + 1);  // the next tile's copy overlaps this tile's math
    alg::mma::cp_async_commit();
    alg::mma::cp_async_wait<1>();  // K, V and this tile have landed
    __syncthreads();
    const float* qs = stages + (t & 1) * kStageFloats;
    const float* dos = qs + kBlockQ * S;
    const float* lses = dos + kBlockQ * S;
    const float* deltas = lses + kBlockQ;

    // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ, the same micro-tile a thread: P and dS are formed in registers
    float s[kTK][kTQ], dp[kTK][kTQ];
#pragma unroll
    for (int i = 0; i < kTK; ++i)
#pragma unroll
      for (int j = 0; j < kTQ; ++j) s[i][j] = dp[i][j] = 0.0f;
    dot_tile<kTK, kTQ, kD>(s, ks + ty * S, qs + tx * S);
    dot_tile<kTK, kTQ, kD>(dp, vs + ty * S, dos + tx * S);

    // a tile some pair of which is hidden: keys past kv_len (and past Sk), or the causal mask
    const bool masked = key0 + kBlockKV > n_keys || (causal && key0 + kBlockKV - 1 > q0 + causal_offset);
#pragma unroll
    for (int j = 0; j < kTQ; ++j) {
      const int qi = q0 + tx + kRowLanes * j;
      // a query past Sq or without a visible key (lse -inf) takes lse 1e30: p = 0, so it adds nothing
      float l = lses[tx + kRowLanes * j];
      if (qi >= sq || l == -INFINITY) l = kNoRowLse;
      const float dl = deltas[tx + kRowLanes * j];
#pragma unroll
      for (int i = 0; i < kTK; ++i) {
        const int key = key0 + ty + kGroups * i;
        const bool visible = !masked || (key < n_keys && key <= qi + causal_offset);  // no offset: always true
        const float p = visible ? exp2f(s[i][j] * scale_log2 - l) : 0.0f;
        ps[(ty + kGroups * i) * PS + tx + kRowLanes * j] = p;
        dss[(ty + kGroups * i) * PS + tx + kRowLanes * j] = p * (dp[i][j] - dl);
      }
    }
    __syncwarp();  // a key's P and dS are written and read by the 8 lanes of its row group, all in one warp
    // dV += Pᵀ·dO and dK += dSᵀ·Q
    pv_tile<kTK, kBlockQ, kD>(dvr, ps + ty * PS, dos + tx * Cols<kD>::kVec);
    pv_tile<kTK, kBlockQ, kD>(dkr, dss + ty * PS, qs + tx * Cols<kD>::kVec);
    __syncthreads();  // this stage, P and dS are read; the next iteration's copy may overwrite the stage
  }
  alg::mma::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < kTK; ++i) {
    const int key = key0 + ty + kGroups * i;
    if (key >= sk) continue;
    const long long at = ((long long)bh * sk + key) * kD;
#pragma unroll
    for (int c = 0; c < Cols<kD>::kGroupsPerLane; ++c) {
      constexpr int V = Cols<kD>::kVec;
      const int col = column<kD>(tx, V * c);
      const float* a = dkr[i] + V * c;
      const float* w = dvr[i] + V * c;
      if constexpr (V == 4) {
        alg::store4(dk + at + col, a[0] * scale, a[1] * scale, a[2] * scale, a[3] * scale);
        alg::store4(dv + at + col, w[0], w[1], w[2], w[3]);
      } else {
        alg::store2(dk + at + col, a[0] * scale, a[1] * scale);
        alg::store2(dv + at + col, w[0], w[1]);
      }
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
    err = cudaFuncSetAttribute(flash_bwd_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return err;
    configured |= 1ull << device;
  }
  const dim3 grid((sk + kBlockKV - 1) / kBlockKV, batch * heads);
  flash_bwd_dkv_kernel<<<grid, alg::simt::kThreads, kSmemBytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(kv_len), static_cast<float*>(dk), static_cast<float*>(dv), sq, sk, heads,
      causal_offset, scale);
  return cudaGetLastError();
}

}  // namespace dkv

bool bad_shape(int batch, int heads, int sq, int sk) {
  return batch <= 0 || heads <= 0 || sq <= 0 || sk <= 0 || (long long)batch * heads > 65535;
}

}  // namespace

// alg_flash_attention_bwd_dq_d<D> and alg_flash_attention_bwd_dkv_d<D>.
// q/dout/dq: [B, H, Sq, D], k/v/dk/dv: [B, H, Sk, D], contiguous, of `dtype`;
// lse/delta: fp32 [B, H, Sq] (lse in base 2 of the scaled logits, -inf on a
// row with no visible key); kv_len: null, or int32 [B] on the device; causal
// != 0 hides from query i the keys past i + (Sk - Sq). `scale` is the
// softmax scale of the forward. Each returns its launch's cudaError_t. Both
// take fp32 only (bf16 returns cudaErrorInvalidValue: it goes to
// alg_flash_attention_bwd_dq_tc_d<D> in flash_attention_bwd_dq_tc.cu and
// alg_flash_attention_bwd_dkv_tc_d<D> in flash_attention_bwd_tc.cu).
extern "C" int ALG_CAT(alg_flash_attention_bwd_dq_d, ALG_FLASH_HEAD_DIM)(
    int dtype, const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, const void* kv_len, void* dq, int batch, int heads, int sq, int sk, float scale,
    int causal, void* stream) {
  if (bad_shape(batch, heads, sq, sk)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int causal_offset = causal != 0 ? sk - sq : kNotCausal;
  switch (dtype) {
    case alg::kFloat32:
      return (int)grad_q::dispatch(q, k, v, dout, lse, delta, kv_len, dq, batch, heads, sq, sk, causal_offset,
                                   scale, st);
    default:  // bf16 runs on the tensor cores: alg_flash_attention_bwd_dq_tc_d<D>
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int ALG_CAT(alg_flash_attention_bwd_dkv_d, ALG_FLASH_HEAD_DIM)(
    int dtype, const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, const void* kv_len, void* dk, void* dv, int batch, int heads, int sq, int sk,
    float scale, int causal, void* stream) {
  if (bad_shape(batch, heads, sq, sk)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int causal_offset = causal != 0 ? sk - sq : kNotCausal;
  switch (dtype) {
    case alg::kFloat32:
      return (int)dkv::launch(q, k, v, dout, lse, delta, kv_len, dk, dv, batch, heads, sq, sk, causal_offset,
                              scale, st);
    default:  // bf16 runs on the tensor cores: alg_flash_attention_bwd_dkv_tc_d<D>
      return (int)cudaErrorInvalidValue;
  }
}
